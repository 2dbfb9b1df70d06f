"""PlaNet (RSSM world model and CEM planner) of the PyTorch port
(`mj_envs_tpu/algos/planet.py`).

The capability the reference imports from the Kaixhin/PlaNet submodule
(`baselines.py:15-17,199-326`):

* RSSM: deterministic belief h_t = GRU(h_{t-1}, relu(fc([s_{t-1},
  a_{t-1}]))); prior s_t ~ N(f(h_t)); posterior conditioned on the
  encoded observation; std = softplus + min_std 0.1.
* A conv encoder (4 VALID convs of stride 2, 64x64x3 -> 2x2x256, then a
  linear layer to `embedding_size`), a transposed-conv decoder
  (1 -> 5 -> 13 -> 30 -> 64) and a reward MLP.
* Training (`Planet.update`, `baselines.py:268-302`): observation and
  reward MSE plus max(KL, free_nats); the gradients clipped to a global
  norm of 1000, then Adam with eps 1e-4.
* Acting (`Planet.act`, `:311-320`): encode, filter, then CEM over the
  learned prior (candidates 1000, top 100, 10 iterations, horizon 12);
  the first action of the mean is returned.

The weights are one `nn.Module` (`Planet`) whose layers carry the JAX
package's names; `planet_from_numpy` / `planet_to_numpy` carry its
parameter tree across and back.  Two layouts differ from torch's own:
the JAX package flattens the encoder's NHWC activations in HWC order,
and its `lax.conv_transpose(..., transpose_kernel=False)` does not flip
its kernel, where `conv_transpose2d` (the adjoint of a convolution)
does, so a decoder kernel crosses as HWIO -> (in, out, kH, kW) with
both spatial axes flipped.  The GRU is the JAX package's `_gru`: r
multiplies h before `wh`, h' = (1 - z) h + z h~ (not `nn.GRUCell`).

Randomness is explicit: every draw comes from a `torch.Generator`, or is
passed in (`noise=` / `eps=`) so that a test can feed the JAX package's
draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ppo import clip_by_global_norm_, require_device


class PlanetConfig(NamedTuple):
    belief_size: int = 200
    state_size: int = 30
    hidden_size: int = 200
    embedding_size: int = 1024
    action_size: int = 26
    min_std: float = 0.1
    free_nats: float = 3.0
    # planner (reference config.py:32-33,97-98)
    planning_horizon: int = 12
    optimisation_iters: int = 10
    candidates: int = 1000
    top_candidates: int = 100
    # training
    lr: float = 1e-3
    adam_eps: float = 1e-4
    grad_clip_norm: float = 1000.0


def cfg_from_config(config, action_size: int) -> PlanetConfig:
    """The algorithm's PlanetConfig from a run's `utils.config`
    PlanetConfig (shared by the trainer and the evaluator, so that a
    checkpoint restores with the shapes it was trained with)."""
    return PlanetConfig(
        belief_size=config.belief_size, state_size=config.state_size,
        hidden_size=config.hidden_size,
        embedding_size=config.embedding_size,
        action_size=action_size, free_nats=float(config.free_nats),
        planning_horizon=config.planning_horizon,
        optimisation_iters=config.optimisation_iters,
        candidates=config.candidates,
        top_candidates=config.top_candidates,
        lr=config.learning_rate, adam_eps=config.adam_epsilon,
        grad_clip_norm=float(config.grad_clip_norm))


_ENC = ((3, 32), (32, 64), (64, 128), (128, 256))     # 4x4 kernels
_DEC_OUT = ((128, 5), (64, 5), (32, 6), (3, 6))       # (out, kernel)
_LINEARS = ("fc_embed_sa", "fc_prior1", "fc_prior2", "fc_post1", "fc_post2",
            "enc_fc", "dec_fc", "rew1", "rew2", "rew3")


def _uniform_(t: torch.Tensor, scale: float, gen: torch.Generator):
    with torch.no_grad():
        u = torch.rand(t.shape, generator=gen, device=gen.device,
                       dtype=t.dtype)
        t.copy_((2.0 * u - 1.0) * scale)


class Planet(nn.Module):
    """The RSSM, encoder, decoder and reward model (`init_params`): every
    weight U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from `generator` (another
    stream than the JAX package's), every bias 0."""

    def __init__(self, cfg: PlanetConfig,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.cfg = cfg
        B, S, H, E, A = (cfg.belief_size, cfg.state_size, cfg.hidden_size,
                         cfg.embedding_size, cfg.action_size)
        kw = dict(device=device, dtype=dtype)
        sizes = {"fc_embed_sa": (S + A, B), "fc_prior1": (B, H),
                 "fc_prior2": (H, 2 * S), "fc_post1": (B + E, H),
                 "fc_post2": (H, 2 * S), "enc_fc": (1024, E),
                 "dec_fc": (B + S, E), "rew1": (B + S, H), "rew2": (H, H),
                 "rew3": (H, 1)}
        for name in _LINEARS:
            setattr(self, name, nn.Linear(*sizes[name], **kw))
        self.gru = nn.ModuleDict({k: nn.Linear(2 * B, B, **kw)
                                  for k in ("wz", "wr", "wh")})
        self.enc = nn.ModuleList(nn.Conv2d(ci, co, 4, 2, **kw)
                                 for ci, co in _ENC)
        dec, ci = [], E
        for co, k in _DEC_OUT:
            dec.append(nn.ConvTranspose2d(ci, co, k, 2, **kw))
            ci = co
        self.dec = nn.ModuleList(dec)
        for lyr in self.modules():
            if isinstance(lyr, nn.Linear):
                _uniform_(lyr.weight, math.sqrt(1.0 / lyr.in_features),
                          generator)
            elif isinstance(lyr, nn.ConvTranspose2d):
                ci, _, k, _ = lyr.weight.shape
                _uniform_(lyr.weight, math.sqrt(1.0 / (ci * k * k)),
                          generator)
            elif isinstance(lyr, nn.Conv2d):
                _, ci, k, _ = lyr.weight.shape
                _uniform_(lyr.weight, math.sqrt(1.0 / (ci * k * k)),
                          generator)
            else:
                continue
            nn.init.zeros_(lyr.bias)

    @property
    def dtype(self):
        return self.fc_prior1.weight.dtype

    # -- the model's parts (`planet.py:123-207`) -----------------------------

    def _gru(self, h, x):
        g = self.gru
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(g["wz"](hx))
        r = torch.sigmoid(g["wr"](hx))
        hh = torch.tanh(g["wh"](torch.cat([r * h, x], dim=-1)))
        return (1 - z) * h + z * hh

    def encoder(self, obs: torch.Tensor) -> torch.Tensor:
        """obs (..., 64, 64, 3) in [-0.5, 0.5] -> (..., embedding_size)."""
        lead = obs.shape[:-3]
        x = obs.reshape((-1,) + obs.shape[-3:]).to(self.dtype)
        x = x.permute(0, 3, 1, 2)
        for conv in self.enc:
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # HWC flatten
        x = self.enc_fc(x)
        return x.reshape(lead + (x.shape[-1],))

    def decoder(self, belief: torch.Tensor, state: torch.Tensor
                ) -> torch.Tensor:
        """(belief, state) -> (..., 64, 64, 3), the reconstruction mean."""
        hs = torch.cat([belief, state], dim=-1)
        lead = hs.shape[:-1]
        x = self.dec_fc(hs).reshape(-1, self.dec_fc.out_features, 1, 1)
        for i, conv in enumerate(self.dec):
            x = conv(x)
            if i < len(self.dec) - 1:
                x = torch.relu(x)
        x = x.permute(0, 2, 3, 1)
        return x.reshape(lead + x.shape[1:])

    def reward_model(self, belief, state):
        x = torch.cat([belief, state], dim=-1)
        x = torch.relu(self.rew1(x))
        x = torch.relu(self.rew2(x))
        return self.rew3(x)[..., 0]

    def _stats(self, x):
        mean, std_raw = torch.chunk(x, 2, dim=-1)
        return mean, F.softplus(std_raw) + self.cfg.min_std

    def transition_step(self, h, s, a):
        """One deterministic RSSM step and its prior: (h', (mean, std))."""
        x = torch.relu(self.fc_embed_sa(torch.cat([s, a], dim=-1)))
        h_new = self._gru(h, x)
        prior = self._stats(self.fc_prior2(torch.relu(self.fc_prior1(h_new))))
        return h_new, prior

    def posterior_stats(self, h, embed):
        return self._stats(self.fc_post2(torch.relu(
            self.fc_post1(torch.cat([h, embed], dim=-1)))))

    def rollout_posterior(self, h0, s0, actions, embeds, nonterminals,
                          noise=None, generator=None):
        """Filter a (T, batch, ...) sequence: (beliefs, posterior samples,
        prior mean, prior std, posterior mean, posterior std), each
        stacked over T.  `noise` (T, batch, state_size) standard normals,
        else drawn from `generator`."""
        h, s = h0, s0
        outs = []
        for t in range(actions.shape[0]):
            h, (pm, ps) = self.transition_step(
                h, s * nonterminals[t][:, None], actions[t])
            qm, qs = self.posterior_stats(h, embeds[t])
            eps = noise[t] if noise is not None else torch.randn(
                qm.shape, generator=generator, device=qm.device,
                dtype=qm.dtype)
            s = qm + qs * eps
            outs.append((h, s, pm, ps, qm, qs))
        return tuple(torch.stack(xs) for xs in zip(*outs))


@dataclasses.dataclass
class PlanetState:
    """What a PlaNet checkpoint holds: {"params", "opt_state"}."""
    params: Planet
    opt_state: torch.optim.Optimizer


def make_optimizer(module: Planet, cfg: PlanetConfig):
    return torch.optim.Adam(module.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=cfg.adam_eps)


def loss_fn(module: Planet, obs, actions, rewards, nonterminals,
            noise=None, generator=None):
    """(total loss, metrics).  obs (T, B, 64, 64, 3) in [-0.5, 0.5];
    actions (T, B, A), rewards and nonterminals (T, B).  As the
    reference, obs[1:] is held against the beliefs from actions[:-1]
    (`baselines.py:275-287`).  `noise` (T - 1, B, state_size) stands in
    for the posterior's draws."""
    cfg = module.cfg
    Bt = actions.shape[1]
    h0 = torch.zeros((Bt, cfg.belief_size), dtype=obs.dtype,
                     device=obs.device)
    s0 = torch.zeros((Bt, cfg.state_size), dtype=obs.dtype,
                     device=obs.device)
    embeds = module.encoder(obs[1:])
    h, s, pm, ps, qm, qs = module.rollout_posterior(
        h0, s0, actions[:-1], embeds, nonterminals[:-1], noise, generator)
    recon = module.decoder(h, s)
    obs_loss = ((recon - obs[1:]) ** 2).sum(dim=(-1, -2, -3)).mean()
    rew_loss = ((module.reward_model(h, s) - rewards[:-1]) ** 2).mean()
    kl = (torch.log(ps) - torch.log(qs)
          + (qs ** 2 + (qm - pm) ** 2) / (2 * ps ** 2) - 0.5).sum(-1)
    kl_loss = torch.clamp(kl, min=cfg.free_nats).mean()
    total = obs_loss + rew_loss + kl_loss
    return total, dict(obs_loss=obs_loss.detach(), rew_loss=rew_loss.detach(),
                       kl_loss=kl_loss.detach())


def make_planet(cfg: PlanetConfig, device="cuda", dtype=torch.float32):
    """(init_fn, update_fn, infer_step, plan) on `device` (the card unless
    the caller asks for the CPU), as the JAX package's `make_planet`:

    * init_fn(seed) -> PlanetState;
    * update_fn(state, batch, generator=None, noise=None) -> metrics: one
      gradient step on a (T, B) batch of arrays or tensors, in place;
    * infer_step(module, h, s, action, obs, generator=None, noise=None)
      -> (h, s): advance the belief with the last action and condition
      on the new observation;
    * plan(module, h, s, generator=None, eps=None) -> (B, A): CEM over
      the prior; `eps` (iters, candidates, horizon, B, A) stands in for
      its normals."""
    dev = require_device(device)

    def init_fn(seed: int) -> PlanetState:
        gen = torch.Generator(device=dev).manual_seed(seed)
        module = Planet(cfg, gen, device=dev, dtype=dtype)
        return PlanetState(module, make_optimizer(module, cfg))

    def update_fn(state: PlanetState, batch, generator=None, noise=None):
        module = state.params
        b = {k: torch.as_tensor(v).to(dev, module.dtype)
             for k, v in batch.items()}
        state.opt_state.zero_grad(set_to_none=False)
        loss, metrics = loss_fn(module, b["obs"], b["actions"],
                                b["rewards"], b["nonterminals"], noise,
                                generator)
        loss.backward()
        with torch.no_grad():
            clip_by_global_norm_(list(module.parameters()),
                                 cfg.grad_clip_norm)
        state.opt_state.step()
        return metrics

    @torch.no_grad()
    def infer_step(module: Planet, h, s, action, obs, generator=None,
                   noise=None):
        h, _ = module.transition_step(h, s, action)
        qm, qs = module.posterior_stats(h, module.encoder(obs))
        if noise is None:
            noise = torch.randn(qm.shape, generator=generator,
                                device=qm.device, dtype=qm.dtype)
        return h, qm + qs * noise

    @torch.no_grad()
    def plan(module: Planet, h, s, generator=None, eps=None):
        A, Hz = cfg.action_size, cfg.planning_horizon
        Bt = h.shape[0]
        mean = torch.zeros((Hz, Bt, A), dtype=h.dtype, device=h.device)
        std = torch.ones_like(mean)
        for it in range(cfg.optimisation_iters):
            e = eps[it] if eps is not None else torch.randn(
                (cfg.candidates, Hz, Bt, A), generator=generator,
                device=h.device, dtype=h.dtype)
            mean, std, _ = cem_step(module, h, s, mean, std, e)
        return mean[0]

    return init_fn, update_fn, infer_step, plan


@torch.no_grad()
def cem_step(module: Planet, h, s, mean, std, eps):
    """One CEM iteration (`plan`'s `cem_iter`): candidates clip(mean + std
    eps) of shape (candidates, horizon, B, A), each rolled out over the
    prior means from (h, s) and scored by its summed predicted reward;
    the top_candidates of each env refit the mean and the population
    std + 1e-6.  Returns (mean, std, top indices (B, top_candidates))."""
    cfg = module.cfg
    C, Hz, Bt, A = eps.shape
    acts = torch.clamp(mean[None] + std[None] * eps, -1.0, 1.0)
    hh, ss = h.repeat(C, 1), s.repeat(C, 1)        # (C * B, ...)
    returns = torch.zeros(C * Bt, dtype=h.dtype, device=h.device)
    for t in range(Hz):
        hh, (ss, _) = module.transition_step(hh, ss,
                                             acts[:, t].reshape(C * Bt, A))
        returns = returns + module.reward_model(hh, ss)
    top = torch.topk(returns.reshape(C, Bt).T, cfg.top_candidates,
                     dim=1).indices                  # (B, k)
    best = acts.permute(2, 0, 1, 3)[
        torch.arange(Bt, device=h.device)[:, None], top]   # (B, k, Hz, A)
    return (best.mean(1).permute(1, 0, 2),
            best.std(1, correction=0).permute(1, 0, 2) + 1e-6, top)


# -- the JAX package's parameter tree ---------------------------------------

def _lin_np(lyr: nn.Linear) -> Dict:
    return {"w": lyr.weight.detach().cpu().numpy().T.copy(),
            "b": lyr.bias.detach().cpu().numpy().copy()}


def planet_to_numpy(module: Planet) -> Dict:
    """The JAX package's tree (`init_params`): linear weights (in, out),
    encoder kernels HWIO, decoder kernels HWIO unflipped."""
    tree = {name: _lin_np(getattr(module, name)) for name in _LINEARS}
    tree["gru"] = {k: _lin_np(v) for k, v in module.gru.items()}
    tree["enc"] = [{"w": c.weight.detach().cpu().permute(2, 3, 1, 0)
                    .numpy().copy(), "b": c.bias.detach().cpu().numpy().copy()}
                   for c in module.enc]
    tree["dec"] = [{"w": c.weight.detach().cpu().flip(2, 3)
                    .permute(2, 3, 0, 1).numpy().copy(),
                    "b": c.bias.detach().cpu().numpy().copy()}
                   for c in module.dec]
    return tree


def planet_from_numpy(tree: Dict, cfg: PlanetConfig, device="cuda",
                      dtype=torch.float32) -> Planet:
    """A Planet holding `tree`, the JAX package's parameter tree of
    arrays (as `init_params` returns, or `planet_to_numpy`)."""
    module = Planet(cfg, device=device, dtype=dtype)

    def put(t: torch.Tensor, a):
        t.copy_(torch.as_tensor(np.array(a)))

    with torch.no_grad():
        for name in _LINEARS:
            lyr = getattr(module, name)
            put(lyr.weight, np.asarray(tree[name]["w"]).T)
            put(lyr.bias, tree[name]["b"])
        for k, lyr in module.gru.items():
            put(lyr.weight, np.asarray(tree["gru"][k]["w"]).T)
            put(lyr.bias, tree["gru"][k]["b"])
        for c, p in zip(module.enc, tree["enc"]):
            put(c.weight, np.asarray(p["w"]).transpose(3, 2, 0, 1))
            put(c.bias, p["b"])
        for c, p in zip(module.dec, tree["dec"]):
            put(c.weight, np.asarray(p["w"]).transpose(2, 3, 0, 1)
                [:, :, ::-1, ::-1])
            put(c.bias, p["b"])
    return module
