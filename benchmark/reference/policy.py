"""Plain PPO arithmetic of the reference: the actor-critic's forward pass,
the Gaussian's log-density, GAE, the clipped-surrogate loss, the global
norm clip and Adam, written out in torch on a dict of tensors keyed by
the port's parameter names (`actor.<i>.weight` (out, in), `.bias`,
`critic.<i>...`, `log_std`).

The semantics are those of the reference PPO the port follows
(SB3-style actor-critic with separate tanh trunks and a state-independent
log_std; advantages normalized per minibatch with the population std;
optax's `clip_by_global_norm`, which scales only when the norm reaches
the limit; Adam with b1 0.9, b2 0.999, eps 1e-8).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LOG_2PI = math.log(2.0 * math.pi)
B1, B2, EPS = 0.9, 0.999, 1e-8


def _mlp(params: Dict[str, torch.Tensor], head: str, x: torch.Tensor):
    n = sum(1 for k in params if k.startswith(head + ".")
            and k.endswith(".weight"))
    for i in range(n):
        x = x @ params[f"{head}.{i}.weight"].T + params[f"{head}.{i}.bias"]
        if i < n - 1:
            x = torch.tanh(x)
    return x


def forward(params, obs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, log_std, value)."""
    return (_mlp(params, "actor", obs), params["log_std"],
            _mlp(params, "critic", obs)[..., 0])


def log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * LOG_2PI, dim=-1)


def entropy(log_std):
    return torch.sum(log_std + 0.5 * (LOG_2PI + 1.0), dim=-1)


def act(params, obs, noise):
    """(action, log_prob, value) of the Gaussian draw mean + std * noise."""
    mean, log_std, value = forward(params, obs)
    action = mean + torch.exp(log_std) * noise
    return action, log_prob(mean, log_std, action), value


def gae(reward, value, done, trunc_boot, last_value, gamma: float,
        lam: float):
    """(advantages, returns) over (T, B): the boundary value is 0 at a
    termination, V(final obs) (trunc_boot) at a pure truncation, V(next
    obs) mid-episode."""
    T = reward.shape[0]
    advs = torch.empty_like(value)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(T - 1, -1, -1):
        nonterm = 1.0 - done[t].to(value.dtype)
        delta = reward[t] + gamma * (v_next * nonterm + trunc_boot[t]) \
            - value[t]
        adv_next = delta + gamma * lam * nonterm * adv_next
        advs[t] = adv_next
        v_next = value[t]
    return advs, advs + value


def loss(params, obs, action, old_logp, adv, ret, clip_eps: float,
         vf_coef: float, ent_coef: float):
    mean, log_std, value = forward(params, obs)
    logp = log_prob(mean, log_std, action)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.mean(torch.minimum(
        ratio * adv_n, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv_n))
    v = 0.5 * torch.mean((value - ret) ** 2)
    return pg + vf_coef * v - ent_coef * torch.mean(entropy(log_std))


def update_steps(params: Dict[str, torch.Tensor], batches: List[tuple],
                 lr: float, max_norm: float, clip_eps: float,
                 vf_coef: float, ent_coef: float, state=None):
    """Adam steps on `batches` (obs, action, old_logp, adv, ret), each
    after the global norm clip, from Adam's `state` (first moments,
    second moments, steps taken) or a fresh one.  Returns (losses, the
    first step's clipped gradient, the params after the last step), by
    name."""
    p = {k: v.detach().clone() for k, v in params.items()}
    if state is None:
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        s = {k: torch.zeros_like(v) for k, v in p.items()}
        t0 = 0
    else:
        m, s, t0 = dict(state[0]), dict(state[1]), int(state[2])
    losses, first = [], None
    for t, batch in enumerate(batches, start=t0 + 1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        value = loss(leaves, *batch, clip_eps, vf_coef, ent_coef)
        grads = dict(zip(leaves, torch.autograd.grad(value,
                                                     list(leaves.values()))))
        losses.append(value.detach())
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if g_norm >= max_norm:
            grads = {k: g / g_norm * max_norm for k, g in grads.items()}
        if first is None:
            first = grads
        for k, g in grads.items():
            m[k] = B1 * m[k] + (1 - B1) * g
            s[k] = B2 * s[k] + (1 - B2) * g * g
            m_hat = m[k] / (1 - B1 ** t)
            s_hat = s[k] / (1 - B2 ** t)
            p[k] = p[k] - lr * m_hat / (torch.sqrt(s_hat) + EPS)
    return losses, first, p
