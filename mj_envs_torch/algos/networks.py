"""Policy / value networks of the PyTorch port
(`mj_envs_tpu/algos/networks.py`).

The JAX package keeps its MLPs as pytrees of {"w": (in, out), "b":
(out,)} layers; here an MLP is an `nn.ModuleList` of `nn.Linear` layers,
whose weight is (out, in), applied with a chosen activation (tanh for
the actor-critic and NPG, relu for SAC).  `mlp_from_numpy` /
`mlp_to_numpy` and `actor_critic_from_numpy` / `actor_critic_to_numpy`
carry a JAX layer list or parameter tree across and back, transposing
each weight; `cnn_actor_critic_from_numpy` / `_to_numpy` do the same for
the pixel policy's CNN, whose conv weights cross from HWIO to OIHW.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_LOG_2PI = math.log(2.0 * math.pi)


def _orthogonal(n: int, generator: torch.Generator, dtype) -> torch.Tensor:
    """An (n, n) orthogonal matrix: QR of a Gaussian draw, the signs of
    R's diagonal moved into Q (the Haar measure, as
    `jax.random.orthogonal`; a different stream)."""
    a = torch.randn(n, n, generator=generator, device=generator.device,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))).to(dtype)


def _init_linear(layer: nn.Linear, generator: torch.Generator,
                 scale: float):
    """`_init_linear` (:17-21): an orthogonal matrix of size
    max(fan_in, fan_out) cut to [:fan_in, :fan_out] and scaled; zero
    bias."""
    fan_out, fan_in = layer.weight.shape
    w = _orthogonal(max(fan_in, fan_out), generator, layer.weight.dtype)
    with torch.no_grad():
        layer.weight.copy_((w[:fan_in, :fan_out] * scale).T)
        layer.bias.zero_()


def _mlp(sizes: Sequence[int], out_scale: float, generator, device,
         dtype) -> nn.ModuleList:
    """`mlp_init` (:24-31): sizes = (in, h1, ..., out), hidden layers
    scaled by sqrt(2), the last by `out_scale`."""
    layers = nn.ModuleList(
        nn.Linear(sizes[i], sizes[i + 1], device=device, dtype=dtype)
        for i in range(len(sizes) - 1))
    for i, layer in enumerate(layers):
        last = i == len(layers) - 1
        _init_linear(layer, generator, out_scale if last else math.sqrt(2.0))
    return layers


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
               activation: Callable = torch.tanh) -> torch.Tensor:
    """`mlp_apply` (:34-38)."""
    for layer in layers[:-1]:
        x = activation(layer(x))
    return layers[-1](x)


class ActorCritic(nn.Module):
    """Diagonal-Gaussian actor and value critic with separate tanh
    trunks and a state-independent log_std (SB3's ActorCriticPolicy
    layout).  The actor's last layer is scaled by 0.01, the critic's by
    1.0; the weights are drawn from `generator` (on the device the
    module is built on when none is given, seeded 0)."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.hidden = tuple(hidden)
        self.actor = _mlp((obs_dim, *hidden, act_dim), 0.01, generator,
                          device, dtype)
        self.critic = _mlp((obs_dim, *hidden, 1), 1.0, generator, device,
                           dtype)
        self.log_std = nn.Parameter(
            torch.zeros(act_dim, device=device, dtype=dtype))

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (mean (..., act_dim), log_std (act_dim,), value (...,))."""
        mean = _mlp_apply(self.actor, obs)
        value = _mlp_apply(self.critic, obs)[..., 0]
        return mean, self.log_std, value


def gaussian_log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * _LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)


def gaussian_sample(mean, log_std, generator: Optional[torch.Generator],
                    noise: Optional[torch.Tensor] = None):
    """mean + exp(log_std) * noise; `noise` (standard normal, the shape
    of `mean`) is drawn from `generator` unless given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(log_std) * noise


def mlp_to_numpy(layers: nn.ModuleList) -> List[Dict]:
    """The JAX package's layer list [{"w": (in, out), "b": (out,)}]."""
    return [{"w": lyr.weight.detach().cpu().numpy().T.copy(),
             "b": lyr.bias.detach().cpu().numpy().copy()} for lyr in layers]


def _copy_layers(layers: nn.ModuleList, tree):
    with torch.no_grad():
        for lyr, p in zip(layers, tree):
            lyr.weight.copy_(torch.as_tensor(np.array(p["w"]).T))
            lyr.bias.copy_(torch.as_tensor(np.array(p["b"])))


def mlp_from_numpy(tree, device="cuda", dtype=torch.float32
                   ) -> nn.ModuleList:
    """An MLP holding `tree`, a JAX layer list of arrays (as `mlp_init`
    returns, or `mlp_to_numpy`)."""
    sizes = [np.shape(tree[0]["w"])[0]] + [np.shape(p["w"])[1] for p in tree]
    layers = nn.ModuleList(
        nn.Linear(sizes[i], sizes[i + 1], device=device, dtype=dtype)
        for i in range(len(sizes) - 1))
    _copy_layers(layers, tree)
    return layers


def actor_critic_to_numpy(module: ActorCritic) -> Dict:
    """The JAX package's parameter tree: {"actor": [{"w": (in, out),
    "b": (out,)}, ...], "critic": [...], "log_std": (act_dim,)}."""
    return {"actor": mlp_to_numpy(module.actor),
            "critic": mlp_to_numpy(module.critic),
            "log_std": module.log_std.detach().cpu().numpy().copy()}


def actor_critic_from_numpy(params: Dict, device="cuda",
                            dtype=torch.float32) -> ActorCritic:
    """An ActorCritic holding `params`, a JAX-layout tree of arrays (as
    `actor_critic_init` returns, or `actor_critic_to_numpy`)."""
    actor, critic = params["actor"], params["critic"]
    obs_dim = np.shape(actor[0]["w"])[0]
    act_dim = np.shape(actor[-1]["w"])[1]
    hidden = tuple(np.shape(lyr["w"])[1] for lyr in actor[:-1])
    crit_hidden = tuple(np.shape(lyr["w"])[1] for lyr in critic[:-1])
    if crit_hidden != hidden:
        raise ValueError(f"actor trunk {hidden} != critic trunk "
                         f"{crit_hidden}")
    module = ActorCritic(obs_dim, act_dim, hidden, device=device,
                         dtype=dtype)
    _copy_layers(module.actor, actor)
    _copy_layers(module.critic, critic)
    with torch.no_grad():
        module.log_std.copy_(torch.as_tensor(np.array(params["log_std"])))
    return module


# -- the CNN actor-critic for pixel observations ----------------------------
# The reference's `ActorCriticCnnPolicy` path (`mj_envs_vision/algos/
# baselines.py:120-134`: SB3 takes the CNN policy when `config.model_type
# == "cnn"`): SB3's NatureCNN torso (conv 32x8x8/4, 64x4x4/2, 64x3x3/1,
# VALID, fc 512, ReLU) shared by the actor and critic heads.

_NATURE_CONVS = ((8, 4, 32), (4, 2, 64), (3, 1, 64))  # (kernel, stride, out)


def _init_conv(conv: nn.Conv2d, generator: torch.Generator, scale: float):
    """`_init_conv` (:87-92): an orthogonal (kh kw cin, cout) matrix, cut
    and scaled as `_init_linear`, in the JAX package's HWIO order; zero
    bias."""
    cout, cin, kh, kw = conv.weight.shape
    fan_in = kh * kw * cin
    w = _orthogonal(max(fan_in, cout), generator, conv.weight.dtype)
    w = (w[:fan_in, :cout] * scale).reshape(kh, kw, cin, cout)
    with torch.no_grad():
        conv.weight.copy_(w.permute(3, 2, 0, 1))
        conv.bias.zero_()


class CnnActorCritic(nn.Module):
    """NatureCNN torso and a diagonal-Gaussian actor and value critic,
    each head one linear layer on the 512 features, with a
    state-independent log_std (SB3's ActorCriticCnnPolicy layout).

    forward takes (..., H, W, 3) pixels in [0, 255], float or uint8, in
    the JAX package's HWC layout.  They are divided by 255 in the
    parameter dtype.  The flattened conv output is in HWC order, as the
    JAX package flattens its NHWC activations, so that `fc` holds the
    JAX weights as they are."""

    def __init__(self, act_dim: int, in_hw: int = 64, in_ch: int = 3,
                 feat: int = 512, generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        convs, c, hw = [], in_ch, in_hw
        for ksz, stride, cout in _NATURE_CONVS:
            conv = nn.Conv2d(c, cout, ksz, stride, device=device,
                             dtype=dtype)
            _init_conv(conv, generator, math.sqrt(2.0))
            convs.append(conv)
            hw = (hw - ksz) // stride + 1
            c = cout
        self.convs = nn.ModuleList(convs)
        self.fc = nn.Linear(hw * hw * c, feat, device=device, dtype=dtype)
        _init_linear(self.fc, generator, math.sqrt(2.0))
        self.actor = _mlp((feat, act_dim), 0.01, generator, device, dtype)
        self.critic = _mlp((feat, 1), 1.0, generator, device, dtype)
        self.log_std = nn.Parameter(
            torch.zeros(act_dim, device=device, dtype=dtype))

    def features(self, pixels: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) -> (..., feat)."""
        lead = pixels.shape[:-3]
        x = pixels.reshape((-1,) + pixels.shape[-3:])
        x = x.to(self.fc.weight.dtype) / 255.0
        x = x.permute(0, 3, 1, 2)                     # NHWC -> NCHW
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # HWC flatten
        x = torch.relu(self.fc(x))
        return x.reshape(lead + (x.shape[-1],))

    def forward(self, pixels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (mean (..., act_dim), log_std (act_dim,), value (...,))."""
        feat = self.features(pixels)
        mean = _mlp_apply(self.actor, feat)
        value = _mlp_apply(self.critic, feat)[..., 0]
        return mean, self.log_std, value


def cnn_actor_critic_to_numpy(module: CnnActorCritic) -> Dict:
    """The JAX package's tree (`cnn_actor_critic_init`): {"torso":
    {"convs": [{"w": HWIO, "b"}], "fc": {"w": (in, out), "b"}}, "actor",
    "critic", "log_std"}."""
    convs = [{"w": c.weight.detach().cpu().permute(2, 3, 1, 0).numpy().copy(),
              "b": c.bias.detach().cpu().numpy().copy()}
             for c in module.convs]
    return {"torso": {"convs": convs, "fc": mlp_to_numpy([module.fc])[0]},
            "actor": mlp_to_numpy(module.actor),
            "critic": mlp_to_numpy(module.critic),
            "log_std": module.log_std.detach().cpu().numpy().copy()}


def cnn_actor_critic_from_numpy(params: Dict, device="cuda",
                                dtype=torch.float32) -> CnnActorCritic:
    """A CnnActorCritic holding `params`, a JAX-layout tree of arrays (as
    `cnn_actor_critic_init` returns, or `cnn_actor_critic_to_numpy`):
    conv weights HWIO -> OIHW, linear weights transposed."""
    torso = params["torso"]
    w0 = np.shape(torso["convs"][0]["w"])
    feat = np.shape(torso["fc"]["w"])[1]
    act_dim = np.shape(params["actor"][-1]["w"])[1]
    hw = int(round(math.sqrt(np.shape(torso["fc"]["w"])[0]
                             // np.shape(torso["convs"][-1]["w"])[3])))
    in_hw = hw
    for ksz, stride, _ in reversed(_NATURE_CONVS):
        in_hw = (in_hw - 1) * stride + ksz
    module = CnnActorCritic(act_dim, in_hw, w0[2], feat, device=device,
                            dtype=dtype)
    with torch.no_grad():
        for conv, p in zip(module.convs, torso["convs"]):
            conv.weight.copy_(torch.as_tensor(
                np.array(p["w"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.as_tensor(np.array(p["b"])))
        module.log_std.copy_(torch.as_tensor(np.array(params["log_std"])))
    _copy_layers([module.fc], [torso["fc"]])
    _copy_layers(module.actor, params["actor"])
    _copy_layers(module.critic, params["critic"])
    return module
