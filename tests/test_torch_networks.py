"""The port's actor-critic (`mj_envs_torch/algos/networks.py`) against
the JAX package's (`mj_envs_tpu/algos/networks.py`), CPU.

Weights drawn by `actor_critic_init` at hammer's widths (46 -> (64, 64)
-> 26: no layer square, so a weight carried across without its
transpose fails) go into the port through `actor_critic_from_numpy`;
both sides take the same seeded numpy observations and actions.
Tolerances (max abs), 3-5x the worst over seeds 0-2 (`python
tests/measure_torch_learner_floors.py networks`): mean and value 3e-15
in float64 (worst 7.8e-16), 1e-6 in float32 (3.6e-7); the log-prob and
entropy, sums of 26 terms of size ~1e1, 1e-13 (2.1e-14) and 3e-5
(1.1e-5); log_std exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu.algos import networks as JN
from mj_envs_torch.algos import networks as TN

OBS, ACT, HIDDEN, B = 46, 26, (64, 64), 32
TOL = {torch.float64: dict(out=3e-15, logp=1e-13),
       torch.float32: dict(out=1e-6, logp=3e-5)}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def jax_params(seed, dtype):
    p = JN.actor_critic_init(jax.random.PRNGKey(seed), OBS, ACT, HIDDEN,
                             dtype=jnp.dtype(NP[dtype]))
    # A non-zero log_std, so the log-prob and entropy see it.
    rng = np.random.default_rng(seed + 100)
    p["log_std"] = jnp.asarray(
        0.3 * rng.standard_normal(ACT).astype(NP[dtype]))
    return jax.tree_util.tree_map(np.asarray, p)


def network_errors(seed, dtype):
    """Max abs error of mean, value, log_std, log-prob and entropy, port
    against JAX, at `seed` and `dtype`."""
    p = jax_params(seed, dtype)
    mod = TN.actor_critic_from_numpy(p, device="cpu", dtype=dtype)
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, OBS)).astype(NP[dtype])
    act = rng.standard_normal((B, ACT)).astype(NP[dtype])
    jm, jls, jv = JN.actor_critic_apply(p, jnp.asarray(obs))
    with torch.no_grad():
        tm, tls, tv = mod(torch.as_tensor(obs))
        tlp = TN.gaussian_log_prob(tm, tls, torch.as_tensor(act))
        tent = TN.gaussian_entropy(tls)
    jlp = JN.gaussian_log_prob(jm, jls, jnp.asarray(act))
    jent = JN.gaussian_entropy(jls)
    assert tv.shape == (B,) and tm.shape == (B, ACT)
    err = lambda t, j: float(np.abs(t.detach().double().numpy()
                                    - np.asarray(j, np.float64)).max())
    return dict(mean=err(tm, jm), value=err(tv, jv), log_std=err(tls, jls),
                log_prob=err(tlp, jlp), entropy=err(tent, jent))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_apply_log_prob_entropy_match_jax(dtype):
    e = network_errors(0, dtype)
    tol = TOL[dtype]
    assert e["log_std"] == 0.0, e
    for k in ("mean", "value"):
        assert e[k] <= tol["out"], e
    for k in ("log_prob", "entropy"):
        assert e[k] <= tol["logp"], e


def test_numpy_round_trip_is_exact():
    p = jax_params(1, torch.float32)
    back = TN.actor_critic_to_numpy(
        TN.actor_critic_from_numpy(p, device="cpu"))
    flat_p, tree_p = jax.tree_util.tree_flatten(p)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_p == tree_b
    for a, b in zip(flat_p, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_orthogonal_scaled_zero_bias():
    """`_init_linear`: the smaller side's vectors orthonormal times the
    scale (sqrt 2 in hidden layers, 0.01 / 1.0 in the actor / critic
    heads), zero biases and log_std, draws from the generator."""
    gen = torch.Generator().manual_seed(3)
    mod = TN.ActorCritic(OBS, ACT, HIDDEN, generator=gen, device="cpu",
                         dtype=torch.float64)
    for layers, head in ((mod.actor, 0.01), (mod.critic, 1.0)):
        for i, lyr in enumerate(layers):
            scale = head if i == len(layers) - 1 else np.sqrt(2.0)
            w = lyr.weight.detach().T.numpy()          # (in, out)
            g = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
            np.testing.assert_allclose(g, scale ** 2 * np.eye(len(g)),
                                       rtol=0, atol=1e-12 * scale ** 2)
            assert not lyr.bias.detach().any()
    assert [lyr.weight.shape[0] for lyr in mod.critic] == [64, 64, 1]
    assert not mod.log_std.detach().any()
    again = TN.ActorCritic(OBS, ACT, HIDDEN, device="cpu",
                           dtype=torch.float64,
                           generator=torch.Generator().manual_seed(3))
    other = TN.ActorCritic(OBS, ACT, HIDDEN, device="cpu",
                           dtype=torch.float64,
                           generator=torch.Generator().manual_seed(4))
    w0 = mod.actor[0].weight
    assert torch.equal(w0, again.actor[0].weight)
    assert not torch.equal(w0, other.actor[0].weight)


def test_sample_is_mean_plus_scaled_noise():
    mean = torch.zeros(4, ACT, dtype=torch.float64)
    log_std = torch.full((ACT,), np.log(0.5), dtype=torch.float64)
    noise = torch.randn(4, ACT, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
    a = TN.gaussian_sample(mean + 1.0, log_std, None, noise)
    torch.testing.assert_close(a, 1.0 + 0.5 * noise, rtol=0, atol=1e-15)
    gen = torch.Generator().manual_seed(0)
    b = TN.gaussian_sample(mean + 1.0, log_std, gen)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_module_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        TN.ActorCritic(OBS, ACT, HIDDEN)
