"""The reference at a tiny size on the CPU: its float64 path is the
port's float64 path (a frozen copy); the port's float32 step is within
the rounding of float32 of it; its PPO arithmetic is the port's."""
import os

import pytest
import torch

from benchmark.lib import check, drive, spec
from benchmark.reference import envs as RE
from benchmark.reference import policy as RP

F64 = torch.float64


@pytest.mark.parametrize("task", ["hammer-v0", "door-v0"])
def test_reference_is_the_ports_float64_path(task):
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv
    port = envs.make(task, device="cpu", dtype=F64)
    ref = RE.make(task, device="cpu")
    vec = VectorEnv(port, 2)
    s = vec.reset(3)
    a = drive.uniform_actions(torch.Generator().manual_seed(4), 2, port.nu,
                              "cpu").to(F64)
    p1 = port.step(s, a)
    r1 = ref.step(check.rows_of(s, torch.arange(2)), a)
    for f in ("qpos", "qvel"):
        torch.testing.assert_close(getattr(r1.data, f), getattr(p1.data, f),
                                   rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r1.obs, p1.obs, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r1.reward, p1.reward, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("task", ["hammer-v0", "door-v0"])
def test_float32_step_within_rounding(task):
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv
    port = envs.make(task, device="cpu")
    vec = VectorEnv(port, 3)
    s = vec.reset(5)
    a = drive.uniform_actions(torch.Generator().manual_seed(6), 3, port.nu,
                              "cpu")
    post = port.step_auto_reset(s, a, vec.generator)
    rows = torch.arange(3)
    ref = RE.make(task, device="cpu")
    config = spec.load_json(os.path.join(spec.BENCH, "configs",
                                         task + ".json"))
    n = check.physics_summary([
        check.reset_numbers(ref, config, check.rows_of(s, rows)),
        check.step_numbers(ref, config, check.rows_of(s, rows), a,
                           check.rows_of(post, rows))])
    assert n["flags"] == 0
    assert n["state_err.max"] < 1e-4
    assert max(n["obs_err.max"], n["reward_err.max"]) < 1e-5


def test_ppo_arithmetic_is_the_ports():
    from mj_envs_torch.algos import networks as N
    from mj_envs_torch.algos import ppo as PPO
    cfg = PPO.PPOConfig(hidden=(8, 8))
    w = drive.policy_weights(1, 5, 3, cfg.hidden, "cpu")
    w = {k: v.to(F64) for k, v in w.items()}
    module = N.ActorCritic(5, 3, cfg.hidden, device="cpu", dtype=F64)
    module.load_state_dict(w)
    g = torch.Generator().manual_seed(2)
    obs = torch.randn(16, 5, generator=g, dtype=F64)
    noise = torch.randn(16, 3, generator=g, dtype=F64)
    a_p, lp_p, v_p = PPO.act(module, obs, None, noise)
    a_r, lp_r, v_r = RP.act(w, obs, noise)
    for x, y in ((a_p, a_r), (lp_p, lp_r), (v_p, v_r)):
        torch.testing.assert_close(x.detach(), y, rtol=1e-12, atol=1e-12)
    adv = torch.randn(16, generator=g, dtype=F64)
    ret = torch.randn(16, generator=g, dtype=F64)
    batch = (obs, a_r, lp_r.detach() + 0.01, adv, ret)
    opt = PPO.make_optimizer(module, cfg)
    losses_p = []
    for _ in range(3):
        opt.zero_grad()
        loss, _ = PPO.ppo_loss(cfg, module, *batch)
        loss.backward()
        with torch.no_grad():
            PPO.clip_by_global_norm_(list(module.parameters()),
                                     cfg.max_grad_norm)
        opt.step()
        losses_p.append(loss.detach())
    losses_r, _, p3 = RP.update_steps(w, [batch] * 3, cfg.lr,
                                      cfg.max_grad_norm, cfg.clip_eps,
                                      cfg.vf_coef, cfg.ent_coef)
    torch.testing.assert_close(torch.stack(losses_p), torch.stack(losses_r),
                               rtol=1e-10, atol=1e-12)
    for name, p in module.named_parameters():
        torch.testing.assert_close(p.detach(), p3[name], rtol=1e-9,
                                   atol=1e-12)


def test_gae_is_the_ports():
    from mj_envs_torch.algos import ppo as PPO
    g = torch.Generator().manual_seed(3)
    T, B = 5, 4
    traj = PPO.Transition(
        obs=None, action=None, log_prob=None,
        value=torch.randn(T, B, generator=g, dtype=F64),
        reward=torch.randn(T, B, generator=g, dtype=F64),
        done=torch.rand(T, B, generator=g) < 0.3,
        trunc_boot=torch.randn(T, B, generator=g, dtype=F64))
    last = torch.randn(B, generator=g, dtype=F64)
    cfg = PPO.PPOConfig()
    a_p, r_p = PPO._gae(cfg, traj, last)
    a_r, r_r = RP.gae(traj.reward, traj.value, traj.done, traj.trunc_boot,
                      last, cfg.gamma, cfg.gae_lambda)
    torch.testing.assert_close(a_p, a_r, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(r_p, r_r, rtol=1e-12, atol=1e-12)
