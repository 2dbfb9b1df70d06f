"""Where a hammer-v0 physics substep's time goes in the port, on the card.

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 -m mj_envs_torch.stage_profile [--envs 512] [--reps 3]

It resets `--envs` hammer envs (one main-path chunk by default), takes
two auto-reset steps with seeded random actions so that the states hold
contacts, and then:

1. times each stage of `pipeline.forward_core` plus the Euler update,
   host clock around work that ends in `torch.cuda.synchronize()`
   (mean of `--reps` substeps);
2. traces one substep with `torch.profiler`: kernels launched, device
   time summed over kernels, the wall time of the traced substep, and
   the device's idle share (1 - device time / wall time), also against
   the untraced substep of step 1;
3. runs the noslip kernel on that substep's own sweep problem at the
   main path's tol = 1e-3 and at tol = 0 (exactly 20 sweeps): sweeps
   each env ran before its per-env exit, and how far its forces end from
   the full 20 sweeps, relative to the env's force scale;
4. prints one JSON line with all of it, the card's name and power limit
   beside the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from . import envs
from .envs.base import _apply_var
from .parallel.vector import VectorEnv, random_actions
from .physics import actuation as A
from .physics import constraint as CN
from .physics import dynamics as D
from .physics import kernels
from .physics import kinematics as K
from .physics import pipeline as P
from .physics import solver as S
from .physics.collision import driver as C


def substep_stages(m, d, ctrl, tick):
    """One `pipeline.step`, stage by stage, as `forward_core` runs it;
    `tick(name)` closes each stage."""
    s = m.spec
    kin = K.kinematics(m, d.qpos)
    tick("kinematics")
    M = D.crb(m, kin)
    vel = D.com_velocity(m, kin, d.qvel)
    act = A.actuation(m, d.qpos, d.qvel, ctrl)
    frc = act.qfrc_actuator + D.passive_force(m, d.qpos, d.qvel) \
        + d.qfrc_applied - D.bias_force(m, kin, vel, d.qvel)
    tick("smooth dynamics")
    qacc_smooth, M_fac = kernels.chol_solve_factor(M, frc)
    tick("chol_solve_factor")
    nc = P.ncmax(s)
    _, cc = C.collide(m, kin, nc)
    tick("collide")
    rows = CN.make_rows(m, kin, d.qpos, d.qvel, cc)
    tick("make_rows")
    solve = S.newton_solve(M, qacc_smooth, rows, d.qacc_warmstart,
                           iterations=s.iterations)
    tick("newton_solve")
    nfl = int(np.sum(s.dof_hasfrictionloss))
    solve = S.noslip(M, rows, solve, nfl, nc, s.noslip_iterations,
                     M_fac=M_fac)
    tick("noslip")
    P._sensors(m, kin, d.qpos, act, cc, solve)
    tick("sensors")
    h = float(s.timestep)
    qfrc = torch.matmul(M, solve.qacc[..., None])[..., 0]
    kernels.chol_solve(M + h * torch.diag(m.dof_damping), qfrc)
    tick("euler")


def noslip_exit(m, d, ctrl):
    """Sweeps per env at tol = 1e-3 on a real substep's noslip problem,
    and max |u(tol) - u(0)| / max(max hi, 1) over the envs."""
    captured = []
    sweep = kernels.noslip_sweep

    def capture(*args, **kw):
        captured.append(args[:7])
        return sweep(*args, **kw)

    kernels.noslip_sweep = capture
    P.step(m, d, ctrl)
    kernels.noslip_sweep = sweep
    prob = [t.contiguous() for t in captured[0]]
    iters = m.spec.noslip_iterations
    sweeps = torch.empty(prob[0].shape[0], dtype=torch.int32,
                         device=prob[0].device)
    u_tol = kernels.noslip_sweep_cuda(*prob, iters, S.NOSLIP_TOL,
                                      sweeps=sweeps)
    u_full = kernels.noslip_sweep_cuda(*prob, iters, 0.0)
    scale = torch.clamp(prob[3].max(dim=1).values, min=1.0)
    du = ((u_tol - u_full).abs().max(dim=1).values / scale).max().item()
    sw = sweeps.float()
    return {"sweeps_min": int(sw.min()), "sweeps_mean": sw.mean().item(),
            "sweeps_max": int(sw.max()), "max_du_over_scale": du}


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_profile: no CUDA device")
    dev = torch.device("cuda")
    env = envs.make("hammer-v0", device=dev)
    venv = VectorEnv(env, args.envs, chunk_size=args.envs)
    st = venv.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        st = venv.step(st, random_actions(gen, args.envs, env.nu, dev))
    m = _apply_var(env.model, st.var)
    ctrl = env.act_mid + random_actions(gen, args.envs, env.nu, dev) \
        * env.act_rng
    torch.cuda.synchronize()

    stage_s: dict = {}
    for _ in range(args.reps):
        t = [time.perf_counter()]

        def tick(name):
            torch.cuda.synchronize()
            now = time.perf_counter()
            stage_s[name] = stage_s.get(name, 0.0) + now - t[0]
            t[0] = now

        substep_stages(m, st.data, ctrl, tick)
    stage_ms = {k: 1e3 * v / args.reps for k, v in stage_s.items()}

    kernels.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        P.step(m, st.data, ctrl)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in evs) / 1e3
    top = sorted(prof.key_averages(),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    out = {
        "gpu": gpu_info(), "envs": args.envs,
        "stage_ms": stage_ms, "substep_ms": sum(stage_ms.values()),
        "traced_substep_wall_ms": wall_ms,
        "device_kernels": len(evs), "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        # The trace slows the host; against the untraced substep:
        "device_idle_share_untraced": 1.0 - device_ms
        / sum(stage_ms.values()),
        "port_kernel_launches": dict(kernels.launches),
        "top_host_ops": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in top],
    }
    out["noslip_tol_exit"] = noslip_exit(m, st.data, ctrl)
    for k, v in stage_ms.items():
        print(f"  {k:18s} {v:9.3f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
