"""Where a hammer-v0 physics substep's time goes in the port, on the card,
read from the tracer's spans (`mj_envs_torch.trace`).

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 -m mj_envs_torch.stage_profile [--envs 512] [--reps 3]

It resets `--envs` hammer envs (one main-path chunk by default), takes
two auto-reset steps with seeded random actions so that the states hold
contacts, and then:

1. runs `--reps` real `pipeline.step` calls with the tracer on, each
   ended by `torch.cuda.synchronize()`: per substep, each span's host
   ms, its self ms (less its child spans) and the synchronizing CUDA
   operations made inside it, and the wall ms to the synchronize; and
   the lines of the port that made those synchronizing operations.  The
   spans do not synchronize: a span's ms is what the host spends
   issuing its stage;
2. traces one substep with `torch.profiler`, the tracer on: device
   operations launched, device time summed over them, the wall time of
   the traced substep, the device's idle share (1 - device time / wall
   time, also against the untraced substeps of step 1), and the device
   operations and their device ms under each span (an operation goes to
   the innermost span open when the host launched it);
3. runs the noslip kernel on that substep's own sweep problem at the
   main path's tol (MJE_NOSLIP_TOL, default 1e-3) and at tol = 0
   (exactly 20 sweeps): sweeps each env ran before its per-env exit, and
   how far its forces end from the full 20 sweeps, relative to the env's
   force scale;
4. prints one JSON line with all of it, the card's name and power limit
   beside the numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

from . import envs, trace
from .envs.base import _apply_var
from .parallel.vector import VectorEnv, random_actions
from .physics import kernels
from .physics import pipeline as P
from .physics import solver as S


def noslip_problem_of(m, d, ctrl) -> S.NoslipProblem:
    """The noslip sweep problem of one substep from state `d`: the
    pipeline's forward pass, then the Newton solve again from its
    outputs and `solver.noslip_problem` with the mass matrix's factor,
    as `solver.noslip` builds it."""
    s = m.spec
    out = P.forward_core(m, d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    _, M_fac = kernels.chol_solve_factor(out.M, out.qacc_smooth)
    solve = S.newton_solve(out.M, out.qacc_smooth, out.rows,
                           d.qacc_warmstart, iterations=s.iterations,
                           tol_scale=S.newton_tol_scale())
    return S.noslip_problem(out.M, out.rows, solve,
                            int(np.sum(s.dof_hasfrictionloss)), P.ncmax(s),
                            M_fac)


def noslip_exit(prob: S.NoslipProblem, iters: int):
    """Sweeps per env at the main path's tol on a noslip problem, and
    max |u(tol) - u(0)| / max(max hi, 1) over the envs."""
    prob = [t.contiguous() for t in prob[:7]]
    sweeps = torch.empty(prob[0].shape[0], dtype=torch.int32,
                         device=prob[0].device)
    u_tol = kernels.noslip_sweep_cuda(*prob, iters, S.noslip_tol(),
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


def device_ops_by_span(events, names) -> dict:
    """{span: [device operations, their device ms]} of a kineto trace's
    events: each device operation goes to the innermost of the spans
    `names` open at its launch on the host ("(no span)" outside all)."""
    from torch.autograd import DeviceType
    cpu = [e for e in events if e.device_type() != DeviceType.CUDA]
    # the runtime's launch calls (cudaLaunchKernel, cudaMemcpyAsync, ...);
    # an operator's event may carry the same number
    launched = {e.correlation_id(): e.start_ns() for e in cpu
                if e.name().startswith("cu") and e.correlation_id()}
    ranges = [(e.start_ns(), e.end_ns(), e.name()) for e in cpu
              if e.name() in names]
    out: dict = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        t = launched.get(e.correlation_id())
        inner = max(((s0, n) for s0, s1, n in ranges
                     if t is not None and s0 <= t <= s1), default=None)
        rec = out.setdefault(inner[1] if inner else "(no span)", [0, 0.0])
        rec[0] += 1
        rec[1] += (e.end_ns() - e.start_ns()) * 1e-6
    return out


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

    trace.enable()
    sites = collections.Counter()
    counted = warnings.showwarning

    def showwarning(message, category, filename, lineno, *a, **k):
        if str(message).startswith(trace.SYNC_WARNING):
            sites[f"{os.path.relpath(filename)}:{lineno}"] += 1
        counted(message, category, filename, lineno, *a, **k)
    warnings.showwarning = showwarning
    before = dict(trace.counters)
    wall_s = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        P.step(m, st.data, ctrl)
        torch.cuda.synchronize()
        wall_s += time.perf_counter() - t0
    gained = trace.since(before)
    per = 1e-6 / args.reps
    spans = {name: {"ms": v["ns"] * per, "self_ms": v["self_ns"] * per,
                    "n": v["n"] / args.reps,
                    "syncs": v.get("syncs", 0) / args.reps}
             for name, v in trace.spans(gained).items()}
    substep_ms = 1e3 * wall_s / args.reps
    launches = {k: gained[k] / args.reps for k in kernels.KERNELS}
    warnings.showwarning = counted
    sync_sites = {k: v / args.reps for k, v in sites.most_common()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        P.step(m, st.data, ctrl)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    trace.enable(False)
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in evs) / 1e3
    by_span = device_ops_by_span(prof.profiler.kineto_results.events(),
                                 set(spans))
    out = {
        "gpu": gpu_info(), "envs": args.envs, "reps": args.reps,
        "substep_ms": substep_ms, "spans": spans,
        "traced_substep_wall_ms": wall_ms,
        "device_kernels": len(evs), "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        # The trace slows the host; against the untraced substeps:
        "device_idle_share_untraced": 1.0 - device_ms / substep_ms,
        "device_ops_by_span": by_span, "sync_sites": sync_sites,
        "port_kernel_launches": launches,
    }
    out["noslip_tol_exit"] = noslip_exit(noslip_problem_of(m, st.data, ctrl),
                                         m.spec.noslip_iterations)
    print(f"  {'span':28s} {'ms':>9s} {'self ms':>9s} {'syncs':>7s} "
          f"{'device ops':>10s}")
    for name, v in sorted(spans.items(), key=lambda kv: -kv[1]["self_ms"]):
        print(f"  {name:28s} {v['ms']:9.3f} {v['self_ms']:9.3f} "
              f"{v['syncs']:7.1f} {by_span.get(name, [0])[0]:10d}")
    print("  synchronizing operations a substep by line:")
    for site, n in list(sync_sites.items())[:15]:
        print(f"  {n:7.1f} {site}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
