#!/usr/bin/env python3
"""Drive the PyTorch port (`mj_envs_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `mj_envs_torch/csrc/` (nvcc, sm_90a);
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes (B = 512 envs, nv = 33, nefc = 296, noslip R = 129):
   max error, kernel / plain / library times (CUDA events), and the
   card's bound for the same work;
4. a small-input reference: 8 hammer-v0 envs stepped twice on the card
   and on the CPU (plain versions) from the same state and actions;
5. the main path: hammer-v0 `VectorEnv(4096, chunk_size=512)`, reset and
   a few auto-reset steps, with every kernel's launch count read around
   the steps;
6. one JSON line listing the kernels, then the device line.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM published peaks (data sheet): HBM3 rate and the
# float32 rate outside the tensor cores.
BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

B_CHUNK = 512      # envs per chunk on the main path
NV = 33            # hammer-v0 dofs
NEFC = 296         # solver rows: 33 friction + 71 limits + 32 x 6 facets
R_NOSLIP = 129     # 33 dof friction rows + 3 x 32 facet pairs
NOSLIP_ITERS = 20
NUM_ENVS = 4096
STEPS = 5
F32 = 4


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    """Fail the run (an `assert` would vanish under python -O)."""
    if not ok:
        raise AssertionError(msg)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    tb = nbytes / BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, reps, warmup=2):
    """Mean device time of one call, from CUDA events around `reps`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want):
    """max |got - want| / max |want| (and the max abs error)."""
    d = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    return d / max(scale, 1e-30), d


def gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare_kernels(TK, dev):
    """Phase 3: each kernel vs its plain version at the main path's
    shapes; returns the JSON entries (launches filled in later)."""
    rng = np.random.default_rng(0)
    card = lambda xs: [torch.as_tensor(x).to(dev) for x in xs]
    H, g, G = card(TK.random_spd_problem(rng, B_CHUNK, NV, R_NOSLIP))
    g1 = g[..., None].contiguous()
    entries = []

    def record(name, replaces, source, errs, ms, plain_ms, lib_ms, nbytes,
               flops, tol):
        """`errs` maps each output to (rel, abs) error; `tol` is one
        relative tolerance or one per output."""
        bms, by = bound(nbytes, flops)
        tols = tol if isinstance(tol, dict) else dict.fromkeys(errs, tol)
        for what, (rel, ab) in errs.items():
            log(f"  {name} {what}: max_abs_err {ab:.3e} rel {rel:.3e} "
                f"(tol {tols[what]:g})")
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {bms * 1e3:.2f} us ({by})")
        for what, (rel, _) in errs.items():
            check(rel <= tols[what],
                  f"{name} {what}: kernel disagrees with its plain "
                  f"version (rel {rel:.3e} > {tols[what]})")
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=max(e[1] for e in errs.values()),
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms))

    mat = B_CHUNK * NV * NV * F32
    vec = B_CHUNK * NV * F32
    rhs = B_CHUNK * NV * R_NOSLIP * F32

    # K2: factor of M.
    fac_k = TK.chol_factor_cuda(H)
    fac_p = TK.chol_factor_plain(H).contiguous()
    record("chol_factor", "mj_envs_tpu/physics/kernels.py:949",
           "mj_envs_torch/csrc/chol.cu",
           {"fac": rel_err(fac_k, fac_p)},
           time_ms(lambda: TK.chol_factor_cuda(H), 50),
           time_ms(lambda: TK.chol_factor_plain(H), 20),
           time_ms(lambda: torch.linalg.cholesky_ex(H), 20),
           2 * mat, B_CHUNK * NV ** 3 / 3, 2e-4)

    # K3: substitution from the factor, R = 129 (noslip's X = M^-1 D^T)
    # and R = 1 (qacc_smooth).
    L = fac_p.transpose(-1, -2).contiguous()
    X_k = TK.chol_solve_fac_cuda(fac_p, G)
    x1_k = TK.chol_solve_fac_cuda(fac_p, g1)
    errs = {"X (R=129)": rel_err(X_k, TK.chol_solve_fac_plain(fac_p, G)),
            "x (R=1)": rel_err(x1_k, TK.chol_solve_fac_plain(fac_p, g1))}
    ms1 = time_ms(lambda: TK.chol_solve_fac_cuda(fac_p, g1), 50)
    log(f"  chol_solve_fac R=1: kernel {ms1:.4f} ms, bound "
        f"{bound(mat + 2 * vec, 2 * B_CHUNK * NV * NV)[0] * 1e3:.2f} us")
    record("chol_solve_fac", "mj_envs_tpu/physics/kernels.py:854",
           "mj_envs_torch/csrc/chol.cu", errs,
           time_ms(lambda: TK.chol_solve_fac_cuda(fac_p, G), 50),
           time_ms(lambda: TK.chol_solve_fac_plain(fac_p, G), 20),
           time_ms(lambda: torch.cholesky_solve(G, L), 20),
           mat + 2 * rhs, 2 * B_CHUNK * NV * NV * R_NOSLIP, 2e-4)

    # K4: factor and solve, one right-hand side (Newton step, damping).
    x_k = TK.chol_factor_solve_cuda(H, g)
    record("chol_factor_solve", "mj_envs_tpu/physics/kernels.py:567",
           "mj_envs_torch/csrc/chol.cu",
           {"x": rel_err(x_k, TK.chol_solve_plain(H, g))},
           time_ms(lambda: TK.chol_factor_solve_cuda(H, g), 50),
           time_ms(lambda: TK.chol_solve_plain(H, g), 20),
           time_ms(lambda: torch.linalg.solve(H, g), 20),
           mat + 2 * vec, B_CHUNK * (NV ** 3 / 3 + 2 * NV * NV), 2e-4)

    # K5: linesearch + row cost.  Operations per row: 8 for each phi'
    # and phi'' evaluation, 12 for the final cost; 12 bracket phi', 16
    # (phi', phi'') steps, one cost pass.
    ls = card(TK.random_linesearch_problem(rng, B_CHUNK, NEFC))
    a_k, c_k = TK.linesearch_cost_cuda(*ls, 12, 16)
    a_p, c_p = TK.linesearch_cost_plain(*ls, 12, 16)
    # Where phi' crosses zero at a kink, the safeguarded search ends in a
    # bisection bracket, and which side a float32 sum puts phi'(alpha) on
    # moves alpha within it.  So alpha is held at 2e-3 and the cost at
    # alpha, flat there, at 1e-5.  For scale, printed beside them: the
    # plain float32 search on the same rows in reversed order, and both
    # searches against a float64 plain search.
    a_rev, _ = TK.linesearch_cost_plain(
        *(x.flip(-1) if x.dim() == 2 else x for x in ls), 12, 16)
    a_64, _ = TK.linesearch_cost_plain(
        *(x.double() if x.is_floating_point() else x for x in ls), 12, 16)
    log(f"  linesearch_cost alpha, plain float32 rows reversed vs in "
        f"order: {rel_err(a_rev, a_p)[0]:.3e}; vs float64 search: kernel "
        f"{rel_err(a_k, a_64)[0]:.3e}, plain float32 "
        f"{rel_err(a_p, a_64)[0]:.3e} (rel)")
    ls_bytes = B_CHUNK * NEFC * (4 * F32 + 1) + 4 * B_CHUNK * F32
    record("linesearch_cost", "mj_envs_tpu/physics/kernels.py:373",
           "mj_envs_torch/csrc/linesearch.cu",
           {"alpha": rel_err(a_k, a_p), "cost": rel_err(c_k, c_p)},
           time_ms(lambda: TK.linesearch_cost_cuda(*ls, 12, 16), 50),
           time_ms(lambda: TK.linesearch_cost_plain(*ls, 12, 16), 5),
           None, ls_bytes, B_CHUNK * NEFC * (12 * 8 + 16 * 16 + 12),
           {"alpha": 2e-3, "cost": 1e-5})

    # K6: noslip sweeps at tol = 0 (exactly 20 sweeps, as the plain
    # version); then tol = 1e-3 (the main path's) against tol = 0.
    ns = card(TK.random_noslip_problem(rng, B_CHUNK, R_NOSLIP))
    u_k = TK.noslip_sweep_cuda(*ns, NOSLIP_ITERS, 0.0)
    u_p = TK.noslip_sweep_plain(*ns, NOSLIP_ITERS)
    sweeps = torch.zeros(B_CHUNK, dtype=torch.int32, device=dev)
    u_tol = TK.noslip_sweep_cuda(*ns, NOSLIP_ITERS, 1e-3, sweeps=sweeps)
    scale = torch.clamp(ns[3].max(dim=1).values, min=1.0)
    du = ((u_tol - u_k).abs().max(dim=1).values / scale).max().item()
    sw = sweeps.float()
    log(f"  noslip_sweep tol=1e-3 vs tol=0: sweeps per env min "
        f"{int(sw.min())} mean {sw.mean().item():.2f} max {int(sw.max())}; "
        f"max |du| / force scale {du:.3e}; kernel "
        f"{time_ms(lambda: TK.noslip_sweep_cuda(*ns, NOSLIP_ITERS, 1e-3), 20):.4f} ms")
    ns_bytes = B_CHUNK * R_NOSLIP * (R_NOSLIP + 7) * F32
    ns_flops = B_CHUNK * NOSLIP_ITERS * R_NOSLIP * (2 * R_NOSLIP + 6)
    record("noslip_sweep", "mj_envs_tpu/physics/kernels.py:50",
           "mj_envs_torch/csrc/noslip.cu", {"u": rel_err(u_k, u_p)},
           time_ms(lambda: TK.noslip_sweep_cuda(*ns, NOSLIP_ITERS, 0.0), 20),
           time_ms(lambda: TK.noslip_sweep_plain(*ns, NOSLIP_ITERS), 1, 1),
           None, ns_bytes, ns_flops, 1e-5)
    return entries


def small_reference(envs, VectorEnv, dev, n=8, steps=2):
    """Phase 4: the card path against the CPU plain path from one state
    with the same actions (tolerances of tests/test_torch_hammer.py)."""
    env_k = envs.make("hammer-v0", device=dev)
    env_p = envs.make("hammer-v0", device="cpu")
    vk, vp = VectorEnv(env_k, n), VectorEnv(env_p, n)
    st_k = vk.reset(seed=3)
    vp.reset(seed=3)
    st_p = st_k.map(lambda x: x.cpu())
    rng = np.random.default_rng(3)
    for _ in range(steps):
        a = rng.uniform(-1.0, 1.0, (n, env_k.nu)).astype(np.float32)
        st_k = vk.step(st_k, torch.as_tensor(a, device=dev))
        st_p = vp.step(st_p, torch.as_tensor(a))
    worst = 0.0
    for name in ("obs", "reward"):
        k, p = getattr(st_k, name).cpu(), getattr(st_p, name)
        worst = max(worst, (k - p).abs().max().item())
        torch.testing.assert_close(k, p, rtol=1e-3, atol=2e-3)
    for name in ("qpos", "qvel"):
        k, p = getattr(st_k.data, name).cpu(), getattr(st_p.data, name)
        worst = max(worst, (k - p).abs().max().item())
        torch.testing.assert_close(k, p, rtol=1e-3, atol=2e-3)
    for name in ("done", "truncated", "nan_resets", "contact_clips"):
        check(torch.equal(getattr(st_k, name).cpu(), getattr(st_p, name)),
              f"{name}: card and CPU differ")
    log(f"  {n} envs x {steps} steps, card vs CPU: max abs diff "
        f"{worst:.3e} (rtol 1e-3, atol 2e-3)")


def main_path(TK, envs, VectorEnv, random_actions, dev, num_envs, chunk,
              steps):
    """Phase 5: reset and `steps` auto-reset steps; returns the launch
    counts of the timed steps and env-steps/s."""
    env = envs.make("hammer-v0", device=dev)
    venv = VectorEnv(env, num_envs, chunk_size=chunk)
    t0 = time.perf_counter()
    st = venv.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = venv.step(st, random_actions(gen, num_envs, env.nu, dev))
    torch.cuda.synchronize()
    log(f"  reset + first step: {time.perf_counter() - t0:.2f} s")

    TK.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = venv.step(st, random_actions(gen, num_envs, env.nu, dev))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(TK.launches)

    check(st.obs.shape == (num_envs, env.OBS_DIM), f"obs {st.obs.shape}")
    check(st.data.qpos.shape == (num_envs, env.nq),
          f"qpos {st.data.qpos.shape}")
    for name, t in (("qpos", st.data.qpos), ("qvel", st.data.qvel),
                    ("obs", st.obs), ("reward", st.reward)):
        check(bool(torch.isfinite(t).all()), f"non-finite {name}")
    nchunk = max(1, num_envs // chunk)
    calls = steps * env.FRAME_SKIP * nchunk
    log(f"  {steps} steps x {num_envs} envs in {dt:.3f} s: "
        f"{steps * num_envs / dt:.1f} env-steps/s; nan_resets "
        f"{int(st.nan_resets.sum())}, contact_clips "
        f"{int(st.contact_clips.sum())}, mean Newton iterations per chunk "
        f"substep {launches['linesearch_cost'] / calls:.2f}")
    log(f"  launches: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches, steps * num_envs / dt


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (the port's kernels need an "
                 "NVIDIA GPU)")
    import mj_envs_torch  # noqa: F401  (float32 matmul settings)
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv, random_actions
    from mj_envs_torch.physics import _build, kernels as TK

    dev = torch.device("cuda")
    info = gpu_info()
    log(f"[1] gpu: {info}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    log(f"[3] kernels vs plain versions at B = {B_CHUNK}:")
    entries = compare_kernels(TK, dev)

    log("[4] small-input reference:")
    small_reference(envs, VectorEnv, dev)

    log(f"[5] main path: hammer-v0, {NUM_ENVS} envs, chunk {B_CHUNK}:")
    launches, rate = main_path(TK, envs, VectorEnv, random_actions, dev,
                               NUM_ENVS, B_CHUNK, STEPS)
    for e in entries:
        e["launches"] = launches[e["name"]]

    log(json.dumps({"env_steps_per_s": rate, "gpu": info}))
    log(info)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
