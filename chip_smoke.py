#!/usr/bin/env python3
"""Drive the PyTorch port (`mj_envs_torch`) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from `mj_envs_torch/csrc/` (nvcc, sm_90a);
3. every kernel against its plain PyTorch version on the card, at the
   main path's shapes (B = 512 envs; hammer nv = 33, nefc = 296, noslip
   R = 129; the FK kernel on each task's tree with its per-env model
   fields; the Newton-step solve also at door's and pen's nv = 30 and
   relocate's 36; the noslip kernel also with 96 of its 129 rows empty
   contact slots, and on the sweep problem of a real hammer chunk after
   a reset and one step, with the sweeps its envs ran): max error,
   kernel / plain / library times (CUDA events), and the card's bound
   for the same work.  Beside them, bit for bit, each against a
   reference kernel that no front end calls: the Newton-step solve, the
   substitution from K2's factor (R = 129 and 1) and the factor-and-
   solve (R = 129 and 1, nv 30, 33, 36) against the block
   factor-and-solve (`chol_solve_mat_block_cuda`); both linesearches'
   alpha against the sequential search (`linesearch_seq_cuda`), with
   the Newton steps the fused search ran; the references' times;
4. a small-input reference: 8 envs of each task stepped twice on the
   card and on the CPU (plain versions) from the same state and actions;
   on the hammer card state, noslip without the mass-matrix factor (its
   own factor-and-solve kernel) against noslip with it;
4b. the options and the float64 path: 8 hammer envs x 2 steps in
   float64 on the card against the CPU (no kernel may launch); the same
   in float32 under MJE_JBASE=1 against the CPU and against the card's
   dense default (K3, K5 and K6 must launch); `kinematics_parallel`
   against the FK kernel on all four trees, and a step under
   MJE_FK_IMPL=parallel launching no FK kernel; `set_physics_state` on
   8 envs, card against CPU; a 512-env hammer step's time at the
   default and under each option; every knob as it was before;
5. the main path: hammer-v0 `VectorEnv(4096, chunk_size=512)`, reset and
   5 auto-reset steps, then door, pen and relocate at the same size for
   2 steps each, every kernel's launch count set to 0 before each task's
   timed steps and read after them;
6. the trainer: `configs/hammer_ppo.json` at full width (1024 envs,
   hidden (64, 64), 8 minibatches, 4 epochs, chunk 512, float32) for 2
   iterations of `train_ppo_policy` into a temporary directory, cut only
   in length (n_steps 8, 2 iterations, a checkpoint at the second, one
   evaluation after training of 10 episodes of 5 steps): each
   iteration's env-steps/s and rollout / GAE / update ms, the launches
   of one iteration, the checkpoint restored bit for bit; then one
   iteration of 8 hammer envs (n_steps 2, 2 x 2 minibatches) on the card
   and on the CPU from the same state, weights, action noise and
   permutations: the transitions and the params after;
7. one JSON line listing the kernels, then the device line.

Phase 3 also prints SHA-256 digests of the outputs of the factor
kernel, the noslip kernel, the alpha-only linesearch and the
factor-and-solve on its seeded problems, with their times.  `python3
chip_smoke.py --digests` prints only those, after phases 1 and 2, and no
result: copy the script into another checkout and run it there to hold
that checkout's kernels against these bit for bit.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
import hashlib
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
SM_HZ = 1.98e9     # the SM boost clock: cycles per second of a spin kernel

B_CHUNK = 512      # envs per chunk on the main path
NV = 33            # hammer-v0 dofs
K4_NVS = (30, 33, 36)   # door and pen, hammer, relocate
NEFC = 296         # solver rows: 33 friction + 71 limits + 32 x 6 facets
R_NOSLIP = 129     # 33 dof friction rows + 3 x 32 facet pairs
NOSLIP_ITERS = 20
NUM_ENVS = 4096
TASKS = ("hammer-v0", "door-v0", "pen-v0", "relocate-v0")
STEPS = {"hammer-v0": 5, "door-v0": 2, "pen-v0": 2, "relocate-v0": 2}
# The kernels every task's step runs (the other two are reached only
# through their front ends and noslip without a factor).
MAIN_KERNELS = ("fk", "chol_factor", "chol_solve_fac", "chol_factor_solve",
                "linesearch_cost", "noslip_sweep")
FK_TOL = 2e-5      # abs, scaled by max(1, |x|) per field
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
    back-to-back calls after `warmup` calls.  A spin kernel queued ahead
    of the first event holds the device while the host enqueues the
    calls (twice the host time of one call, times reps), so that a call
    whose wrapper takes longer on the host than its kernel on the device
    is timed by its device work, not by the host's gaps between launches.
    A call that waits for the device itself (a copy from pageable memory)
    still includes them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * reps * host_s + 1e-3, 5.0) * SM_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same_bits(what, got, want):
    """Print how far `got` is from `want` and fail unless they are equal
    bit for bit."""
    eq = torch.equal(got, want)
    log(f"  {what}: max |diff| "
        f"{(got.double() - want.double()).abs().max().item():.3e}, bit for "
        f"bit: {eq}")
    check(eq, f"{what}: not equal bit for bit")


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


def compare_kernels(TK, dev, real_noslip):
    """Phase 3: each kernel vs its plain version at the main path's
    shapes, and the noslip kernel on `real_noslip`, the sweep problem of
    a real hammer chunk; returns the JSON entries (launches filled in
    later)."""
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
    # One triangle: K2 and K8 read only one of the symmetric H, K3 only
    # L's of the factor (the rest is zeros by layout); K2 writes all of
    # the factor.
    tri = B_CHUNK * (NV * (NV + 1) // 2) * F32
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
           tri + mat, B_CHUNK * NV ** 3 / 3, 2e-4)

    # K3: substitution from the factor, R = 129 (noslip's X = M^-1 D^T)
    # and R = 1 (qacc_smooth, a warp per env).  Beside the plain version,
    # K2's factor then K3 is held bit for bit against the block
    # factor-and-solve, whose substitution runs K3's order of operations.
    L = fac_p.transpose(-1, -2).contiguous()
    X_k = TK.chol_solve_fac_cuda(fac_p, G)
    x1_k = TK.chol_solve_fac_cuda(fac_p, g1)
    errs = {"X (R=129)": rel_err(X_k, TK.chol_solve_fac_plain(fac_p, G)),
            "x (R=1)": rel_err(x1_k, TK.chol_solve_fac_plain(fac_p, g1))}
    for R, Y in ((R_NOSLIP, G), (1, g1)):
        same_bits(f"chol_solve_fac R={R} on chol_factor's factor vs the "
                  f"block factor-and-solve (chol_solve_mat_block)",
                  TK.chol_solve_fac_cuda(fac_k, Y),
                  TK.chol_solve_mat_block_cuda(H, Y))
    bms1, by1 = bound(tri + 2 * vec, 2 * B_CHUNK * NV * NV)
    log(f"  chol_solve_fac R=1: kernel "
        f"{time_ms(lambda: TK.chol_solve_fac_cuda(fac_p, g1), 50):.4f} ms, "
        f"plain {time_ms(lambda: TK.chol_solve_fac_plain(fac_p, g1), 20):.4f}"
        f" ms, library "
        f"{time_ms(lambda: torch.cholesky_solve(g1, L), 20):.4f} ms "
        f"(cholesky_solve), bound {bms1 * 1e3:.2f} us ({by1})")
    record("chol_solve_fac", "mj_envs_tpu/physics/kernels.py:854",
           "mj_envs_torch/csrc/chol.cu", errs,
           time_ms(lambda: TK.chol_solve_fac_cuda(fac_p, G), 50),
           time_ms(lambda: TK.chol_solve_fac_plain(fac_p, G), 20),
           time_ms(lambda: torch.cholesky_solve(G, L), 20),
           tri + 2 * rhs, 2 * B_CHUNK * NV * NV * R_NOSLIP, 2e-4)

    # K4: factor and solve, one right-hand side (Newton step, damping),
    # at each task's nv; the JSON entry is hammer's.  Its bytes: one
    # triangle of the symmetric H, g and x.  Beside the plain version it
    # is held bit for bit against the block factor-and-solve at R = 1,
    # the arithmetic of the one-block-per-env K4 of earlier versions.
    def k4(H, g):
        nv = g.shape[-1]
        x = TK.chol_factor_solve_cuda(H, g)
        same_bits(f"chol_factor_solve nv={nv} vs the block factor-and-solve "
                  f"(chol_solve_mat_block, R = 1)", x,
                  TK.chol_solve_mat_block_cuda(
                      H, g[..., None].contiguous())[..., 0])
        return ({"x": rel_err(x, TK.chol_solve_plain(H, g))},
                time_ms(lambda: TK.chol_factor_solve_cuda(H, g), 50),
                time_ms(lambda: TK.chol_solve_plain(H, g), 20),
                time_ms(lambda: torch.linalg.solve(H, g), 20),
                B_CHUNK * (nv * (nv + 1) // 2 + 2 * nv) * F32,
                B_CHUNK * (nv ** 3 / 3 + 2 * nv * nv))

    rng_nv = np.random.default_rng(4)
    for nv in K4_NVS:
        if nv == NV:
            continue
        Hn, gn, _ = card(TK.random_spd_problem(rng_nv, B_CHUNK, nv, 1))
        errs, ms, plain_ms, lib_ms, nbytes, flops = k4(Hn, gn)
        (rel, ab), = errs.values()
        log(f"  chol_factor_solve nv={nv}: max_abs_err {ab:.3e} rel "
            f"{rel:.3e} (tol 2e-4); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
            f"{bound(nbytes, flops)[0] * 1e3:.2f} us")
        check(rel <= 2e-4, f"chol_factor_solve nv={nv}: kernel disagrees "
              f"with its plain version (rel {rel:.3e} > 2e-4)")
    log(f"  chol_factor_solve nv={NV}:")
    record("chol_factor_solve", "mj_envs_tpu/physics/kernels.py:567",
           "mj_envs_torch/csrc/chol.cu", *k4(H, g), 2e-4)

    # K8: factor and solve over R = 129 right-hand sides (noslip without
    # a mass-matrix factor); the factor never leaves shared memory.  Held
    # bit for bit against the block factor-and-solve at R = 129 and R = 1
    # (K4's kernel) at each task's nv, and timed beside it.
    def lib_solve_mat():
        L, _ = torch.linalg.cholesky_ex(H)
        return torch.cholesky_solve(G, L)

    rng_k8 = np.random.default_rng(6)
    for nv in K4_NVS:
        Hn, _, Gn = (H, g, G) if nv == NV else card(
            TK.random_spd_problem(rng_k8, B_CHUNK, nv, R_NOSLIP))
        for R, Y in ((R_NOSLIP, Gn), (1, Gn[..., :1].contiguous())):
            same_bits(f"chol_solve_mat nv={nv} R={R} vs the block "
                      f"factor-and-solve (chol_solve_mat_block)",
                      TK.chol_solve_mat_cuda(Hn, Y),
                      TK.chol_solve_mat_block_cuda(Hn, Y))
    record("chol_solve_mat", "mj_envs_tpu/physics/kernels.py:719",
           "mj_envs_torch/csrc/chol.cu",
           {"X (R=129)": rel_err(TK.chol_solve_mat_cuda(H, G),
                                 TK.chol_solve_mat_plain(H, G))},
           time_ms(lambda: TK.chol_solve_mat_cuda(H, G), 50),
           time_ms(lambda: TK.chol_solve_mat_plain(H, G), 20),
           time_ms(lib_solve_mat, 20),
           tri + 2 * rhs,
           B_CHUNK * (NV ** 3 / 3 + 2 * NV * NV * R_NOSLIP), 2e-4)
    log(f"  chol_solve_mat_block (the reference, R = 129): "
        f"{time_ms(lambda: TK.chol_solve_mat_block_cuda(H, G), 50):.4f} ms")

    # K5: linesearch + row cost.  Operations per row: 8 for each phi'
    # and phi'' evaluation, 12 for the final cost; 12 bracket phi', 16
    # (phi', phi'') steps, one cost pass.
    ls = card(TK.random_linesearch_problem(rng, B_CHUNK, NEFC))
    steps = torch.zeros(B_CHUNK, dtype=torch.int32, device=dev)
    a_k, c_k = TK.linesearch_cost_cuda(*ls, 12, 16, steps=steps)
    a_p, c_p = TK.linesearch_cost_plain(*ls, 12, 16)
    a_seq = TK.linesearch_seq_cuda(*ls, 12, 16)
    a_7 = TK.linesearch_cuda(*ls, 12, 16)
    st = steps.float()
    same_bits("linesearch_cost alpha vs the sequential search's "
              "(linesearch_seq)", a_k, a_seq)
    log(f"  linesearch_cost Newton steps run per env min {int(st.min())} "
        f"mean {st.mean().item():.2f} max {int(st.max())}, "
        f"{int((steps == 16).sum())} of {B_CHUNK} envs all 16")
    same_bits("linesearch alpha vs the sequential search's (linesearch_seq)",
              a_7, a_seq)
    same_bits("linesearch alpha vs linesearch_cost's", a_7, a_k)
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

    # K7: the same search, alpha only (no cost pass, one output less);
    # alpha held at 2e-3 for the reason printed above for K5.
    record("linesearch", "mj_envs_tpu/physics/kernels.py:365",
           "mj_envs_torch/csrc/linesearch.cu",
           {"alpha": rel_err(a_7, TK.linesearch_plain(*ls, 12, 16))},
           time_ms(lambda: TK.linesearch_cuda(*ls, 12, 16), 50),
           time_ms(lambda: TK.linesearch_plain(*ls, 12, 16), 5),
           None, ls_bytes - B_CHUNK * F32,
           B_CHUNK * NEFC * (12 * 8 + 16 * 16), 2e-3)
    log(f"  linesearch_seq (the reference): "
        f"{time_ms(lambda: TK.linesearch_seq_cuda(*ls, 12, 16), 50):.4f} ms")

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

    # K6 with the empty contact slots of a real chunk (their A row and
    # column 0, r 0, gate 0): 96 of the 129 rows, as after a reset.
    ns_e = card(TK.random_noslip_problem(np.random.default_rng(5), B_CHUNK,
                                         R_NOSLIP, empty=96))
    u_e = TK.noslip_sweep_cuda(*ns_e, NOSLIP_ITERS, 0.0)
    rel, ab = rel_err(u_e, TK.noslip_sweep_plain(*ns_e, NOSLIP_ITERS))
    log(f"  noslip_sweep with 96 empty rows of 129: tol=0 vs plain "
        f"max_abs_err {ab:.3e} rel {rel:.3e} (tol 1e-5); kernel tol=0 "
        f"{time_ms(lambda: TK.noslip_sweep_cuda(*ns_e, NOSLIP_ITERS, 0.0), 20):.4f}"
        f" ms (no empty rows: {entries[-1]['ms']:.4f} ms)")
    check(rel <= 1e-5, "noslip_sweep with empty rows: kernel disagrees "
          f"with its plain version (rel {rel:.3e} > 1e-5)")
    check(bool((u_e[:, -96:] == 0).all()),
          "noslip_sweep moved an empty row")

    # K6 on the main path's own problem: the sweep problem of a real
    # 512-env hammer chunk; the bound counts the sweeps its envs ran.
    real = [t.contiguous() for t in real_noslip[:7]]
    B, R = real[5].shape
    u_k = TK.noslip_sweep_cuda(*real, NOSLIP_ITERS, 0.0)
    rel, ab = rel_err(u_k, TK.noslip_sweep_plain(*real, NOSLIP_ITERS))
    sweeps = torch.zeros(B, dtype=torch.int32, device=dev)
    TK.noslip_sweep_cuda(*real, NOSLIP_ITERS, 1e-3, sweeps=sweeps)
    rs = sweeps.float()
    ms_tol = time_ms(lambda: TK.noslip_sweep_cuda(*real, NOSLIP_ITERS, 1e-3),
                     20)
    ms_0 = time_ms(lambda: TK.noslip_sweep_cuda(*real, NOSLIP_ITERS, 0.0), 20)
    bms = bound(B * R * (R + 7) * F32,
                rs.sum().item() * R * (2 * R + 6))[0]
    log(f"  noslip_sweep on a real hammer chunk ({B} envs, R = {R}, reset "
        f"+ 1 step): tol=0 vs plain max_abs_err {ab:.3e} rel {rel:.3e} "
        f"(tol 1e-5); sweeps per env at tol=1e-3 min {int(rs.min())} mean "
        f"{rs.mean().item():.2f} max {int(rs.max())} (synthetic problem: "
        f"min {int(sw.min())} mean {sw.mean().item():.2f} max "
        f"{int(sw.max())}); kernel tol=1e-3 {ms_tol:.4f} ms, tol=0 "
        f"{ms_0:.4f} ms; bound at tol=1e-3 {bms * 1e3:.2f} us")
    check(rel <= 1e-5, "noslip_sweep on a real chunk: kernel disagrees "
          f"with its plain version (rel {rel:.3e} > 1e-5)")
    return entries


def kernel_digests(TK, dev, real_noslip):
    """Phase 3: SHA-256 of K2's factor, K8's X (R = 129 and 1), K7's
    alpha and K6's u and sweeps on phase 3's seeded problems (the same
    draws), and of the real chunk's A, so that two checkouts' kernels can
    be held bit for bit (`--digests`); with each call's time, to compare
    them in one run.  Only wrappers that every earlier checkout of the
    port has are called."""
    rng = np.random.default_rng(0)
    card = lambda xs: [torch.as_tensor(x).to(dev) for x in xs]
    H, g, G = card(TK.random_spd_problem(rng, B_CHUNK, NV, R_NOSLIP))
    g1 = g[..., None].contiguous()
    ls = card(TK.random_linesearch_problem(rng, B_CHUNK, NEFC))
    synthetic = card(TK.random_noslip_problem(rng, B_CHUNK, R_NOSLIP))
    real = [t.contiguous() for t in real_noslip[:7]]
    out = {"chol_factor fac": TK.chol_factor_cuda(H),
           "chol_solve_mat X, R 129": TK.chol_solve_mat_cuda(H, G),
           "chol_solve_mat X, R 1": TK.chol_solve_mat_cuda(H, g1),
           "linesearch alpha": TK.linesearch_cuda(*ls, 12, 16),
           "real hammer chunk A": real[0]}
    for name, fn in (
            ("chol_factor", lambda: TK.chol_factor_cuda(H)),
            ("chol_solve_mat R 129", lambda: TK.chol_solve_mat_cuda(H, G)),
            ("chol_solve_mat R 1", lambda: TK.chol_solve_mat_cuda(H, g1)),
            ("linesearch", lambda: TK.linesearch_cuda(*ls, 12, 16))):
        log(f"  time {name}: {time_ms(fn, 50):.4f} ms")
    for name, prob in (("synthetic", synthetic), ("real hammer chunk", real)):
        for tol in (0.0, 1e-3):
            sw = torch.zeros(prob[5].shape[0], dtype=torch.int32, device=dev)
            out[f"noslip_sweep u, {name}, tol {tol:g}"] = \
                TK.noslip_sweep_cuda(*prob, NOSLIP_ITERS, tol, sweeps=sw)
            out[f"noslip_sweep sweeps, {name}, tol {tol:g}"] = sw
            log(f"  time noslip_sweep {name} tol {tol:g}: "
                f"{time_ms(lambda: TK.noslip_sweep_cuda(*prob, NOSLIP_ITERS, tol), 20):.4f}"
                f" ms")
    torch.cuda.synchronize()
    for what, t in out.items():
        log(f"  sha256 {what}: "
            f"{hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()}")


def fk_flops(s):
    """float32 operations of one env's FK as csrc/fk.cu does them: a
    quaternion product 28, a rotation 30, a rotation matrix 30, a unit
    quaternion 13, sin and cos one each."""
    from mj_envs_torch.physics.model import JNT_HINGE, JNT_SLIDE
    jt = np.asarray(s.jnt_type)
    n_hinge = int((jt == JNT_HINGE).sum())
    n_slide = int((jt == JNT_SLIDE).sum())
    return ((s.nbody - 1) * (61 + 4)          # body offset; subtree sums
            + n_hinge * (176 + 12)            # hinge walk, anchor, axis; cdof
            + n_slide * 99                    # slide walk, anchor, axis
            + s.nbody * (66 + 4 + 192)        # frames, xipos; com; cinert
            + (s.ngeom + s.nsite) * 91)       # geom and site poses


def fk_bytes(K, m, B):
    """Bytes FK must move: qpos, each model field (per-env fields B
    times, shared ones once), the tree table, and the 13 outputs."""
    s = m.spec
    n = B * s.nq + K.fk_table(s).size
    for name in K.fk_field_shapes(s):
        n += getattr(m, name).numel()
    nb, nj, ng, ns = s.nbody, s.njnt, s.ngeom, s.nsite
    n += B * (nb * (3 + 4 + 9 + 3 + 3 + 36) + ng * 12 + ns * 12 + nj * 12)
    return n * F32


def compare_fk(envs, VectorEnv, apply_var, dev):
    """Phase 3, K1: the FK kernel against the plain version on each task's
    tree at B = 512, with the task's per-env fields from a reset (hammer's
    also with per-env body_mass and geom_pos, so that all five fields a
    task may vary arrive per env) and qpos0 + 0.3 N(0, 1).  Returns the
    JSON entry at hammer's shapes, the largest error over the tasks."""
    from mj_envs_torch.physics import kinematics as K
    rng = np.random.default_rng(1)
    worst, hammer = 0.0, None
    for task in TASKS:
        env = envs.make(task, device=dev)
        m = apply_var(env.model, VectorEnv(env, B_CHUNK).reset(seed=2).var)
        if task == "hammer-v0":
            m = m.replace(**{
                "body_mass": m.body_mass * torch.as_tensor(rng.uniform(
                    0.5, 2.0, (B_CHUNK,) + m.body_mass.shape),
                    dtype=torch.float32, device=dev),
                "geom_pos": m.geom_pos + 0.02 * torch.as_tensor(
                    rng.standard_normal((B_CHUNK,) + m.geom_pos.shape),
                    dtype=torch.float32, device=dev)})
        per_env = [f for f, shape in K.fk_field_shapes(m.spec).items()
                   if getattr(m, f).dim() > len(shape)]
        qpos = env.model.qpos0 + 0.3 * torch.as_tensor(
            rng.standard_normal((B_CHUNK, env.nq)), dtype=torch.float32,
            device=dev)
        k = K.kinematics(m, qpos)
        p = K.kinematics_plain(m, qpos)
        errs = []
        for f in K.Kin._fields:
            a, b = getattr(k, f), getattr(p, f)
            err = (a.double() - b.double()).abs().max().item()
            scale = max(1.0, b.abs().max().item())
            errs.append((err / scale, err, f))
        rel, err, field = max(errs)
        worst = max(worst, err)
        ms = time_ms(lambda: K.kinematics(m, qpos), 50)
        plain_ms = time_ms(lambda: K.kinematics_plain(m, qpos), 3, 1)
        bms, by = bound(fk_bytes(K, m, B_CHUNK),
                        B_CHUNK * fk_flops(env.spec))
        log(f"  fk {task} (per env: {', '.join(per_env)}): max_abs_err "
            f"{err:.3e} ({field}; {rel:.3e} of max(1, |x|), tol {FK_TOL:g}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bms * 1e3:.2f} us ({by})")
        log("    per field: " + ", ".join(f"{f} {e:.1e}" for _, e, f in errs))
        check(rel <= FK_TOL, f"fk {task} {field}: kernel disagrees with its "
              f"plain version ({rel:.3e} > {FK_TOL})")
        if task == "hammer-v0":
            hammer = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return dict(name="fk", route="cuda", source="mj_envs_torch/csrc/fk.cu",
                replaces="mj_envs_tpu/physics/fk_kernel.py:113", launches=0,
                max_abs_err=worst, library_ms=None, **hammer)


def hammer_chunk_noslip(envs, VectorEnv, random_actions, apply_var, dev):
    """Phase 3: the noslip sweep problem of one 512-env hammer chunk,
    reset and stepped once with seeded random actions."""
    from mj_envs_torch.stage_profile import noslip_problem_of
    env = envs.make("hammer-v0", device=dev)
    venv = VectorEnv(env, B_CHUNK)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = venv.step(venv.reset(seed=0),
                   random_actions(gen, B_CHUNK, env.nu, dev))
    return noslip_problem_of(apply_var(env.model, st.var), st.data,
                             st.data.ctrl)


def noslip_without_factor(TK, envs, apply_var, st, dev):
    """Phase 4: on a hammer card state, `solver.noslip` without the mass
    matrix's factor (K8 factors M itself) against noslip with it."""
    from mj_envs_torch.physics import pipeline as P
    from mj_envs_torch.physics import solver as S
    env = envs.make("hammer-v0", device=dev)
    m, d, s = apply_var(env.model, st.var), st.data, env.spec
    out = P.forward_core(m, d.qpos, d.qvel, d.ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    _, fac = TK.chol_solve_factor(out.M, out.qacc_smooth)
    res = S.newton_solve(out.M, out.qacc_smooth, out.rows, d.qacc_warmstart,
                         iterations=s.iterations)
    nfl, nc = int(np.sum(s.dof_hasfrictionloss)), P.ncmax(s)
    n0 = TK.launches["chol_solve_mat"]
    ns_mat = S.noslip(out.M, out.rows, res, nfl, nc, s.noslip_iterations)
    torch.cuda.synchronize()
    check(TK.launches["chol_solve_mat"] == n0 + 1,
          "noslip without a factor did not launch chol_solve_mat")
    ns_fac = S.noslip(out.M, out.rows, res, nfl, nc, s.noslip_iterations,
                      M_fac=fac)
    for f in ("qacc", "efc_force"):
        same_bits(f"noslip(M_fac=None) vs noslip(M_fac) {f}",
                  getattr(ns_mat, f), getattr(ns_fac, f))


KNOBS = ("MJE_NEWTON_TOL_SCALE", "MJE_NOSLIP_TOL", "MJE_FK_IMPL",
         "MJE_JBASE", "MJE_NO_FK_KERNEL")
F64_TOL = dict(rtol=1e-8, atol=1e-8)   # float64, card vs CPU, 2 steps


class knobs:
    """Set (value) or unset (None) environment variables inside a `with`
    block, restoring what was there after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_pair(envs, VectorEnv, task, devs, n=8, steps=2, dtype=torch.float32,
             seed=3):
    """`n` envs of `task` on each device of `devs`, reset on the first
    (the others get its state) and stepped `steps` times with the same
    seeded actions; the final states, in the order of `devs`."""
    states, st0 = [], None
    for dev in devs:
        env = envs.make(task, device=dev, dtype=dtype)
        venv = VectorEnv(env, n)
        st = venv.reset(seed=seed)          # seeds the reset generator
        st0 = st if st0 is None else st0
        st = st0.map(lambda x: x.to(env.device))
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            a = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, env.nu)),
                                dtype=dtype, device=env.device)
            st = venv.step(st, a)
        states.append(st)
    return states


def state_diff(a, b, tol, what):
    """Fail unless the states' obs, reward, qpos and qvel agree within
    `tol` (assert_close's rtol / atol); returns (max abs diff, largest
    share of the tolerance used, its field)."""
    worst, use = 0.0, (0.0, "")
    for name in ("obs", "reward", "qpos", "qvel"):
        src_a, src_b = (a.data, b.data) if name.startswith("q") else (a, b)
        x, y = getattr(src_a, name).cpu(), getattr(src_b, name).cpu()
        d = (x.double() - y.double()).abs()
        worst = max(worst, d.max().item())
        use = max(use, ((d / (tol["atol"] + tol["rtol"] * y.double().abs()))
                        .max().item(), name))
        torch.testing.assert_close(x, y, **tol, msg=lambda m: f"{what}: {m}")
    for name in ("done", "truncated", "nan_resets", "contact_clips"):
        check(torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()),
              f"{what}: {name} differs")
    return worst, use


def small_reference(envs, VectorEnv, dev, task, n=8, steps=2):
    """Phase 4: the card path against the CPU plain path from one state
    with the same actions (tolerances of tests/test_torch_hammer.py);
    returns the card state."""
    st_k, st_p = run_pair(envs, VectorEnv, task, (dev, "cpu"), n, steps)
    worst, use = state_diff(st_k, st_p, dict(rtol=1e-3, atol=2e-3),
                            f"{task} card vs CPU")
    log(f"  {task}: {n} envs x {steps} steps, card vs CPU: max abs diff "
        f"{worst:.3e}; largest share of the tolerance (rtol 1e-3, atol "
        f"2e-3) used: {use[0]:.3f} ({use[1]})")
    return st_k


def options_phase(TK, envs, VectorEnv, random_actions, apply_var, dev):
    """Phase 4b: float64 on the card (no kernel), MJE_JBASE=1,
    MJE_FK_IMPL=parallel, `set_physics_state`, each option's 512-env
    hammer step time beside the default's; every knob as it was after."""
    from mj_envs_torch.physics import kinematics as K
    before = {k: os.environ.get(k) for k in KNOBS}
    f32 = dict(rtol=1e-3, atol=2e-3)

    # float64: the plain versions on the card, no launch.
    TK.reset_launches()
    st_k, st_p = run_pair(envs, VectorEnv, "hammer-v0", (dev, "cpu"),
                          dtype=torch.float64)
    torch.cuda.synchronize()
    launched = {k: n for k, n in TK.launches.items() if n}
    worst, use = state_diff(st_k, st_p, F64_TOL, "float64 card vs CPU")
    log(f"  float64 hammer 8 envs x 2 steps, card vs CPU: max abs diff "
        f"{worst:.3e}; largest share of the tolerance (rtol "
        f"{F64_TOL['rtol']:g}, atol {F64_TOL['atol']:g}) used: {use[0]:.3f} "
        f"({use[1]}); kernel launches {launched or 0}")
    check(st_k.data.qpos.dtype == torch.float64, "float64 state changed dtype")
    check(not launched, f"a float64 step launched kernels: {launched}")

    # MJE_JBASE=1: card vs CPU with the knob, and against the card's
    # dense default.
    with knobs(MJE_JBASE="1"):
        TK.reset_launches()
        jb_k, jb_p = run_pair(envs, VectorEnv, "hammer-v0", (dev, "cpu"))
        torch.cuda.synchronize()
        jb_launches = dict(TK.launches)
    dense_k, = run_pair(envs, VectorEnv, "hammer-v0", (dev,))
    worst, use = state_diff(jb_k, jb_p, f32, "MJE_JBASE=1 card vs CPU")
    log(f"  MJE_JBASE=1 hammer 8 envs x 2 steps, card vs CPU: max abs diff "
        f"{worst:.3e}, share {use[0]:.3f} ({use[1]})")
    worst, use = state_diff(jb_k, dense_k, f32,
                            "MJE_JBASE=1 vs the dense default")
    log(f"  MJE_JBASE=1 vs the dense default on the card: max abs diff "
        f"{worst:.3e}, share {use[0]:.3f} ({use[1]}); launches "
        f"{json.dumps(jb_launches)}")
    for name in ("chol_solve_fac", "linesearch_cost", "noslip_sweep"):
        check(jb_launches[name] > 0, f"MJE_JBASE=1: {name} not launched")

    # MJE_FK_IMPL=parallel: the pointer-doubling FK against K1 on each
    # tree (phase 3's FK inputs and tolerance); with the knob a step
    # launches no fk.
    rng = np.random.default_rng(1)
    for task in TASKS:
        env = envs.make(task, device=dev)
        m = apply_var(env.model, VectorEnv(env, B_CHUNK).reset(seed=2).var)
        qpos = env.model.qpos0 + 0.3 * torch.as_tensor(
            rng.standard_normal((B_CHUNK, env.nq)), dtype=torch.float32,
            device=dev)
        k1, par = K.kinematics(m, qpos), K.kinematics_parallel(m, qpos)
        errs = []
        for f in K.Kin._fields:
            a, b = getattr(par, f), getattr(k1, f)
            e = (a.double() - b.double()).abs().max().item()
            errs.append((e / max(1.0, b.abs().max().item()), e, f))
        rel, e, field = max(errs)
        log(f"  kinematics_parallel vs fk (K1), {task}: max_abs_err {e:.3e}"
            f" ({field}; {rel:.3e} of max(1, |x|), tol {FK_TOL:g})")
        check(rel <= FK_TOL, f"kinematics_parallel {task} {field}: "
              f"{rel:.3e} > {FK_TOL}")
    with knobs(MJE_FK_IMPL="parallel"):
        TK.reset_launches()
        run_pair(envs, VectorEnv, "hammer-v0", (dev,), steps=1)
        torch.cuda.synchronize()
        par_launches = dict(TK.launches)
    log(f"  MJE_FK_IMPL=parallel step launches {json.dumps(par_launches)}")
    check(par_launches["fk"] == 0, "MJE_FK_IMPL=parallel launched fk")
    check(par_launches["linesearch_cost"] > 0,
          "MJE_FK_IMPL=parallel: the solver kernels did not run")

    # set_physics_state on the card against the CPU.
    env_k = envs.make("hammer-v0", device=dev)
    env_p = envs.make("hammer-v0", device="cpu")
    st_p = VectorEnv(env_p, 8).reset(seed=4)
    st_k = st_p.map(lambda x: x.to(dev))
    rng = np.random.default_rng(4)
    qpos = (st_p.data.qpos.numpy() + 0.05 * rng.standard_normal(
        (8, env_p.nq))).astype(np.float32)
    qvel = (0.5 * rng.standard_normal((8, env_p.nv))).astype(np.float32)
    out_k = env_k.set_physics_state(st_k, qpos, qvel)
    out_p = env_p.set_physics_state(st_p, qpos, qvel)
    got = env_k.get_env_state(out_k)
    check(np.array_equal(got["qpos"], qpos) and np.array_equal(
        got["qvel"], qvel), "get_env_state after set_physics_state")
    torch.testing.assert_close(out_k.obs.cpu(), out_p.obs, **f32)
    qa_k, qa_p = out_k.data.qacc.cpu().double(), out_p.data.qacc.double()
    share = ((qa_k - qa_p).abs().max() / qa_p.abs().max()).item()
    log(f"  set_physics_state hammer 8 envs, card vs CPU: obs max abs diff "
        f"{(out_k.obs.cpu() - out_p.obs).abs().max().item():.3e}; qacc max "
        f"abs diff {share:.3e} of its scale (tol 1e-3)")
    check(share <= 1e-3, "set_physics_state: card and CPU qacc differ")

    # Each option's 512-env hammer step time, beside the default's.
    def step_ms(reps=3):
        env = envs.make("hammer-v0", device=dev)
        venv = VectorEnv(env, B_CHUNK)
        gen = torch.Generator(device=dev).manual_seed(1)
        st = venv.step(venv.reset(seed=0),
                       random_actions(gen, B_CHUNK, env.nu, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            st = venv.step(st, random_actions(gen, B_CHUNK, env.nu, dev))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    times = {"default": step_ms()}
    for name, val in (("MJE_JBASE", "1"), ("MJE_FK_IMPL", "parallel")):
        with knobs(**{name: val}):
            times[f"{name}={val}"] = step_ms()
    times["default (again)"] = step_ms()
    for name, ms in times.items():
        log(f"  hammer {B_CHUNK}-env step, {name}: {ms:.1f} ms "
            f"(3 steps after one warm-up)")
    after = {k: os.environ.get(k) for k in KNOBS}
    log(f"  knobs before phase 5: {json.dumps(after)}")
    check(after == before, f"knobs not restored: {after} != {before}")
    return times


def main_path(TK, envs, VectorEnv, random_actions, dev, task, num_envs,
              chunk, steps):
    """Phase 5: reset and `steps` auto-reset steps of one task; returns
    the launch counts of the timed steps and env-steps/s."""
    env = envs.make(task, device=dev)
    venv = VectorEnv(env, num_envs, chunk_size=chunk)
    t0 = time.perf_counter()
    st = venv.reset(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    st = venv.step(st, random_actions(gen, num_envs, env.nu, dev))
    torch.cuda.synchronize()
    log(f"  {task}: reset + first step: {time.perf_counter() - t0:.2f} s")

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
    log(f"  {task}: {steps} steps x {num_envs} envs in {dt:.3f} s: "
        f"{steps * num_envs / dt:.1f} env-steps/s; nan_resets "
        f"{int(st.nan_resets.sum())}, contact_clips "
        f"{int(st.contact_clips.sum())}, mean Newton iterations per chunk "
        f"substep {launches['linesearch_cost'] / calls:.2f}")
    log(f"  {task}: launches: {json.dumps(launches)}")
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on {task}'s step")
    # FK runs once per substep and once in the in-step reset, per chunk.
    want = steps * nchunk * (env.FRAME_SKIP + 1)
    check(launches["fk"] == want,
          f"{task}: fk launched {launches['fk']} times, not {want}")
    return launches, steps * num_envs / dt


PPO_CONFIG = os.path.join("configs", "hammer_ppo.json")
# Phase 6's cuts of the config (length only; every width stays).
PPO_CUTS = dict(n_steps=8, max_episodes=2, checkpoint_interval=2)
EVAL_LENGTH, EVAL_COUNT = 5, 10
# Card vs CPU: one iteration of a small batch on the same draws.
PAIR_ENVS, PAIR_CFG = 8, dict(n_steps=2, n_minibatches=2, n_epochs=2,
                              hidden=(64, 64))
PAIR_TOL = dict(rtol=1e-3, atol=2e-3)     # phase 4's


def trainer_phase(TK, envs, dev, info):
    """Phase 6: `train_ppo_policy` on the card at the config's widths,
    then one small iteration card against CPU on the same randomness.
    Returns the launches of the training run (both iterations and the
    evaluation)."""
    import tempfile

    from mj_envs_torch.algos import networks as NN, ppo as PPO
    from mj_envs_torch.utils import checkpoint as CKPT, eval as EV
    from mj_envs_torch.utils import train as TT
    from mj_envs_torch.utils.config import PPOConfig

    config = PPOConfig().load(os.path.join(ROOT, PPO_CONFIG))
    full = {k: getattr(config, k) for k in PPO_CUTS}
    for k, v in PPO_CUTS.items():
        setattr(config, k, v)
    cfg = TT.ppo_config(config)
    env = envs.make(config.env_name, device=dev)
    log(f"[6] trainer: {PPO_CONFIG} {config.env_name}, num_envs "
        f"{config.num_envs}, hidden {cfg.hidden}, minibatches "
        f"{cfg.n_minibatches}, epochs {cfg.n_epochs}, chunk "
        f"{cfg.step_chunk}, float32; cuts: " + ", ".join(
            f"{k} {full[k]} -> {v}" for k, v in PPO_CUTS.items())
        + f"; eval once after training, {EVAL_COUNT} episodes of "
        f"{EVAL_LENGTH} steps (the config: 10 of {env.MAX_EPISODE_STEPS} "
        f"steps every {config.test_interval} iterations)")
    snaps, rows = [], []

    def on_iteration(episode, row):
        torch.cuda.synchronize()
        snaps.append(dict(TK.launches))
        rows.append(row)
        log(f"  iteration {episode}: {row['steps_per_s']:.1f} env-steps/s;"
            f" rollout {row['rollout_ms']:.1f} ms, GAE {row['gae_ms']:.2f}"
            f" ms, update {row['update_ms']:.1f} ms "
            f"({row['rollout_ms'] / (row['rollout_ms'] + row['gae_ms'] + row['update_ms']) * 100:.2f} % rollout); "
            f"mean_reward {row['mean_reward']:.4f}, pg_loss "
            f"{row['pg_loss']:.4f}, v_loss {row['v_loss']:.4f} ({info})")

    init_fn = PPO.make_ppo(env, config.num_envs, cfg, device=dev)[0]
    p0 = [t.detach().clone() for t in init_fn(config.seed).module.parameters()]
    with tempfile.TemporaryDirectory() as out:
        TK.reset_launches()
        t0 = time.perf_counter()
        ts, _ = TT.train_ppo_policy(config, env, out, callback=on_iteration)
        train_s = time.perf_counter() - t0

        def policy(module, obs, gen):
            return torch.clamp(module(obs)[0], -1.0, 1.0)

        t0 = time.perf_counter()
        res = EV.make_evaluate(env, policy, EVAL_LENGTH)(
            ts.module, config.seed + 2, count=EVAL_COUNT)
        eval_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(TK.launches)
        latest = CKPT.latest(out)
        check(latest == CKPT.checkpoint_path(out, 2),
              f"checkpoint: {latest}")
        back = CKPT.restore(latest, init_fn(config.seed + 99))
        same = all(torch.equal(a, b) for a, b in zip(
            back.module.parameters(), ts.module.parameters()))
        log(f"  checkpoint {os.path.basename(latest)} restored: params bit "
            f"for bit: {same}")
        check(same, "restore did not reproduce the params")
    one = {k: snaps[1][k] - snaps[0][k] for k in TK.KERNELS}
    log(f"  launches of iteration 2 ({cfg.n_steps} steps x "
        f"{config.num_envs // cfg.step_chunk} chunks x 5 substeps): "
        f"{json.dumps(one)}")
    for name in MAIN_KERNELS:
        check(one[name] > 0, f"kernel {name} was not launched by a PPO "
              "iteration")
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        check(not bad, f"non-finite metrics {bad}")
    moved = max((a - b).abs().max().item()
                for a, b in zip(ts.module.parameters(), p0))
    log(f"  training {train_s:.1f} s; params moved by up to {moved:.3e}; "
        f"eval {EVAL_COUNT} x {EVAL_LENGTH} steps in {eval_s:.1f} s: "
        f"reward {res.total_rewards.mean():.3f}, success "
        f"{res.success_rate:.1f} %")
    check(moved > 0, "the update did not move the params")
    check(res.obs.shape == (EVAL_COUNT, EVAL_LENGTH, env.OBS_DIM)
          and np.isfinite(res.obs).all()
          and np.isfinite(res.total_rewards).all(), "eval result")
    trainer_pair(envs, dev, config, PPO, NN)
    return launches


def trainer_pair(envs, dev, config, PPO, NN):
    """Phase 6, card vs CPU: one PPO iteration of PAIR_ENVS envs on each
    device from the same env state, weights, action noise and
    permutations; the transitions within PAIR_TOL, and the params after
    the update within the bound of Adam's steps."""
    cfg = PPO.PPOConfig(lr=config.learning_rate,
                        max_grad_norm=float(config.grad_clip_norm),
                        **PAIR_CFG)
    env_p = envs.make(config.env_name, device="cpu")
    env_k = envs.make(config.env_name, device=dev)
    gen = torch.Generator().manual_seed(7)
    st_p = env_p.reset(PAIR_ENVS, env_p.generator(7))
    mod_p = NN.ActorCritic(env_p.OBS_DIM, env_p.nu, cfg.hidden,
                           generator=gen, device="cpu")
    n = cfg.n_steps * PAIR_ENVS
    noise = torch.randn(cfg.n_steps, PAIR_ENVS, env_p.nu, generator=gen)
    perms = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(cfg.n_epochs)])
    out = {}
    for name, env, st in (("card", env_k, st_p.map(lambda x: x.to(dev))),
                          ("cpu", env_p, st_p)):
        mod = NN.actor_critic_from_numpy(NN.actor_critic_to_numpy(mod_p),
                                         device=env.device)
        ts = PPO.TrainState(mod, PPO.make_optimizer(mod, cfg),
                            torch.Generator(device=env.device),
                            env.generator(8))
        es, traj = PPO.make_rollout(env, cfg)(ts, st, noise.to(env.device))
        with torch.no_grad():
            last = mod(es.obs)[2]
        adv, ret = PPO._gae(cfg, traj, last)
        metrics = PPO._make_update(cfg)(ts, traj, adv, ret,
                                        perms.to(env.device))
        out[name] = (traj, adv, [t.detach().cpu() for t in mod.parameters()],
                     {k: float(v) for k, v in metrics.items()})
    (tk, ak, pk, mk), (tp, ap, pp, mp) = out["card"], out["cpu"]
    use, worst = (0.0, ""), 0.0
    for f in ("obs", "action", "log_prob", "value", "reward", "trunc_boot"):
        x, y = getattr(tk, f).cpu().double(), getattr(tp, f).double()
        d = (x - y).abs()
        worst = max(worst, d.max().item())
        use = max(use, ((d / (PAIR_TOL["atol"] + PAIR_TOL["rtol"] * y.abs()))
                        .max().item(), f))
        torch.testing.assert_close(x, y, **PAIR_TOL,
                                   msg=lambda m: f"trainer pair {f}: {m}")
    check(torch.equal(tk.done.cpu(), tp.done), "trainer pair: done differs")
    # Adam moves a parameter by at most ~lr a step whatever its gradient
    # (its first step is lr * sign(g)), so the two devices' params can
    # differ by at most 2 lr per update where a gradient component near 0
    # takes another sign.
    n_upd = cfg.n_epochs * cfg.n_minibatches
    p_bound = 2.0 * cfg.lr * n_upd
    p_err = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    moved = max((a - b).abs().max().item()
                for a, b in zip(pp, mod_p.parameters()))
    log(f"  card vs CPU, {PAIR_ENVS} envs x {cfg.n_steps} steps, "
        f"{cfg.n_epochs} x {cfg.n_minibatches} minibatches, same draws: "
        f"transitions max abs diff {worst:.3e}, largest share of the "
        f"tolerance (rtol 1e-3, atol 2e-3) used {use[0]:.3f} ({use[1]}); "
        f"advantages max abs diff {(ak.cpu() - ap).abs().max().item():.3e}"
        f"; params after the update max abs diff {p_err:.3e} (bound "
        f"2 lr x {n_upd} updates = {p_bound:.1e}, share used "
        f"{p_err / p_bound:.3f}; the update moved them by up to "
        f"{moved:.3e}); pg_loss {mk['pg_loss']:.6f} vs {mp['pg_loss']:.6f}")
    check(p_err <= p_bound, f"trainer pair: params differ by {p_err:.3e}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (the port's kernels need an "
                 "NVIDIA GPU)")
    import mj_envs_torch  # noqa: F401  (float32 matmul settings)
    from mj_envs_torch import envs
    from mj_envs_torch.envs.base import _apply_var
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

    real = hammer_chunk_noslip(envs, VectorEnv, random_actions, _apply_var,
                               dev)
    if "--digests" in sys.argv[1:]:
        log("[3] digests only:")
        kernel_digests(TK, dev, real)
        return
    log(f"[3] kernels vs plain versions at B = {B_CHUNK}:")
    entries = [compare_fk(envs, VectorEnv, _apply_var, dev)]
    entries += compare_kernels(TK, dev, real)
    kernel_digests(TK, dev, real)

    log("[4] small-input reference:")
    for task in TASKS:
        st = small_reference(envs, VectorEnv, dev, task)
        if task == "hammer-v0":
            noslip_without_factor(TK, envs, _apply_var, st, dev)

    log("[4b] options: float64, MJE_JBASE=1, MJE_FK_IMPL=parallel, "
        "set_physics_state:")
    options_phase(TK, envs, VectorEnv, random_actions, _apply_var, dev)

    log(f"[5] main path: {NUM_ENVS} envs, chunk {B_CHUNK}, each task:")
    rates, total = {}, dict.fromkeys(TK.KERNELS, 0)
    for task in TASKS:
        launches, rates[task] = main_path(
            TK, envs, VectorEnv, random_actions, dev, task, NUM_ENVS,
            B_CHUNK, STEPS[task])
        for name, n in launches.items():
            total[name] += n
    log(json.dumps({"env_steps_per_s": rates, "gpu": info}))

    trainer = trainer_phase(TK, envs, dev, info)
    for name, n in trainer.items():
        total[name] += n
    log(f"[7] launches: main path (phase 5) and trainer (phase 6) "
        f"together: {json.dumps(total)}")
    for e in entries:
        e["launches"] = total[e["name"]]

    log(info)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
