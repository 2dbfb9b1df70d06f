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
7. the learners, each at its config's widths and cut in length only:
   7a `configs/door_npg.json` through `train_npg_policy` (512 envs,
   policy (32, 32), CG 10; n_steps 64 -> 16, 2 iterations, a checkpoint
   at the second, one evaluation of 10 x 5 steps), then one DAPG
   iteration with 1024 synthetic demo pairs; 7b `configs/
   relocate_sac.json` through `train_sac_policy` (256 envs, nets
   (256, 256), buffer 100 000, batch 50, 16 steps and 16 updates; 2
   iterations, a checkpoint at the second); each iteration's env-steps/s
   and ms, iteration 2's launches, the checkpoint restored bit for bit;
   7c a synthetic mjrl-shaped DAPG pickle through the port's loader, its
   float64 numpy forward against `make_policy` on the card, and an
   evaluation of it on hammer; 7d one NPG iteration (64 door envs x 2
   steps, float32, and float64 twice on the card) and one SAC iteration
   (8 relocate envs x 2 steps, 2 updates) card vs CPU on the same state,
   weights and draws, stage by stage: NPG's advantages, g and a Fisher
   product on one shared trajectory, SAC's first-update losses and
   gradients on one shared ring, then each one's params;
8. the pixel path: 8a the renderer, 256 hammer envs after a reset and
   two random steps rendered 128x128 on the card and on the CPU from
   one state (at most 0.5 % of the pixels more than 1.0 apart), the ms
   of one 256-env chunk and a `torch.profiler` trace of one, the JAX
   package's golden image, and all four tasks at 8 envs; 8b `configs/hammer_ppo.json` with model_type "cnn"
   through `train_ppo_policy` (1024 envs, NatureCNN, chunk 512,
   pixel_chunk 256; n_steps 8, 2 iterations, a checkpoint at the second,
   one evaluation of 10 x 5 steps): each iteration's env-steps/s and its
   rollout (physics, render, policy) / GAE / update ms, iteration 2's
   launches, the checkpoint restored bit for bit; 8c
   `configs/hammer_planet.json` at its full widths through
   `train_planet_policy` (30-step rollouts, 2 seed episodes, one
   training episode of 4 updates at batch 50 x chunk 50 and a 30-step
   collect of single-env steps planned by CEM 1000 / 100 / 10 / 12):
   update ms, plan ms a step, collect env-steps/s, the episode's
   launches (B = 1), the checkpoint restored bit for bit, an evaluation
   of the loaded params on 2 envs x 3 steps.  Then card vs CPU: one
   pixel-PPO rollout of 8 envs x 2 steps on the same draws and its
   update on one shared trajectory (float32, float64), one PlaNet update
   on a synthetic batch (float32: losses, gradients; float64: params),
   the float64 planner's top-k sets, and one hammer step at B = 1;
9. the CLIs and the distributed runtime, on hammer-v0: 9a `run_eval`
   with the DAPG policy of a synthetic mjrl pickle and with phase 6's
   PPO checkpoint (1 episode of 10 envs, cut to 10 steps), its gif and
   plots decoded, the worst trajectory's first frames card vs CPU
   (phase 8a's pixel share); 9b one `visualize` episode of the pickle's
   policy (cut to 10 steps); 9c a headless `InteractiveViewer` (Agg)
   for 3 steps, its frame card vs CPU; 9d the second of two env shards
   (rows [2048, 4096) of 4096, its generator skipping the first shard's
   reset draws) against those rows of the plain VectorEnv bit for bit,
   with no process group, through a reset and a step that resets
   every env; then a one-rank NCCL group from torchrun's
   variables (`parallel/distributed.initialize`):
   `VectorEnv(mesh=make_mesh())` at 4096 envs, chunk 512, 2 steps,
   against the same VectorEnv without a mesh bit for bit, the two rates
   side by side, then `dryrun_multichip(1)`; the group torn down.  Each
   of 9a-9d runs with the launch counts at 0 and must launch K1-K6;
   then the `[9] launches` line, phases 5-9 together, one JSON line
   listing the kernels, and the device line.

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


# The float32 adds, multiplies, divides and square roots of one instance
# on each narrowphase kernel's costliest path, counted from
# csrc/narrow_cyl.cu and csrc/narrow_plain.cu: the generic convex contact
# (48 projection rounds, 1 + K support gaps, 24 polish steps, 3 support
# points) and its set-up; capsule-cylinder's 67 point distances and its
# two contacts; the four rim points of plane-cylinder; box-box's 15
# separating axes (654) and one face clipping (2,996, its 276-pair
# duplicate test 1,380 of them); capsule-box's 12-step fixed point and
# three sphere-box contacts; capsule-capsule's two segment contacts; the
# corners and ends of plane-box and plane-capsule.  A cap, side,
# standing, lying or edge instance takes fewer, so the bound below is the
# most these inputs need.
NARROW_FLOPS = {"narrow_plane_cylinder": 141,
                "narrow_capsule_cylinder": 3590,
                "narrow_cylinder_cylinder": 8289,
                "narrow_cylinder_box": 8234,
                "narrow_plane_capsule": 44,
                "narrow_plane_box": 277,
                "narrow_capsule_capsule": 206,
                "narrow_capsule_box": 572,
                "narrow_box_box": 3650}


def narrow_source(name):
    """The kernel source whose `NARROW_ENTRY` line defines entry point
    `name`."""
    from mj_envs_torch.physics import _build
    for f in _build.SOURCES:
        with open(os.path.join(_build.CSRC, f)) as fh:
            if f"NARROW_ENTRY({name}," in fh.read():
                return f"mj_envs_torch/csrc/{f}"
    raise LookupError(f"no NARROW_ENTRY for {name}")


def compare_narrow(envs, VectorEnv, random_actions, dev):
    """Phase 3, the narrowphase kernels: each entry point on its group of
    a real 512-env hammer chunk (a reset and two random steps), bit for
    bit against the plain function on the card; kernel and plain ms (CUDA
    events behind the spin kernel), and the bound: each distinct geom's
    pose read once per env, the sizes, geom ids and margins once, each
    candidate's dist, pos and nrm written once.  Returns the JSON
    entries."""
    from mj_envs_torch.physics.collision import driver as C
    from mj_envs_torch.physics.collision import narrow_cuda as NC
    env = envs.make("hammer-v0", device=dev)
    venv = VectorEnv(env, B_CHUNK)
    gen = torch.Generator(device=dev).manual_seed(3)
    st = venv.reset(seed=0)
    for _ in range(2):
        st = venv.step(st, random_actions(gen, B_CHUNK, env.nu, dev))
    s = env.spec
    xpos, xmat = st.data.geom_xpos, st.data.geom_xmat
    size = env.model.geom_size
    entries = []
    for key, pids in C._groups(s):
        if key not in NC.KERNELS:
            continue
        name, nc = NC.KERNELS[key]
        g1, g2, marg = NC.group_tables(env.model, pids)

        def kernel():
            return NC.narrow_cuda(key, xpos, xmat, size, g1, g2, marg)

        def plain():
            return C.plain_group(key, xpos, xmat, size.expand(B_CHUNK, -1, -1),
                                 g1.long(), g2.long(), marg)
        for what, a, b in zip(("dist", "pos", "nrm"), kernel(), plain()):
            same_bits(f"{name} ({len(pids)} pairs) {what} vs the plain "
                      f"function", a, b)
        geoms = len(set(s.pair_geom1[pids]) | set(s.pair_geom2[pids]))
        nbytes = (B_CHUNK * geoms * 12 + geoms * 3 + 3 * len(pids)
                  + B_CHUNK * len(pids) * nc * 7) * F32
        bms, by = bound(nbytes, B_CHUNK * len(pids) * NARROW_FLOPS[name])
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(plain, 3, 1)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library -, bound {bms * 1e3:.2f} us ({by})")
        entries.append(dict(
            name=name, route="cuda", source=narrow_source(name),
            replaces="none (the JAX package's narrowphase, XLA-fused)",
            launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, library_ms=None))
    return entries


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
PPO_KEPT = "ppo_ckpt_00000002.pt"     # phase 6's checkpoint, for phase 9
# Phase 6's cuts of the config (length only; every width stays).
PPO_CUTS = dict(n_steps=8, max_episodes=2, checkpoint_interval=2)
EVAL_LENGTH, EVAL_COUNT = 5, 10
# Card vs CPU: one iteration of a small batch on the same draws.
PAIR_ENVS, PAIR_CFG = 8, dict(n_steps=2, n_minibatches=2, n_epochs=2,
                              hidden=(64, 64))
PAIR_TOL = dict(rtol=1e-3, atol=2e-3)     # phase 4's


def trainer_phase(TK, envs, dev, info, keep):
    """Phase 6: `train_ppo_policy` on the card at the config's widths,
    then one small iteration card against CPU on the same randomness.
    Its last checkpoint is copied to `keep` (PPO_KEPT; phase 9
    evaluates it).  Returns the launches of the training run (both
    iterations and the evaluation)."""
    import shutil
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
        shutil.copy(latest, os.path.join(keep, PPO_KEPT))
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


def _pair_fields(a, b, fields, what):
    """Each field of `a` (card) against `b` (CPU) within PAIR_TOL, the
    done flags equal: (max abs diff, (largest share of the tolerance, its
    field))."""
    use, worst = (0.0, ""), 0.0
    for f in fields:
        x, y = a[f], b[f]
        if f == "done":
            check(torch.equal(x, y), f"{what}: {f} differs")
            continue
        d = (x - y).abs()
        worst = max(worst, d.max().item())
        use = max(use, ((d / (PAIR_TOL["atol"] + PAIR_TOL["rtol"] * y.abs()))
                        .max().item(), f))
        torch.testing.assert_close(x, y, **PAIR_TOL,
                                   msg=lambda m: f"{what} {f}: {m}")
    return worst, use


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
    fields = ("obs", "action", "log_prob", "value", "reward", "trunc_boot",
              "done")
    worst, use = _pair_fields(
        {f: getattr(tk, f).cpu().double() for f in fields},
        {f: getattr(tp, f).double() for f in fields}, fields, "trainer pair")
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


NPG_CONFIG = os.path.join("configs", "door_npg.json")
SAC_CONFIG = os.path.join("configs", "relocate_sac.json")
# Phase 7's cuts (length only; every width stays).  door_npg.json sets no
# n_steps: the JAX trainer's default, 64, is cut to 16.
NPG_CUTS = dict(n_steps=16, max_episodes=2, checkpoint_interval=2)
SAC_CUTS = dict(max_episodes=2, checkpoint_interval=2)
DEMO_PAIRS, DEMO_SEED, DAPG_SEED = 1024, 5, 3
# Card vs CPU: one iteration of a small batch on the same draws.  NPG:
# 64 door envs x 2 steps (128 rows, more than the baseline's 82
# features); SAC: 8 relocate envs x 2 steps, 2 updates at batch 8.
NPG_PAIR_ENVS, NPG_PAIR_STEPS, LEARNER_PAIR_ENVS = 64, 2, 8
SAC_PAIR_CFG = dict(steps_per_iter=2, updates_per_iter=2, batch_size=8,
                    warmup_steps=0, buffer_size=64)
# The bounds of the card-vs-CPU pairs, each 4x the worst over seeds 0-2
# of its reading on the CPU (`python tests/measure_torch_learner_floors.py
# npg_pair sac_pair`): in float32 the CPU's float32-vs-float64 gap of the
# same iteration, in float64 the largest change that another sum order on
# the CPU makes (the baseline solved by Cholesky or with its columns
# reversed, the CG's dot products reversed, the Fisher's rows permuted).
# `npg_diffs` / `sac_diffs` name the quantities.  The 10-step CG on the
# damped Fisher turns a change in the last bit of g into 1e-6 to 1e-3 of
# the step (float64, the CPU alone), so what comes before the CG (the
# advantages, g, one Fisher product) is where a fault would show sharply.
NPG_PAIR_BOUNDS = {
    # readings: adv 5.48e-5, g 1.29e-4, fvp 1.64e-4, params 0.450 (the
    # step moves them by up to 2.0: a sanity bound only)
    torch.float32: dict(adv=2.2e-4, g=5.2e-4, fvp=6.6e-4, params=1.8),
    # readings: adv 5.01e-14, g 8.95e-14, fvp 1.36e-13, params 1.70e-3
    # (float32's gap in the params is 5.0e-2 to 0.45)
    torch.float64: dict(adv=2.0e-13, g=3.6e-13, fvp=5.4e-13, params=6.8e-3),
}
# readings: critic_loss 3.43e-7, actor_loss 1.74e-7, critic_grad 2.90e-7,
# actor_grad 1.53e-6, alpha_grad 3.24e-8, params 6.41e-5 (Adam's own
# bound, 2 lr x 2 updates, is 1.2e-3)
SAC_PAIR_BOUNDS = dict(critic_loss=1.4e-6, actor_loss=7.0e-7,
                       critic_grad=1.2e-6, actor_grad=6.1e-6,
                       alpha_grad=1.3e-7, params=2.6e-4)


def _same_tree(a, b) -> bool:
    """Two `checkpoint._state_dict` trees equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def learner_config(name, cuts):
    """A committed config with `cuts` applied: (config, the cut fields'
    values before)."""
    from mj_envs_torch.utils.config import Config
    config = Config().load(os.path.join(ROOT, name))
    full = {k: getattr(config, k, None) for k in (*cuts, "test_interval")}
    for k, v in cuts.items():
        setattr(config, k, v)
    config.test_interval = config.max_episodes + 1   # eval below, once
    return config, full


def learner_run(TK, train, config, env, out, line, **kw):
    """`train(config, env, out)` with a callback that prints `line(row)`
    and snapshots the launch counts after each iteration: (state, rows,
    launches of the last iteration, seconds).  A first iteration's
    launches count from the call (PlaNet's include its replay seeding)."""
    torch.cuda.synchronize()
    snaps, rows = [dict(TK.launches)], []

    def on_iteration(episode, row):
        torch.cuda.synchronize()
        snaps.append(dict(TK.launches))
        rows.append(row)
        log(f"  iteration {episode}: {row['steps_per_s']:.1f} env-steps/s; "
            + line(row))

    t0 = time.perf_counter()
    st, _ = train(config, env, out, callback=on_iteration, **kw)
    secs = time.perf_counter() - t0
    last = {k: snaps[-1][k] - snaps[-2][k] for k in TK.KERNELS}
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        check(not bad, f"non-finite metrics {bad}")
    return st, rows, last, secs


def check_launches(TK, one, what):
    log(f"  launches of {what}: {json.dumps(one)}")
    for name in MAIN_KERNELS:
        check(one[name] > 0, f"kernel {name} was not launched by {what}")


def check_restore(CKPT, out, step, fresh, state, what):
    latest = CKPT.latest(out)
    check(latest == CKPT.checkpoint_path(out, step), f"checkpoint: {latest}")
    back = CKPT.restore(latest, fresh)
    same = _same_tree(CKPT._state_dict(back), CKPT._state_dict(state))
    log(f"  checkpoint {os.path.basename(latest)} restored: {what} bit for "
        f"bit: {same}")
    check(same, f"restore did not reproduce the {what}")


def npg_phase(TK, envs, dev, info, tmp):
    """Phase 7a: `configs/door_npg.json` through `train_npg_policy` at
    full width, then one DAPG iteration with synthetic demos."""
    from mj_envs_torch.algos import npg as NPG
    from mj_envs_torch.utils import checkpoint as CKPT, eval as EV
    from mj_envs_torch.utils import train as TT

    config, full = learner_config(NPG_CONFIG, NPG_CUTS)
    full["n_steps"] = full["n_steps"] or NPG.NPGConfig().n_steps
    cfg = TT.npg_config(config)
    env = envs.make(config.env_name, device=dev)
    log(f"[7a] NPG: {NPG_CONFIG} {config.env_name}, num_envs "
        f"{config.num_envs} (chunks of {NPG.STEP_CHUNK}), policy "
        f"{cfg.hidden}, CG {cfg.cg_iters} steps, gamma {cfg.gamma}, lambda "
        f"{cfg.gae_lambda}, delta {cfg.normalized_step_size}, float32; cuts: "
        + ", ".join(f"{k} {full[k]} -> {v}" for k, v in NPG_CUTS.items())
        + f"; eval once after training, {EVAL_COUNT} episodes of "
        f"{EVAL_LENGTH} steps (the config: 10 of {env.MAX_EPISODE_STEPS} "
        f"steps every {full['test_interval']} iterations)")
    init_fn = NPG.make_npg(env, config.num_envs, cfg, device=dev)[0]
    p0 = [t.detach().clone() for t in init_fn(config.seed).module.parameters()]

    def line(r):
        return (f"rollout {r['rollout_ms']:.1f} ms, update "
                f"{r['update_ms']:.1f}"
                f" ms (baseline fit and GAE {r['baseline_ms']:.1f}, gradient "
                f"{r['gradient_ms']:.1f}, CG and step {r['cg_ms']:.1f}); "
                f"step_size {r['step_size']:.4e}, kl {r['kl']:.4e}, quad "
                f"{r['quad']:.4e}"
                f", grad_norm {r['grad_norm']:.4e}, mean_reward "
                f"{r['mean_reward']:.4f} ({info})")

    out = os.path.join(tmp, "npg")
    st, rows, one, secs = learner_run(TK, TT.train_npg_policy, config, env,
                                      out, line)
    check_launches(TK, one, f"NPG iteration 2 ({cfg.n_steps} steps x "
                   f"{max(1, config.num_envs // NPG.STEP_CHUNK)} chunk x "
                   f"{env.FRAME_SKIP} substep)")
    check_restore(CKPT, out, 2, init_fn(config.seed + 99), st,
                  "policy, iteration and generators")
    moved = max((a - b).abs().max().item()
                for a, b in zip(st.module.parameters(), p0))
    t0 = time.perf_counter()
    res = EV.make_evaluate(
        env, lambda m, obs, g: torch.clamp(m(obs)[0], -1.0, 1.0),
        EVAL_LENGTH)(st.module, config.seed + 2, count=EVAL_COUNT)
    eval_s = time.perf_counter() - t0
    log(f"  training {secs:.1f} s; params moved by up to {moved:.3e}; eval "
        f"{EVAL_COUNT} x {EVAL_LENGTH} steps in {eval_s:.1f} s: reward "
        f"{res.total_rewards.mean():.3f}, success {res.success_rate:.1f} %")
    check(moved > 0 and all(r["step_size"] > 0 for r in rows),
          "the NPG step did not move the params")
    check(res.obs.shape == (EVAL_COUNT, EVAL_LENGTH, env.OBS_DIM)
          and np.isfinite(res.obs).all()
          and np.isfinite(res.total_rewards).all(), "NPG eval result")

    # DAPG: the same trainer with demos, one iteration.
    gen = torch.Generator(device=dev).manual_seed(DEMO_SEED)
    demo_obs = env.reset(DEMO_PAIRS, gen).obs
    demos = {"obs": demo_obs + 0.01 * torch.randn(
        demo_obs.shape, generator=gen, device=dev),
        "actions": 2.0 * torch.rand(DEMO_PAIRS, env.nu, generator=gen,
                                    device=dev) - 1.0}
    config.max_episodes, config.checkpoint_interval = 1, 2
    demo_w = (torch.tensor(cfg.lam1, dtype=torch.float32) ** 0.0
              * cfg.lam0).item()
    log(f"  DAPG: {DEMO_PAIRS} synthetic demo pairs (door reset obs + "
        f"0.01 N(0, 1), actions U(-1, 1), seed {DEMO_SEED}), demo weight "
        f"lam0 * lam1^k = {cfg.lam0} * {cfg.lam1}^0 = {demo_w:.6g}:")
    st_d, _, _, secs_d = learner_run(TK, TT.train_npg_policy, config, env,
                                     os.path.join(tmp, "dapg"), line,
                                     demos=demos)
    check(st_d.iteration == 1, "DAPG iteration count")
    log(f"  DAPG iteration in {secs_d:.1f} s")


def sac_phase(TK, envs, dev, info, tmp):
    """Phase 7b: `configs/relocate_sac.json` through `train_sac_policy`
    at full width."""
    from mj_envs_torch.algos import sac as SAC
    from mj_envs_torch.utils import checkpoint as CKPT
    from mj_envs_torch.utils import train as TT

    config, full = learner_config(SAC_CONFIG, SAC_CUTS)
    cfg = TT.sac_config(config)
    env = envs.make(config.env_name, device=dev)
    log(f"[7b] SAC: {SAC_CONFIG} {config.env_name}, num_envs "
        f"{config.num_envs}, nets {cfg.hidden}, buffer {cfg.buffer_size}, "
        f"batch {cfg.batch_size} (the Config's batch_size, as the JAX "
        f"trainer reads it), steps_per_iter {cfg.steps_per_iter}, "
        f"updates_per_iter {cfg.updates_per_iter}, warm-up "
        f"{cfg.warmup_steps} env steps, lr {cfg.lr}, float32; cuts: "
        + ", ".join(f"{k} {full[k]} -> {v}" for k, v in SAC_CUTS.items())
        + f"; no eval (the config: every {full['test_interval']} "
        "iterations)")
    init_fn = SAC.make_sac(env, config.num_envs, cfg, device=dev)[0]
    p0 = [t.detach().clone() for t in init_fn(config.seed).actor.parameters()]

    def line(r):
        return (f"collect {r['collect_ms']:.1f} ms, update "
                f"{r['update_ms']:.1f}"
                f" ms; replay_size {r['replay_size']:.0f}, alpha "
                f"{r['alpha']:.6f}, critic_loss {r['critic_loss']:.4f}, "
                f"actor_loss {r['actor_loss']:.4f}, mean_reward "
                f"{r['mean_reward']:.4f} ({info})")

    out = os.path.join(tmp, "sac")
    st, rows, one, secs = learner_run(TK, TT.train_sac_policy, config, env,
                                      out, line)
    check_launches(TK, one, f"SAC iteration 2 ({cfg.steps_per_iter} steps "
                   f"x 1 chunk x {env.FRAME_SKIP} substeps)")
    check_restore(CKPT, out, 2, init_fn(config.seed + 99), st,
                  "nets, optimizers, log_alpha, replay ring and env steps")
    moved = max((a - b).abs().max().item()
                for a, b in zip(st.actor.parameters(), p0))
    log(f"  training {secs:.1f} s; actor moved by up to {moved:.3e}; env "
        f"steps {st.env_steps}, ring head {st.replay.idx}, size "
        f"{st.replay.size}")
    check(moved > 0 and rows[-1]["critic_loss"] > 0, "SAC did not update")


def dapg_policy_phase(TK, envs, dev, info, tmp):
    """Phase 7c: a synthetic mjrl-shaped pickle loaded by the port's
    loader, its numpy forward against `make_policy` on the card, and an
    evaluation of it on hammer."""
    from mj_envs_torch.algos import dapg as DAPG
    from mj_envs_torch.utils import eval as EV

    path = write_mjrl_pickle(os.path.join(tmp, "hammer-v0.pickle"),
                             DAPG_SEED)
    act, params = DAPG.load_policy("hammer", device=dev, root=tmp)
    obs = np.random.default_rng(DAPG_SEED).standard_normal((512, 46))
    x = (obs - params["in_shift"]) / (params["in_scale"] + 1e-8)
    for w, b in params["layers"][:-1]:
        x = np.tanh(x @ w.T + b)
    w, b = params["layers"][-1]
    want = (x @ w.T + b) * params["out_scale"] + params["out_shift"]
    got = act(torch.as_tensor(obs, dtype=torch.float32, device=dev))
    rel, err = rel_err(got.cpu(), torch.as_tensor(want))
    log(f"[7c] DAPG policy: {os.path.basename(path)} (46 -> 32 -> 32 -> 26, "
        f"tanh, seed {DAPG_SEED}) through load_dapg_params; make_policy on "
        f"the card vs its numpy float64 forward, 512 obs: {rel:.3e} rel "
        f"(max abs {err:.3e}; tolerance 1e-5 rel)")
    check(rel <= 1e-5, f"DAPG policy: {rel:.3e} rel")
    env = envs.make("hammer-v0", device=dev)
    t0 = time.perf_counter()
    res = EV.make_evaluate(env, EV.dapg_policy_apply(act), EVAL_LENGTH)(
        None, 0, count=EVAL_COUNT)
    log(f"  eval on hammer-v0, {EVAL_COUNT} x {EVAL_LENGTH} steps in "
        f"{time.perf_counter() - t0:.1f} s: reward "
        f"{res.total_rewards.mean():.3f}, success {res.success_rate:.1f} %")
    check(np.isfinite(res.obs).all() and np.isfinite(res.total_rewards).all()
          and res.obs.shape == (EVAL_COUNT, EVAL_LENGTH, env.OBS_DIM),
          "DAPG eval result")


def npg_pair(envs, devices, dtype=torch.float32, seed=0,
             n=NPG_PAIR_ENVS, steps=NPG_PAIR_STEPS):
    """One NPG iteration of `n` door envs x `steps` steps on each of
    `devices` in turn, in `dtype`, from the same env state, weights and
    action normals (made in float64 on the CPU and cast).  Each run holds
    its trajectory, advantages, g, quad, step size and params after; and
    "same", the update's advantages and g from the last run's trajectory
    and F g at the old params on its observations and g (the same inputs
    on every device).  Returns (runs, params before)."""
    from mj_envs_torch.algos import npg as NPG
    cfg = NPG.NPGConfig(n_steps=steps)
    env64 = envs.make("door-v0", device="cpu", dtype=torch.float64)
    st64 = env64.reset(n, env64.generator(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    mod64 = NPG.NPGPolicy(env64.OBS_DIM, env64.nu, cfg.hidden,
                          cfg.init_log_std, generator=gen, device="cpu",
                          dtype=torch.float64)
    noise = torch.randn(steps, n, env64.nu, generator=gen,
                        dtype=torch.float64)
    old = NPG.npg_params_to_numpy(mod64)
    out = lambda x: x.detach().cpu().double()
    runs = []
    for d in devices:
        env = envs.make("door-v0", device=d, dtype=dtype)
        cast = lambda x: (x.to(dtype) if x.is_floating_point() else x).to(d)
        mod = NPG.npg_params_from_numpy(old, device=d, dtype=dtype)
        _, it, _ = NPG.make_npg(env, n, cfg, device=d)
        state = NPG.NPGState(mod, 0, torch.Generator(device=d),
                             env.generator(seed + 2))
        ex = {}
        _, es, m = it(state, st64.map(cast), noise=cast(noise), extras=ex)
        traj = NPG.Transition(*(x.cpu() for x in ex["trajectory"]))
        runs.append(dict(
            traj={f: out(getattr(traj, f))
                  for f in ("obs", "action", "reward", "final_obs", "done")},
            adv=out(ex["advantages"]), g=out(ex["g"]),
            params=[out(p) for p in mod.parameters()],
            metrics={k: float(v) for k, v in m.items()}))
    ref_es = es.map(lambda x: x.cpu())
    for d, r in zip(devices, runs):
        cast = lambda x: (x.to(dtype) if x.is_floating_point() else x).to(d)
        ex = {}
        NPG.update(cfg, NPG.npg_params_from_numpy(old, d, dtype),
                   NPG.Transition(*(cast(x) for x in traj)), ref_es.map(cast),
                   extras=ex)
        fvp = NPG.make_fisher_vp(NPG.npg_params_from_numpy(old, d, dtype),
                                 cast(traj.obs.reshape(-1, env64.OBS_DIM)),
                                 cfg.cg_damping)
        r["same"] = dict(adv=out(ex["advantages"]), g=out(ex["g"]),
                         fvp=out(fvp(runs[-1]["g"].to(d, dtype))))
    return runs, [p.detach().clone() for p in mod64.parameters()]


def npg_diffs(a, b, before):
    """Run `a` against run `b` of `npg_pair`, stage by stage: the
    transitions (max abs); max |a - b| / max |b| of each run's own
    advantages and g (iter_adv, iter_g), and of the advantages, g and
    F g from the same trajectory (adv, g, fvp); quad and the step size
    relative; the params after (max abs), and how far the step moved
    `b`'s."""
    ma, mb = a["metrics"], b["metrics"]
    same = {k: rel_err(a["same"][k], b["same"][k])[0]
            for k in ("adv", "g", "fvp")}
    return dict(
        transitions=max((a["traj"][f] - b["traj"][f]).abs().max().item()
                        for f in ("obs", "action", "reward", "final_obs")),
        iter_adv=rel_err(a["adv"], b["adv"])[0],
        iter_g=rel_err(a["g"], b["g"])[0], **same,
        quad=abs(ma["quad"] / mb["quad"] - 1.0),
        step=abs(ma["step_size"] / mb["step_size"] - 1.0),
        params=max((x - y).abs().max().item()
                   for x, y in zip(a["params"], b["params"])),
        moved=max((x - y).abs().max().item()
                  for x, y in zip(b["params"], before)))


def sac_pair(envs, devices, dtype=torch.float32, seed=0,
             n=LEARNER_PAIR_ENVS):
    """One SAC iteration (`SAC_PAIR_CFG`: 2 collect steps, 2 updates at
    batch 8, no warm-up) of `n` relocate envs on each of `devices` in
    turn, in `dtype`, from the same env state, weights and draws: per run
    the ring's contents, the params after and the metrics; and "first",
    the first update's losses and gradients (critic, actor, log_alpha)
    before its Adam steps, from the initial weights on the last run's
    ring (the same inputs on every device)."""
    from mj_envs_torch.algos import sac as SAC
    cfg = SAC.SACConfig(**SAC_PAIR_CFG)
    env_p = envs.make("relocate-v0", device="cpu", dtype=torch.float64)
    st_p = env_p.reset(n, env_p.generator(seed))
    params = SAC.sac_params_to_numpy(
        SAC.make_sac(env_p, n, cfg, device="cpu")[0](seed))
    gen = torch.Generator().manual_seed(seed + 1)
    S, U, nb, nu = cfg.steps_per_iter, cfg.updates_per_iter, \
        cfg.batch_size, env_p.nu
    draws = dict(policy=torch.randn(S, n, nu, generator=gen),
                 uniform=2.0 * torch.rand(S, n, nu, generator=gen) - 1.0,
                 sel=torch.randint(0, S * n, (U, nb), generator=gen),
                 next=torch.randn(U, nb, nu, generator=gen),
                 actor=torch.randn(U, nb, nu, generator=gen))
    draws = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in draws.items()}
    fields = ("obs", "action", "reward", "next_obs", "done")
    runs = []
    for d in devices:
        env = envs.make("relocate-v0", device=d, dtype=dtype)
        cast = lambda x: (x.to(dtype) if x.is_floating_point() else x).to(d)
        init_fn, it, _ = SAC.make_sac(env, n, cfg, device=d)
        st = SAC.sac_params_from_numpy(init_fn(seed), params)
        st, _, m = it(st, st_p.map(cast), draws=draws)
        k = st.replay.size
        runs.append(dict(
            ring={f: getattr(st.replay, f)[:k].detach().cpu().double()
                  for f in fields},
            params=[t.detach().cpu().double() for mod in
                    (st.actor, st.critic, st.target_critic)
                    for t in mod.parameters()]
            + [st.log_alpha.detach().cpu().double()],
            metrics={k: float(v) for k, v in m.items()}))
    ring = runs[-1]["ring"]
    for d, r in zip(devices, runs):
        init_fn = SAC.make_sac(envs.make("relocate-v0", device=d,
                                         dtype=dtype), n, cfg, device=d)[0]
        st = SAC.sac_params_from_numpy(init_fn(seed), params)
        st.replay.store(*(ring[f].to(d, dtype) if f != "done"
                          else ring[f].to(d, torch.bool) for f in fields))
        m = SAC._update_once(cfg, st, draws["sel"][0].to(d),
                             draws["next"][0].to(d), draws["actor"][0].to(d))
        grad = lambda mod: torch.cat([p.grad.reshape(-1) for p in
                                      mod.parameters()]).cpu().double()
        r["first"] = dict(critic_loss=float(m["critic_loss"]),
                          actor_loss=float(m["actor_loss"]),
                          critic_grad=grad(st.critic),
                          actor_grad=grad(st.actor),
                          alpha_grad=st.log_alpha.grad.cpu().double())
    return runs, cfg


def sac_diffs(a, b):
    """Run `a` against run `b` of `sac_pair`: the ring (max abs); the
    first update's losses relative and its gradients as max |a - b| /
    max |b|; the params after both updates (max abs)."""
    fa, fb = a["first"], b["first"]
    return dict(
        ring=max((a["ring"][f] - b["ring"][f]).abs().max().item()
                 for f in ("obs", "action", "reward", "next_obs")),
        critic_loss=abs(fa["critic_loss"] / fb["critic_loss"] - 1.0),
        actor_loss=abs(fa["actor_loss"] / fb["actor_loss"] - 1.0),
        critic_grad=rel_err(fa["critic_grad"], fb["critic_grad"])[0],
        actor_grad=rel_err(fa["actor_grad"], fb["actor_grad"])[0],
        alpha_grad=rel_err(fa["alpha_grad"], fb["alpha_grad"])[0],
        params=max((x - y).abs().max().item()
                   for x, y in zip(a["params"], b["params"])))


def _within(diffs, bounds, what):
    """Each bounded reading of `diffs` within its bound: the readings and
    the share of each bound used, as text."""
    for k, v in bounds.items():
        check(diffs[k] <= v, f"{what}: {k} differs by {diffs[k]:.3e} "
              f"(bound {v:.1e})")
    return ", ".join(f"{k} {diffs[k]:.3e} (bound {v:.1e}, share "
                     f"{diffs[k] / v:.3f})" for k, v in bounds.items())


def learner_pairs(envs, dev):
    """Phase 7d: one NPG iteration (float32, then float64 twice on the
    card) and one SAC iteration card vs CPU on the same state, weights
    and draws, stage by stage."""
    size = f"{NPG_PAIR_ENVS} envs x {NPG_PAIR_STEPS} steps"
    runs, before = npg_pair(envs, [dev, "cpu"])
    k, p = runs
    worst, use = _pair_fields(k["traj"], p["traj"],
                              ("obs", "action", "reward", "final_obs",
                               "done"), "NPG pair")
    d = npg_diffs(k, p, before)
    log(f"[7d] card vs CPU, NPG on door-v0, {size}, policy (32, 32), same "
        f"draws: transitions max abs diff {worst:.3e}, largest share of the "
        f"tolerance (rtol 1e-3, atol 2e-3) used {use[0]:.3f} ({use[1]}); "
        f"each run's advantages {d['iter_adv']:.3e} and g {d['iter_g']:.3e}"
        " apart relative; on the same trajectory "
        + _within(d, NPG_PAIR_BOUNDS[torch.float32], "NPG pair")
        + f"; quad {k['metrics']['quad']:.6e} vs {p['metrics']['quad']:.6e}"
        f", step_size {d['step']:.3e} apart relative; the step moved the "
        f"params by up to {d['moved']:.3e}")

    runs, before = npg_pair(envs, [dev, dev, "cpu"], torch.float64)
    twice = npg_diffs(runs[0], runs[1], before)
    for f in ("obs", "action", "reward", "final_obs", "done"):
        torch.testing.assert_close(runs[0]["traj"][f], runs[2]["traj"][f],
                                   **F64_TOL)
    d = npg_diffs(runs[0], runs[2], before)
    log(f"  float64 (no kernel), card vs CPU: transitions max abs diff "
        f"{d['transitions']:.3e} (tolerance rtol / atol 1e-8), each run's "
        f"advantages {d['iter_adv']:.3e} and g {d['iter_g']:.3e} apart "
        "relative; on the same trajectory "
        + _within(d, NPG_PAIR_BOUNDS[torch.float64], "NPG pair, float64")
        + f"; quad {d['quad']:.3e} and step_size {d['step']:.3e} apart "
        f"relative; the card twice: params max abs diff "
        f"{twice['params']:.3e}, g {twice['g']:.3e}")
    check(twice["params"] <= NPG_PAIR_BOUNDS[torch.float64]["params"],
          f"NPG float64 on the card twice: {twice['params']:.3e}")

    runs, cfg = sac_pair(envs, [dev, "cpu"])
    k, p = runs
    worst, use = _pair_fields(k["ring"], p["ring"],
                              ("obs", "action", "reward", "next_obs", "done"),
                              "SAC pair")
    d = sac_diffs(k, p)
    adam = 2.0 * cfg.lr * cfg.updates_per_iter
    log(f"  card vs CPU, SAC on relocate-v0, {LEARNER_PAIR_ENVS} envs x "
        f"{cfg.steps_per_iter} steps, {cfg.updates_per_iter} updates at "
        f"batch {cfg.batch_size}, nets (256, 256), same draws: ring max abs "
        f"diff {worst:.3e}, largest share of the tolerance used {use[0]:.3f}"
        f" ({use[1]}); the first update on the same ring: "
        + _within(d, SAC_PAIR_BOUNDS, "SAC pair")
        + f" (Adam's own bound 2 lr x {cfg.updates_per_iter} updates = "
        f"{adam:.1e}); critic_loss {k['first']['critic_loss']:.6f} vs "
        f"{p['first']['critic_loss']:.6f}")
    check(d["params"] <= adam, f"SAC pair: params differ by {d['params']}")


def learners_phase(TK, envs, dev, info):
    """Phase 7: the NPG / DAPG and SAC trainers and the DAPG policy on the
    card, then card vs CPU.  Returns the launches of 7a-7c (training and
    evaluation)."""
    import tempfile
    TK.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        npg_phase(TK, envs, dev, info, tmp)
        sac_phase(TK, envs, dev, info, tmp)
        dapg_policy_phase(TK, envs, dev, info, tmp)
    torch.cuda.synchronize()
    launches = dict(TK.launches)
    log(f"  launches of phase 7a-7c: {json.dumps(launches)}")
    learner_pairs(envs, dev)
    return launches


# Phase 8: the pixel path.
RENDER_ENVS = 256          # envs per render chunk of the pixel PPO
PIXEL_SHARE = 0.005        # share of pixels that may differ by more than 1
# The board height of the JAX package's hammer reset of PRNGKey(0), the
# state of its golden image (`tests/test_torch_render.py` derives it from
# the JAX package's `_reset_var`).
GOLDEN_BOARD_Z = 0.18682485818862915
GOLDEN = os.path.join("tests", "golden", "raster_hammer64.npy")
PIXEL_PPO_CUTS = dict(n_steps=8, max_episodes=2, checkpoint_interval=2)
PLANET_CONFIG = os.path.join("configs", "hammer_planet.json")
# Length only: 30-step rollouts, 2 seed episodes, 4 updates per episode,
# one training episode (a checkpoint after it).
PLANET_CUTS = dict(max_episode_length=60, seed_episodes=2, sample_iters=4,
                   max_episodes=3, checkpoint_interval=3)
# Card vs CPU.  The pixel-PPO iteration's bounds are the port-vs-JAX floors
# of `tests/test_torch_pixel_ppo.py` (4x the worst over seeds 0-2): both
# sides render their own frames, and a ray that grazes an edge may land on
# the other side of it.  PlaNet's update: a synthetic batch of 8 sequences
# of 10 at the config's widths.
PIXEL_PAIR_BOUNDS = dict(action=1.5e-4, log_prob=4.6e-5, value=6.0e-3,
                         reward=5.7e-6)
PLANET_PAIR_BATCH, PLANET_PAIR_CHUNK = 8, 10
# The updates on one shared batch or trajectory, card vs CPU: 4x the worst
# over seeds 0-2 and this phase's own pair, on two calls (`python
# tests/measure_torch_learner_floors.py card_pixel_pairs`): pixel PPO's
# params 7.1e-5 (float32), 7.1e-15 (float64); PlaNet's losses 1.2e-7
# and 3.3e-16 relative, gradients 4.8e-5 and 7.9e-16 of the largest,
# float64 params 5.5e-15.  The params' bounds are under a quarter of how
# far the update moves them (1.2e-3, 1e-3): a skipped step or a flipped
# gradient is off by about that much.  In float32 Adam's first step turns
# a gradient's last bits into up to a quarter of lr on PlaNet's weights
# whose gradient is near its eps (2.5e-4 of a 1e-3 step at seed 0):
# there the gradients and the weights lr apart carry the check, and
# float64 the params.
PIXEL_UPDATE_BOUNDS = dict(f32=2.9e-4, f64=2.9e-14)
PLANET_UPDATE_BOUNDS = {
    torch.float32: dict(loss_rel=4.8e-7, grad_rel=2.0e-4, params=None),
    torch.float64: dict(loss_rel=1.4e-15, grad_rel=3.2e-15, params=2.2e-14)}


def pixel_share(a, b):
    """The share of pixels whose channels differ by more than 1.0."""
    return ((a.cpu() - b.cpu()).abs().amax(-1) > 1.0).double().mean().item()


def render_trace(fn):
    """One call of `fn` under `torch.profiler`: its wall time, the device
    kernels it ran, their summed device time, the device's idle share and
    the kernels that took the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.device_time_total / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    if not n:
        log("  render traced: no device time in the trace (not measured)")
        return
    log(f"  render traced: wall {wall_ms:.1f} ms, {n} device kernels, "
        f"device {device_ms:.1f} ms, idle share "
        f"{1.0 - device_ms / wall_ms:.3f}; most device time: "
        + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top))


def render_phase(envs, dev, info, random_actions):
    """8a: the renderer on the card against the CPU on one state of 256
    hammer envs; the golden image; all four tasks at 8 envs."""
    from mj_envs_torch.envs.base import _apply_var
    from mj_envs_torch.envs.pixels import PixelObservationEnv
    from mj_envs_torch.render import raster

    env = envs.make("hammer-v0", device=dev)
    penv = PixelObservationEnv(env)
    gen = env.generator(3)
    st = env.reset(RENDER_ENVS, gen)
    for _ in range(2):
        st = env.step_auto_reset(
            st, random_actions(gen, RENDER_ENVS, env.nu, dev), gen)
    model = _apply_var(env.model, st.var)
    args = (st.data.geom_xpos, st.data.geom_xmat, penv.camera)
    img = raster.render(model, *args, dirs=penv.dirs)
    env_c = envs.make("hammer-v0", device="cpu")
    st_c = st.map(lambda x: x.cpu())
    t0 = time.perf_counter()
    img_c = raster.render(_apply_var(env_c.model, st_c.var),
                          st_c.data.geom_xpos, st_c.data.geom_xmat,
                          penv.camera.to("cpu"))
    cpu_s = time.perf_counter() - t0
    share = pixel_share(img, img_c)
    ms128 = time_ms(lambda: raster.render(model, *args, dirs=penv.dirs),
                    reps=5)
    ms64 = time_ms(lambda: penv._render(st), reps=5)
    log(f"  hammer {RENDER_ENVS} envs after a reset and 2 steps, 128x128: "
        f"card vs CPU, pixels more than 1.0 apart: {share:.6f} (bound "
        f"{PIXEL_SHARE}); max |diff| {(img.cpu() - img_c).abs().max():.3f}"
        f"; the CPU took {cpu_s:.1f} s")
    log(f"  render of one {RENDER_ENVS}-env chunk: 128x128 {ms128:.2f} ms, "
        f"with the 64x64 resize (PixelObservationEnv._render) {ms64:.2f} "
        f"ms ({info})")
    render_trace(lambda: raster.render(model, *args, dirs=penv.dirs))
    check(share <= PIXEL_SHARE, f"renderer card vs CPU: {share}")
    check(bool(torch.isfinite(img).all()) and float(img.min()) >= 0.0
          and float(img.max()) <= 255.0 and float(img.std()) > 5.0,
          "renderer output")

    # The golden image: qpos0, zero qvel, the JAX reset's board height;
    # the poses from the CPU's kinematics, as the JAX package's are.  (The
    # card's FK kernel rounds in another order; through the JAX package's
    # grazing test, whose b^2 - c assumes a unit direction, that can move
    # a silhouette pixel: the card-vs-CPU check above holds that share.)
    g = env_c.reset(1, env_c.generator(0))
    var = g.var
    var.body_pos[:, env_c.board_bid, 2] = GOLDEN_BOARD_Z
    g = env_c.set_physics_state(g.replace(var=var), env_c.model.qpos0[None],
                                torch.zeros(1, env_c.nv))
    golden = torch.as_tensor(np.load(os.path.join(ROOT, GOLDEN)))
    gk = penv._render(g.map(lambda x: x.to(dev)))[0].cpu()
    gd = (gk - golden).abs().max().item()
    own = env.set_physics_state(g.map(lambda x: x.to(dev)),
                                env.model.qpos0[None],
                                torch.zeros(1, env.nv, device=dev))
    gd_own = (penv._render(own)[0].cpu() - golden).abs()
    log(f"  golden image {GOLDEN} on the card: max |diff| {gd:.4f} "
        f"(bound 2.0); from the card's own kinematics: max |diff| "
        f"{gd_own.max().item():.4f}, {int((gd_own > 2.0).any(-1).sum())} "
        "pixels of 4096 over 2.0")
    check(gd < 2.0, f"golden image: {gd}")

    for task in TASKS:
        e = envs.make(task, device=dev)
        p = PixelObservationEnv(e)
        s = e.reset(8, e.generator(1))
        s = e.step_auto_reset(s, random_actions(e.generator(2), 8, e.nu, dev),
                              e.generator(4))
        px = p._render(s)
        e_c = envs.make(task, device="cpu")
        p_c = PixelObservationEnv(e_c)
        sh = pixel_share(px, p_c._render(s.map(lambda x: x.cpu())))
        log(f"  {task}: 8 envs 64x64, card vs CPU pixels more than 1.0 "
            f"apart {sh:.6f}, mean {float(px.mean()):.2f}, std "
            f"{float(px.std()):.2f}")
        check(px.shape == (8, 64, 64, 3) and bool(torch.isfinite(px).all())
              and float(px.std()) > 5.0, f"{task} pixels")
        check(sh <= PIXEL_SHARE, f"{task} card vs CPU: {sh}")
    return dict(render_ms_128=ms128, render_ms_64=ms64)


def pixel_ppo_phase(TK, envs, dev, info, tmp):
    """8b: pixel PPO through `train_ppo_policy` at the config's widths
    (model_type "cnn"); returns the train state and the training rows."""
    from mj_envs_torch.algos import ppo as PPO
    from mj_envs_torch.envs.pixels import PixelObservationEnv
    from mj_envs_torch.utils import checkpoint as CKPT, eval as EV
    from mj_envs_torch.utils import train as TT
    from mj_envs_torch.utils.config import PPOConfig

    config = PPOConfig().load(os.path.join(ROOT, PPO_CONFIG))
    config.model_type = "cnn"
    full = {k: getattr(config, k) for k in PIXEL_PPO_CUTS}
    for k, v in PIXEL_PPO_CUTS.items():
        setattr(config, k, v)
    config.test_interval = config.max_episodes + 1   # eval below, once
    cfg = TT.ppo_config(config)
    env = envs.make(config.env_name, device=dev)
    out = os.path.join(tmp, "pixel_ppo")
    log(f"[8b] pixel PPO: {PPO_CONFIG} with model_type cnn, "
        f"{config.env_name}, num_envs {config.num_envs}, NatureCNN, "
        f"minibatches {cfg.n_minibatches}, epochs {cfg.n_epochs}, chunk "
        f"{cfg.step_chunk}, pixel_chunk {cfg.pixel_chunk}; cuts: "
        + ", ".join(f"{k} {full[k]} -> {v}" for k, v in
                    PIXEL_PPO_CUTS.items()))

    def line(r):
        return (f"rollout {r['rollout_ms']:.1f} ms (physics "
                f"{r['physics_ms']:.1f}, render {r['render_ms']:.1f}, "
                f"policy {r['policy_ms']:.1f}), GAE {r['gae_ms']:.2f} ms, "
                f"update {r['update_ms']:.1f} ms; mean_reward "
                f"{r['mean_reward']:.4f}, pg_loss {r['pg_loss']:.4f} "
                f"({info})")

    st, rows, last, secs = learner_run(TK, TT.train_ppo_policy, config, env,
                                       out, line)
    check_launches(TK, last, "pixel PPO iteration 2")
    penv = PixelObservationEnv(env)
    init_fn = PPO.make_pixel_ppo(penv, config.num_envs, cfg, device=dev)[0]
    check_restore(CKPT, out, 2, init_fn(config.seed + 99), st,
                  "pixel PPO train state")

    def policy(module, pixels, gen):
        return torch.clamp(module(pixels)[0], -1.0, 1.0)

    t0 = time.perf_counter()
    res = EV.make_pixel_evaluate(penv, policy, EVAL_LENGTH)(
        st.module, config.seed + 2, count=EVAL_COUNT)
    log(f"  training {secs:.1f} s; eval {EVAL_COUNT} x {EVAL_LENGTH} steps "
        f"in {time.perf_counter() - t0:.1f} s: reward "
        f"{res.total_rewards.mean():.3f}")
    check(res.obs.shape == (EVAL_COUNT, EVAL_LENGTH, env.OBS_DIM)
          and np.isfinite(res.total_rewards).all(), "pixel eval result")
    return config, rows


def pixel_ppo_pair(envs, devices, config, seed=7):
    """8b, card vs CPU: one pixel-PPO rollout of PAIR_ENVS hammer envs on
    each of `devices` from the same state, weights and noise, each
    rendering its own frames through one camera; then the update on one
    shared trajectory (the last device's, with its advantages and
    returns) on each device, in float32 and in float64, from the same
    weights and permutations.  Returns {"traj": [trajectory per device],
    "params": {dtype: [params after the update per device]}, "before":
    {dtype: params before}}."""
    from mj_envs_torch.algos import networks as NN, ppo as PPO
    from mj_envs_torch.envs.pixels import PixelEnvState, PixelObservationEnv

    cfg = PPO.PPOConfig(lr=config.learning_rate,
                        max_grad_norm=float(config.grad_clip_norm),
                        **PAIR_CFG)
    pens = [PixelObservationEnv(envs.make(config.env_name, device=d))
            for d in devices]
    env_p = envs.make(config.env_name, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    st_p = env_p.reset(PAIR_ENVS, env_p.generator(seed))
    tree = NN.cnn_actor_critic_to_numpy(
        NN.CnnActorCritic(env_p.nu, generator=gen, device="cpu"))
    n = cfg.n_steps * PAIR_ENVS
    noise = torch.randn(cfg.n_steps, PAIR_ENVS, env_p.nu, generator=gen)
    perms = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(cfg.n_epochs)])
    out = dict(traj=[], params={}, before={})
    for penv in pens:
        d = penv.env.device
        mod = NN.cnn_actor_critic_from_numpy(tree, device=d)
        ts = PPO.TrainState(mod, PPO.make_optimizer(mod, cfg),
                            torch.Generator(device=d), penv.env.generator(8))
        st = st_p.map(lambda x: x.to(d))
        ps = PixelEnvState(state=st, pixels=penv._render(st))
        ps2, traj = PPO.make_pixel_rollout(penv, cfg)(ts, ps, noise.to(d))
        with torch.no_grad():
            last = mod(ps2.pixels)[2]
        out["traj"].append((traj, PPO._gae(cfg, traj, last)))
    traj, (adv, ret) = out["traj"][-1]
    out["traj"] = [t for t, _ in out["traj"]]
    for dtype in (torch.float32, torch.float64):
        out["params"][dtype] = []
        for penv in pens:
            d = penv.env.device
            mod = NN.cnn_actor_critic_from_numpy(tree, device=d, dtype=dtype)
            ts = PPO.TrainState(mod, PPO.make_optimizer(mod, cfg),
                                torch.Generator(device=d),
                                torch.Generator(device=d))
            cast = lambda x: x.to(d, None if x.dtype == torch.uint8  # noqa
                                  else dtype)
            PPO._make_update(cfg)(ts, PPO.Transition(*map(cast, traj)),
                                  cast(adv), cast(ret), perms.to(d))
            out["params"][dtype].append(
                [p.detach().cpu() for p in mod.parameters()])
        out["before"][dtype] = [
            p.detach() for p in NN.cnn_actor_critic_from_numpy(
                tree, device="cpu", dtype=dtype).parameters()]
    return out


def _max_diff(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def pixel_pair_diffs(out, i=0, j=-1):
    """Devices i and j of `pixel_ppo_pair`: the share of stored frame
    values more than 1 apart, the rollout fields' max abs differences,
    the params' after each update and how far j's updates moved them."""
    tk, tp = out["traj"][i], out["traj"][j]
    frames = (tk.obs.cpu().int() - tp.obs.int()).abs()
    d = dict(share=(frames > 1).double().mean().item(),
             done=float(not torch.equal(tk.done.cpu(), tp.done)))
    for f in PIXEL_PAIR_BOUNDS:
        d[f] = (getattr(tk, f).cpu().double()
                - getattr(tp, f).double()).abs().max().item()
    for dtype, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        ps = out["params"][dtype]
        d[f"params_{name}"] = _max_diff(ps[i], ps[j])
        d[f"moved_{name}"] = _max_diff(ps[j], out["before"][dtype])
    return d


def pixel_pair_phase(envs, dev, config):
    d = pixel_pair_diffs(pixel_ppo_pair(envs, [dev, "cpu"], config))
    cfg = PAIR_CFG
    log(f"  card vs CPU, {PAIR_ENVS} envs x {cfg['n_steps']} steps, same "
        f"draws: stored frames more than 1 apart {d['share']:.6f} (bound "
        f"{PIXEL_SHARE}); " + ", ".join(
            f"{k} {d[k]:.3e} (bound {b:.1e})"
            for k, b in PIXEL_PAIR_BOUNDS.items())
        + f"; the update ({cfg['n_epochs']} x {cfg['n_minibatches']} "
        "minibatches) on one shared trajectory: params "
        + ", ".join(f"{k} {d['params_' + k]:.3e} apart (bound "
                    f"{PIXEL_UPDATE_BOUNDS[k]:.1e}) after moving "
                    f"{d['moved_' + k]:.3e}" for k in PIXEL_UPDATE_BOUNDS))
    check(d["done"] == 0.0, "pixel pair: done differs")
    check(d["share"] <= PIXEL_SHARE, f"pixel pair frames: {d['share']}")
    for k, b in PIXEL_PAIR_BOUNDS.items():
        check(d[k] <= b, f"pixel pair {k}: {d[k]}")
    for k, b in PIXEL_UPDATE_BOUNDS.items():
        check(d[f"moved_{k}"] > 4 * b,
              f"pixel pair update ({k}) moved the params by "
              f"{d['moved_' + k]} only")
        check(d[f"params_{k}"] <= b,
              f"pixel pair update params ({k}): {d['params_' + k]}")


def planet_phase(TK, envs, dev, info, tmp):
    """8c: `train_planet_policy` at the config's full widths, cut in length
    only; the checkpoint restored, an evaluation of the loaded params."""
    from mj_envs_torch.algos import planet as PL
    from mj_envs_torch.utils import checkpoint as CKPT, eval as EV
    from mj_envs_torch.utils import train as TT
    from mj_envs_torch.utils.config import PlanetConfig

    config = PlanetConfig().load(os.path.join(ROOT, PLANET_CONFIG))
    full = {k: getattr(config, k) for k in PLANET_CUTS}
    for k, v in PLANET_CUTS.items():
        setattr(config, k, v)
    env = envs.make(config.env_name, device=dev)
    out = os.path.join(tmp, "planet")
    log(f"[8c] PlaNet: {PLANET_CONFIG} {config.env_name}, belief "
        f"{config.belief_size}, state {config.state_size}, hidden "
        f"{config.hidden_size}, embedding {config.embedding_size}, batch "
        f"{config.batch_size} x chunk {config.chunk_size}, CEM "
        f"{config.candidates} / {config.top_candidates} / "
        f"{config.optimisation_iters} iterations / horizon "
        f"{config.planning_horizon}, replay {config.experience_size} frames"
        " (host); cuts: " + ", ".join(f"{k} {full[k]} -> {v}"
                                      for k, v in PLANET_CUTS.items()))

    def line(r):
        return (f"update {r['update_ms']:.1f} ms each (sampling "
                f"{r['sample_ms']:.1f} ms on the host), plan "
                f"{r['plan_ms']:.1f} ms a step, collect "
                f"{r['collect_steps_per_s']:.1f} env-steps/s "
                f"({r['collect_ms']:.0f} ms); obs_loss {r['obs_loss']:.1f}, "
                f"kl {r['kl_loss']:.3f}, reward {r['reward']:.3f} ({info})")

    st, rows, last, secs = learner_run(TK, TT.train_planet_policy, config,
                                       env, out, line)
    check_launches(TK, last, "PlaNet's run (the replay's seed episodes and "
                   "one training episode, every step a single env, B = 1)")
    cfg = PL.cfg_from_config(config, env.nu)
    fresh = PL.make_planet(cfg, device=dev)[0](config.seed + 99)
    check_restore(CKPT, out, config.max_episodes, fresh, st,
                  "PlaNet params and Adam state")
    config.models_path = CKPT.latest(out)
    module = EV.load_planet_params(config, env)
    t0 = time.perf_counter()
    res = EV.make_planet_evaluate(env, config, 3)(module, config.seed + 2,
                                                  count=2)
    log(f"  training {secs:.1f} s (replay seeding included); eval 2 x 3 "
        f"steps of the loaded params in {time.perf_counter() - t0:.1f} s: "
        f"reward {res.total_rewards.mean():.3f}")
    check(res.obs.shape == (2, 3, env.OBS_DIM)
          and np.isfinite(res.total_rewards).all(), "PlaNet eval result")
    return config, st, rows


def planet_update_pair(devices, cfg, tree, seed=11):
    """8c, card vs CPU: one `update_fn` on each of `devices`, in float32
    and in float64, on the same synthetic batch of PLANET_PAIR_BATCH
    sequences of PLANET_PAIR_CHUNK, weights `tree` and posterior noise.
    Returns {dtype: {"metrics", "grads", "params": one per device,
    "before": the params before}}."""
    from mj_envs_torch.algos import planet as PL

    rng = np.random.default_rng(seed)
    T, Bt = PLANET_PAIR_CHUNK, PLANET_PAIR_BATCH
    batch = dict(
        obs=rng.uniform(-0.5, 0.5, (T, Bt, 64, 64, 3)).astype(np.float32),
        actions=rng.uniform(-1, 1, (T, Bt, cfg.action_size))
        .astype(np.float32),
        rewards=rng.standard_normal((T, Bt)).astype(np.float32),
        nonterminals=np.ones((T, Bt), np.float32))
    noise = torch.randn(T - 1, Bt, cfg.state_size,
                        generator=torch.Generator().manual_seed(seed + 1))
    out = {}
    for dtype in (torch.float32, torch.float64):
        o = out[dtype] = dict(metrics=[], grads=[], params=[])
        for d in devices:
            mod = PL.planet_from_numpy(tree, cfg, device=d, dtype=dtype)
            stt = PL.PlanetState(mod, PL.make_optimizer(mod, cfg))
            m = PL.make_planet(cfg, device=d, dtype=dtype)[1](
                stt, batch, noise=noise.to(d, dtype))
            o["metrics"].append({k: float(v) for k, v in m.items()})
            # the gradients the step took (after the clip at its norm)
            o["grads"].append([p.grad.detach().cpu()
                               for p in mod.parameters()])
            o["params"].append([p.detach().cpu() for p in mod.parameters()])
        o["before"] = [p.detach() for p in PL.planet_from_numpy(
            tree, cfg, device="cpu", dtype=dtype).parameters()]
    return out


def planet_update_diffs(out, lr, i=0, j=-1):
    """Devices i and j of one dtype of `planet_update_pair`: the losses'
    largest relative difference, the gradients' largest difference
    relative to the largest gradient, the params' largest difference,
    how far j's step moved them, and the weights more than lr apart."""
    mk, mc = out["metrics"][i], out["metrics"][j]
    g_max = max(g.abs().max().item() for g in out["grads"][j])
    pk, pc = out["params"][i], out["params"][j]
    return dict(
        loss_rel=max(abs(mk[k] - mc[k]) / max(abs(mc[k]), 1e-30)
                     for k in mk),
        grad_rel=_max_diff(out["grads"][i], out["grads"][j]) / g_max,
        params=_max_diff(pk, pc),
        moved=_max_diff(pc, out["before"]),
        flips=float(sum(int(((a - b).abs() > lr).sum())
                        for a, b in zip(pk, pc))))


def planet_pairs(TK, envs, dev, config, state):
    """8c, card vs CPU: one `update_fn` on the same synthetic batch,
    weights and posterior noise; `plan` in float64 on the same normals
    (every iteration's top-k sets equal); one hammer step at B = 1."""
    from mj_envs_torch.algos import planet as PL

    cfg = state.params.cfg
    tree = PL.planet_to_numpy(state.params)
    out = planet_update_pair([dev, "cpu"], cfg, tree)
    n = sum(p.numel() for p in out[torch.float32]["params"][0])
    log(f"  card vs CPU, one update on {PLANET_PAIR_BATCH} sequences of "
        f"{PLANET_PAIR_CHUNK} at full width ({n} weights, lr {cfg.lr}): "
        "losses " + json.dumps({k: round(v, 4) for k, v in
                                out[torch.float32]["metrics"][0].items()}))
    for dtype, b in PLANET_UPDATE_BOUNDS.items():
        d = planet_update_diffs(out[dtype], cfg.lr)
        log(f"  {dtype}: losses {d['loss_rel']:.2e} apart relative (bound "
            f"{b['loss_rel']:.1e}), gradients {d['grad_rel']:.2e} relative "
            f"to the largest (bound {b['grad_rel']:.1e}), params "
            f"{d['params']:.3e} apart after a step that moved them by "
            f"{d['moved']:.3e}"
            + (f" (bound {b['params']:.1e})" if b["params"] else "")
            + f", {int(d['flips'])} weights more than lr apart")
        for k in ("loss_rel", "grad_rel"):
            check(d[k] <= b[k], f"PlaNet update ({dtype}) {k}: {d[k]}")
        check(d["flips"] == 0, f"PlaNet update ({dtype}): {d['flips']} "
              "weights more than lr apart")
        if b["params"]:
            check(d["moved"] > 4 * b["params"],
                  f"PlaNet update ({dtype}) moved the params by "
                  f"{d['moved']} only")
            check(d["params"] <= b["params"],
                  f"PlaNet update ({dtype}) params: {d['params']}")

    # The planner in float64, both sides on the same normals.
    gen = torch.Generator().manual_seed(13)
    h = torch.randn(2, cfg.belief_size, generator=gen, dtype=torch.float64)
    s = torch.randn(2, cfg.state_size, generator=gen, dtype=torch.float64)
    eps = torch.randn(cfg.optimisation_iters, cfg.candidates,
                      cfg.planning_horizon, 2, cfg.action_size,
                      generator=gen, dtype=torch.float64)
    tops, acts = [], []
    for d in (dev, torch.device("cpu")):
        mod = PL.planet_from_numpy(tree, cfg, device=d, dtype=torch.float64)
        mean = torch.zeros(cfg.planning_horizon, 2, cfg.action_size,
                           dtype=torch.float64, device=d)
        std = torch.ones_like(mean)
        tops.append([])
        for it in range(cfg.optimisation_iters):
            mean, std, top = PL.cem_step(mod, h.to(d), s.to(d), mean, std,
                                         eps[it].to(d))
            tops[-1].append(top.sort(dim=1).values.cpu())
        acts.append(mean[0].cpu())
    same = [torch.equal(a, b) for a, b in zip(*tops)]
    a_err = (acts[0] - acts[1]).abs().max().item()
    log(f"  plan float64 card vs CPU ({cfg.candidates} candidates, top "
        f"{cfg.top_candidates}, {cfg.optimisation_iters} iterations, 2 envs)"
        f": top-k sets equal in every iteration: {all(same)}; action "
        f"{a_err:.3e} apart (bound 1e-9)")
    check(all(same), "plan: top-k sets differ")
    check(a_err <= 1e-9, f"plan action: {a_err}")

    # One hammer step at B = 1, the card's kernels against the CPU.
    env_c = envs.make("hammer-v0", device="cpu")
    env_k = envs.make("hammer-v0", device=dev)
    st_c = env_c.reset(1, env_c.generator(21))
    a = torch.rand(1, env_c.nu, generator=torch.Generator().manual_seed(22))
    a = 2.0 * a - 1.0
    TK.reset_launches()
    st_k = env_k.step(st_c.map(lambda x: x.to(dev)), a.to(dev))
    torch.cuda.synchronize()
    one = dict(TK.launches)
    st_c = env_c.step(st_c, a)
    diffs = {}
    for name, x, y in (("qpos", st_k.data.qpos, st_c.data.qpos),
                       ("qvel", st_k.data.qvel, st_c.data.qvel),
                       ("obs", st_k.obs, st_c.obs)):
        diffs[name] = (x.cpu() - y).abs().max().item()
        torch.testing.assert_close(x.cpu(), y, **PAIR_TOL,
                                   msg=lambda m: f"B = 1 step {name}: {m}")
    log(f"  hammer step at B = 1, card vs CPU: max abs diff "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in diffs.items()})} "
        f"(rtol 1e-3, atol 2e-3); launches {json.dumps(one)}")
    for name in MAIN_KERNELS:
        check(one[name] > 0, f"kernel {name} was not launched at B = 1")


def pixel_phase(TK, envs, dev, info):
    """Phase 8: the renderer, pixel PPO and PlaNet on the card.  Returns
    the launches of 8a-8c's runs (the env steps, training and
    evaluations; not the card-vs-CPU pairs)."""
    import tempfile
    from mj_envs_torch.parallel.vector import random_actions

    log("[8a] renderer:")
    TK.reset_launches()
    render_phase(envs, dev, info, random_actions)
    with tempfile.TemporaryDirectory() as tmp:
        ppo_config, _ = pixel_ppo_phase(TK, envs, dev, info, tmp)
        planet_config, pstate, _ = planet_phase(TK, envs, dev, info, tmp)
        torch.cuda.synchronize()
        launches = dict(TK.launches)
        log(f"  launches of phase 8a-8c: {json.dumps(launches)}")
        pixel_pair_phase(envs, dev, ppo_config)
        planet_pairs(TK, envs, dev, planet_config, pstate)
    return launches


# Phase 9: the CLIs and the distributed runtime.
CLI_STEPS = 10           # phase 9's episodes: hammer's 200 steps cut to 10
EVAL_EPISODES = 1        # of EVAL_COUNT envs each
VIEWER_STEPS = 3
CLI_FRAMES = 4           # frames of the worst trajectory held card vs CPU
DIST_ENVS, DIST_STEPS = NUM_ENVS, 2
SHARD_STEPS = 1          # two_shard_check's steps, the last resetting all


def _decode_gif(path):
    """The frames of a gif as (H, W, 3) uint8 arrays (PIL's decoder)."""
    from PIL import Image
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
    return out


def _decode_png(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def eval_phase(envs, dev, info, keep):
    """9a: `run_eval` on hammer with the DAPG path (a synthetic pickle)
    and with phase 6's PPO checkpoint, its artifacts decoded, and the
    worst trajectory re-rendered card vs CPU."""
    from mj_envs_torch import visualize as V
    from mj_envs_torch.utils import eval as EV

    pickle = write_mjrl_pickle(os.path.join(keep, "hammer-v0.pickle"),
                               DAPG_SEED)
    seen = []
    render = V.render_state_trajectory

    def spy(env, qpos_traj, *a, **k):
        t0 = time.perf_counter()
        frames = render(env, qpos_traj, *a, **k)
        seen.append((np.asarray(qpos_traj), frames,
                     time.perf_counter() - t0))
        return frames

    V.render_state_trajectory = spy
    try:
        for policy_type, models_path in (
                ("dapg", ""), ("ppo", os.path.join(keep, PPO_KEPT))):
            cfg = os.path.join(keep, f"eval_{policy_type}.json")
            with open(cfg, "w") as f:
                json.dump({"env_name": "hammer-v0", "seed": 0,
                           "device_type": dev.type,
                           "models_path": models_path}, f)
            out = os.path.join(keep, f"eval_{policy_type}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, name = EV.run_eval(cfg, policy_type, episodes=EVAL_EPISODES,
                                  out=out, episode_length=CLI_STEPS,
                                  dapg_root=keep)
            secs = time.perf_counter() - t0
            qpos, frames, render_s = seen[-1]
            gif = _decode_gif(os.path.join(out, f"{name}_0.gif"))
            pngs = [_decode_png(os.path.join(out, f"{name}_eval_{k}.png"))
                    for k in ("rewards", "success")]
            check(len(gif) == CLI_STEPS and gif[0].shape == (128, 128, 3)
                  and all(p.shape == (500, 1000, 3) and p.std() > 0
                          for p in pngs), f"run_eval {policy_type} files")
            gif_err = max(np.abs(g.astype(int) - f.astype(np.uint8)).max()
                          for g, f in zip(gif, frames))
            env_c = envs.make("hammer-v0", device="cpu")
            cpu = render(env_c, qpos[:CLI_FRAMES])
            share = max(pixel_share(torch.as_tensor(a), torch.as_tensor(b))
                        for a, b in zip(frames[:CLI_FRAMES], cpu))
            log(f"[9a] run_eval hammer-v0 {policy_type} "
                f"({os.path.basename(models_path) or 'synthetic pickle'}): "
                f"{EVAL_EPISODES} episode x {EVAL_COUNT} envs; cut: episode "
                f"200 -> {CLI_STEPS} steps; {secs:.2f} s, "
                f"{EVAL_EPISODES * EVAL_COUNT * CLI_STEPS / secs:.1f} "
                f"env-steps/s with the gif and plots; worst trajectory "
                f"rendered ({len(frames)} frames 128x128) in "
                f"{render_s * 1e3:.1f} ms; gif decoded {len(gif)} frames, "
                f"max |frame - gif| {gif_err} (must be 0); 2 "
                f"pngs 1000x500; first {CLI_FRAMES} frames card vs CPU, "
                f"pixels more than 1.0 apart: {share:.6f} (bound "
                f"{PIXEL_SHARE}) ({info})")
            check(share <= PIXEL_SHARE, f"render_state_trajectory card vs "
                  f"CPU: {share}")
            check(gif_err == 0, f"run_eval {policy_type}: the gif decodes "
                  f"{gif_err} away from the frames")
            check(all(np.isfinite(f).all() for f in frames), "frames")
    finally:
        V.render_state_trajectory = render
    return pickle


def visualize_phase(dev, info, keep, pickle):
    """9b: one capped `visualize` episode of the pickle's policy."""
    from mj_envs_torch import visualize as V
    out = os.path.join(keep, "vis")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V.main(["--env_name", "hammer-v0", "--policy", pickle, "--episodes",
            "1", "--seed", "0", "--out", out, "--device", dev.type,
            "--max_steps", str(CLI_STEPS)])
    secs = time.perf_counter() - t0
    gif = _decode_gif(os.path.join(out, "visualise_hammer-v0_dapg_0.gif"))
    png = _decode_png(os.path.join(out, "rewards_hammer-v0.png"))
    steps = len(gif) - 1
    log(f"[9b] visualize hammer-v0 (the pickle's DAPG policy, 1 env, "
        f"128x128 a step); cut: episode 200 -> {CLI_STEPS} steps; {steps} "
        f"steps in {secs:.2f} s with the set-up and files: "
        f"{steps / secs:.2f} env-steps/s; gif {len(gif)} frames, png "
        f"{png.shape[1]}x{png.shape[0]} ({info})")
    check(steps == CLI_STEPS and png.std() > 0, "visualize files")


def viewer_phase(envs, dev, info, pickle):
    """9c: a headless viewer on the card for a few steps; its frame card
    vs CPU on the same state and camera."""
    from mj_envs_torch.algos import dapg as DAPG
    from mj_envs_torch.viewer import InteractiveViewer

    act = DAPG.make_policy(DAPG.load_dapg_params(pickle), device=dev)
    v = InteractiveViewer("hammer-v0", policy=act, backend="Agg",
                          device=dev)
    for key in ("left", "+", "up"):
        v.handle_key(key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score = v.run(episodes=1, max_steps=VIEWER_STEPS)
    img = v.frame()
    secs = time.perf_counter() - t0
    c = InteractiveViewer("hammer-v0", backend="Agg", device="cpu")
    c.state = v.state.map(lambda x: x.cpu())
    c._model = v._model.to("cpu", torch.float32)
    c.lookat, c.azimuth, c.elevation, c.distance = (
        v.lookat, v.azimuth, v.elevation, v.distance)
    share = pixel_share(torch.as_tensor(img, dtype=torch.float32),
                        torch.as_tensor(c.frame(), dtype=torch.float32))
    log(f"[9c] InteractiveViewer hammer-v0 (Agg, 240x320, the pickle's "
        f"policy): {VIEWER_STEPS} steps and a frame in {secs:.2f} s "
        f"({VIEWER_STEPS / secs:.2f} env-steps/s), score {score:.3f}; "
        f"camera az {v.azimuth} el {v.elevation} dist {v.distance:.3f}; "
        f"frame card vs CPU, pixels more than 1.0 apart: {share:.6f} "
        f"(bound {PIXEL_SHARE}) ({info})")
    check(img.shape == (240, 320, 3) and img.std() > 5.0
          and np.isfinite(score), "viewer frame")
    check(share <= PIXEL_SHARE, f"viewer frame card vs CPU: {share}")


def two_shard_check(envs, dev, info):
    """The second of two env shards on this one card, with no process
    group: a VectorEnv holding rows [n/2, n) of the n envs, as a mesh of
    two env shards gives its rank 1 (its reset slices the global draws;
    each step's generator skips the first shard's chunks), against those
    rows of the plain VectorEnv bit for bit, through a reset and
    SHARD_STEPS random steps, the last of which truncates every env, so
    that each takes its fresh episode from the draws after the skipped
    ones."""
    from mj_envs_torch.dryrun import _fields
    from mj_envs_torch.parallel.vector import (VectorEnv, random_actions,
                                               shard_plan)

    env = envs.make("hammer-v0", device=dev)
    n, half = DIST_ENVS, DIST_ENVS // 2
    plain = VectorEnv(env, n, chunk_size=B_CHUNK)
    second = VectorEnv(env, n, chunk_size=B_CHUNK)
    second.local, second.offset = half, half
    second.plan = shard_plan(n, B_CHUNK, half, half)
    gen = torch.Generator(device=dev).manual_seed(9)
    bad = []

    def differ(stage, a, b):
        bad.extend((stage, f, (x.double() - y[half:].double()).abs().max()
                    .item()) for (f, x), (_, y) in zip(_fields(a), _fields(b))
                   if not torch.equal(x, y[half:]))

    last = lambda st: st.replace(step_count=torch.full_like(
        st.step_count, env.MAX_EPISODE_STEPS - 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s = plain.reset(seed=0), second.reset(seed=0)
    differ("reset", s, p)
    for t in range(SHARD_STEPS):
        if t == SHARD_STEPS - 1:
            p, s = last(p), last(s)
        a = random_actions(gen, n, env.nu, env.device)
        p, s = plain.step(p, a), second.step(s, a[half:])
        differ(f"step {t + 1}", s, p)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    skipped = sum(j - i for i, j, mine in second.plan if not mine)
    log(f"[9d] two env shards on one card, no group: rows [{half}, {n}) of "
        f"{n} hammer-v0 envs (chunk {B_CHUNK}; {skipped} rows' reset draws "
        f"skipped a step) vs the plain VectorEnv, a reset and {SHARD_STEPS} "
        f"step(s), the last resetting every env ({bool(p.done.all())}), both "
        f"in {secs:.2f} s; every field bit for bit: {not bad} {bad} "
        f"({info})")
    check(bool(p.done.all()) and skipped == half, "the two-shard check "
          "reset no env or skipped no draws")
    check(not bad, f"the second env shard differs from the plain rows: "
          f"{bad}")


def distributed_phase(envs, dev, info):
    """9d: the second of two env shards against the plain rows on one
    card (`two_shard_check`); a one-rank NCCL group from torchrun's
    variables; the sharded VectorEnv against the plain one bit for bit;
    `dryrun_multichip(1)`; the group torn down and the variables
    restored."""
    import torch.distributed as dist

    from mj_envs_torch.dryrun import dryrun_multichip, vector_check
    from mj_envs_torch.parallel import distributed as D

    two_shard_check(envs, dev, info)
    names = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK")
    before = {k: os.environ.get(k) for k in names}
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(D.free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    try:
        D.initialize(device=dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.is_initialized() and dist.get_backend() == backend,
              f"no {backend} group")
        bad, rate, plain_rate, _ = vector_check(DIST_ENVS, DIST_STEPS,
                                                B_CHUNK, device=dev)
        log(f"[9d] one {backend} rank (torchrun's variables, initialize()): "
            f"hammer-v0 VectorEnv {DIST_ENVS} envs, chunk {B_CHUNK}, "
            f"{DIST_STEPS} steps: sharded (mesh (env 1, model 1)) "
            f"{rate:.1f} env-steps/s, plain {plain_rate:.1f}; every field "
            f"bit for bit: {not bad} {bad} ({info})")
        check(not bad, f"sharded VectorEnv differs from the plain one: {bad}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = dryrun_multichip(1, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"  dryrun_multichip(1): 2 envs, n_steps 2, hidden (256, 256), "
            f"one PPO iteration in {secs:.2f} s ({info})")
        check(all(np.isfinite(v) for v in metrics.values()),
              f"dryrun metrics {metrics}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(not dist.is_initialized(), "the process group outlived phase 9")


def cli_phase(TK, envs, dev, info, keep):
    """Phase 9: eval, visualize, the viewer and the distributed runtime on
    the card, each driven with the launch counts at 0 and read after it;
    each must launch K1-K6.  Returns the launches of 9a-9d together."""
    total = dict.fromkeys(TK.KERNELS, 0)

    def counted(name, fn, *args):
        TK.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = dict(TK.launches)
        log(f"  launches of phase {name}: {json.dumps(launches)}")
        for k in MAIN_KERNELS:
            check(launches[k] > 0, f"kernel {k} was not launched by phase "
                  f"{name}")
        for k, n in launches.items():
            total[k] += n
        return out

    pickle = counted("9a", eval_phase, envs, dev, info, keep)
    counted("9b", visualize_phase, dev, info, keep, pickle)
    counted("9c", viewer_phase, envs, dev, info, pickle)
    counted("9d", distributed_phase, envs, dev, info)
    log(f"  launches of phase 9a-9d: {json.dumps(total)}")
    return total


def write_mjrl_pickle(path, seed, sizes=(46, 32, 32, 26)):
    """A synthetic pickle shaped as the reference's DAPG policies: an mjrl
    `gaussian_mlp.MLP` holding an `fc_network.FCNetwork` (a tanh MLP of
    `sizes` with input and output shifts and scales) and a log_std, all
    drawn from `seed`.  The mjrl classes are stand-ins, registered in
    `sys.modules` only while pickling."""
    import math
    import pickle
    import types

    from torch import nn
    names = ("mjrl", "mjrl.utils", "mjrl.utils.fc_network", "mjrl.policies",
             "mjrl.policies.gaussian_mlp")
    mods = {n: types.ModuleType(n) for n in names}
    gen = torch.Generator().manual_seed(seed)
    rand = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)

    class FCNetwork(nn.Module):
        def __init__(self):
            super().__init__()
            self.obs_dim, self.act_dim = sizes[0], sizes[-1]
            with torch.random.fork_rng(devices=[]):
                self.fc_layers = nn.ModuleList(
                    nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
            with torch.no_grad():
                for lyr in self.fc_layers:
                    n_in = lyr.weight.shape[1]
                    lyr.weight.copy_(rand(*lyr.weight.shape)
                                     / math.sqrt(n_in))
                    lyr.bias.copy_(0.1 * rand(lyr.bias.shape[0]))
            self.nonlinearity = torch.tanh
            self.in_shift, self.out_shift = rand(sizes[0]), 0.1 * rand(
                sizes[-1])
            self.in_scale = 0.5 + rand(sizes[0]).abs()
            self.out_scale = 0.5 + rand(sizes[-1]).abs()

    class MLP:
        def __init__(self):
            self.n, self.m = sizes[0], sizes[-1]
            self.model = FCNetwork()
            self.log_std = -1.0 + 0.1 * rand(sizes[-1])

    for cls, mod in ((FCNetwork, "mjrl.utils.fc_network"),
                     (MLP, "mjrl.policies.gaussian_mlp")):
        cls.__module__, cls.__qualname__ = mod, cls.__name__
        setattr(mods[mod], cls.__name__, cls)
    before = {n: sys.modules.get(n) for n in names}
    sys.modules.update(mods)
    try:
        with open(path, "wb") as f:
            pickle.dump(MLP(), f)
    finally:
        for n, m in before.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    return path


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
    entries += compare_narrow(envs, VectorEnv, random_actions, dev)
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

    import tempfile
    with tempfile.TemporaryDirectory() as keep:
        runs = [trainer_phase(TK, envs, dev, info, keep),
                learners_phase(TK, envs, dev, info),
                pixel_phase(TK, envs, dev, info),
                cli_phase(TK, envs, dev, info, keep)]
    for launches in runs:
        for name, n in launches.items():
            total[name] += n
    log(f"[9] launches: main path (phase 5), PPO trainer (phase 6), "
        f"learners (phase 7), the pixel path (phase 8a-8c) and the CLIs and "
        f"distributed runtime (phase 9a-9d) together: {json.dumps(total)}")
    for e in entries:
        e["launches"] = total[e["name"]]

    log(info)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
