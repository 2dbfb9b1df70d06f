"""Measure the floors behind the learner tests' tolerances: the worst
error over seeds 0, 1 and 2 of each quantity the tests bound.

    JAX_PLATFORMS=cpu python tests/measure_torch_learner_floors.py \
        [networks] [ppo] [npg] [sac] [npg_pair] [sac_pair] [pixel_ppo] \
        [planet]
    python tests/measure_torch_learner_floors.py card_pairs   # on a card
    python tests/measure_torch_learner_floors.py card_pixel_pairs  # card

* networks: `test_torch_networks.py`, the actor-critic, log-prob and
  entropy against the JAX package in float64 and float32;
* ppo: `test_torch_ppo.py`, GAE, the loss and gradients, Adam, the whole
  update (float64, float32) and one door-v0 iteration (float64);
* npg: `test_torch_npg.py`, the baseline, the Fisher-vector product and
  CG, a toy-env iteration without and with demos (float64) and one
  door-v0 iteration (float64, float32); `test_torch_dapg.py`'s door-v0
  iteration with demos (float64);
* sac: `test_torch_sac.py`, `_sample_tanh` and `_q_apply` (float64,
  float32), one update and two iterations on the toy env (float64) and
  two door-v0 iterations (float64, float32);
* npg_pair: `chip_smoke.py` phase 7d's NPG iteration (64 door-v0 envs
  x 2 steps, policy (32, 32)) on the CPU, stage by stage (`npg_diffs`):
  float32 against float64, and float64 against itself with another sum
  order (the baseline solved by Cholesky or with its columns reversed,
  the CG's dot products reversed, the Fisher's rows permuted, 1 thread
  against 4): the readings behind `NPG_PAIR_BOUNDS` (4x the worst);
* sac_pair: phase 7d's SAC iteration (8 relocate-v0 envs x 2 steps, 2
  updates at batch 8) on the CPU, float32 against float64 (`sac_diffs`):
  the readings behind `SAC_PAIR_BOUNDS` (4x the worst);
* pixel_ppo: `test_torch_pixel_ppo.py`, one pixel-PPO rollout of 4
  hammer-v0 envs x 2 steps (float32, 1 thread) and the update on its
  JAX trajectory (float64, float32);
* planet: `test_torch_planet.py`, the loss and gradients and one update
  (float64) and the float32 planner's top-k swaps;
* card_pairs (on a machine with a card; imports no JAX): phase 7d's
  pairs card against CPU at seeds 0-2, NPG also at 8 envs x 2 steps and
  twice on the card in float64, and the CPU's float64 iteration at 1
  thread against all its cores.
* card_pixel_pairs (on a machine with a card; imports no JAX): phase 8's
  pairs card against CPU at seeds 0-2: the pixel-PPO rollout and its
  update on one shared trajectory (float32, float64), and PlaNet's
  update at full width on one synthetic batch (float32, float64: the
  losses, gradients and params): the readings behind
  `PIXEL_PAIR_BOUNDS`, `PIXEL_UPDATE_BOUNDS` and `PLANET_UPDATE_BOUNDS`.

(Not collected by pytest: the name does not start with `test_`.)
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

SEEDS = (0, 1, 2)


def show(title, per_seed):
    print(title)
    for k in per_seed[0]:
        vals = [e[k] for e in per_seed]
        print(f"  {k:24s} " + "  ".join(f"{v:.2e}" for v in vals)
              + f"   worst {max(vals):.2e}", flush=True)


def fit_cholesky(feats, returns, reg):
    """`npg._fit_baseline` by a Cholesky solve in place of LU."""
    A = feats.T @ feats + reg * torch.eye(feats.shape[-1], dtype=feats.dtype)
    return torch.cholesky_solve((feats.T @ returns)[:, None],
                                torch.linalg.cholesky(A))[:, 0]


def witnesses(NPG):
    """Float64 re-orderings of one NPG iteration's sums on the CPU: name
    -> {attribute of `npg`: replacement}."""
    fit, fisher = NPG._fit_baseline, NPG.make_fisher_vp

    def fit_reversed(feats, returns, reg):
        perm = torch.arange(feats.shape[-1] - 1, -1, -1)
        w = torch.empty(feats.shape[-1], dtype=feats.dtype)
        w[perm] = fit(feats[:, perm], returns, reg)
        return w

    def cg_reversed(mvp, b, iters):
        dot = lambda u, v: (u.flip(0) * v.flip(0)).sum()
        x, r, p = torch.zeros_like(b), b.clone(), b.clone()
        rs = dot(b, b)
        for _ in range(iters):
            Ap = mvp(p)
            alpha = rs / torch.clamp(dot(p, Ap), min=1e-20)
            x, r = x + alpha * p, r - alpha * Ap
            rs_new = dot(r, r)
            p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
            rs = rs_new
        return x

    def fisher_rows_permuted(module, obs, damping):
        return fisher(module, obs.flip(0), damping)

    return {"baseline by Cholesky": dict(_fit_baseline=fit_cholesky),
            "baseline columns reversed": dict(_fit_baseline=fit_reversed),
            "CG dots reversed": dict(_conjugate_gradient=cg_reversed),
            "Fisher rows permuted": dict(make_fisher_vp=fisher_rows_permuted)}


def patched(module, attrs, fn):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def card_pairs():
    """Phase 7d's pairs card against CPU at seeds 0-2 (see the top)."""
    import chip_smoke as CS
    from mj_envs_torch import envs
    cores = torch.get_num_threads()
    for s in SEEDS:
        for n, steps in ((CS.NPG_PAIR_ENVS, CS.NPG_PAIR_STEPS), (8, 2)):
            runs, before = CS.npg_pair(envs, ["cuda", "cpu"], seed=s, n=n,
                                       steps=steps)
            show(f"seed {s}, NPG {n} x {steps}, float32, card vs CPU",
                 [CS.npg_diffs(*runs, before)])
            runs, before = CS.npg_pair(envs, ["cuda", "cuda", "cpu"],
                                       torch.float64, s, n, steps)
            show(f"seed {s}, NPG {n} x {steps}, float64, card vs CPU",
                 [CS.npg_diffs(runs[0], runs[2], before)])
            show(f"seed {s}, NPG {n} x {steps}, float64, card twice",
                 [CS.npg_diffs(runs[0], runs[1], before)])
            torch.set_num_threads(1)
            one, _ = CS.npg_pair(envs, ["cpu"], torch.float64, s, n, steps)
            torch.set_num_threads(cores)
            show(f"seed {s}, NPG {n} x {steps}, float64, CPU 1 thread vs "
                 f"{cores}", [CS.npg_diffs(one[0], runs[2], before)])
        runs, _ = CS.sac_pair(envs, ["cuda", "cpu"], seed=s)
        show(f"seed {s}, SAC, float32, card vs CPU", [CS.sac_diffs(*runs)])


def card_pixel_pairs():
    """Phase 8's pairs card against CPU at seeds 0-2 (see the top)."""
    import chip_smoke as CS
    from mj_envs_torch import envs
    from mj_envs_torch.algos import planet as PL
    from mj_envs_torch.utils.config import PlanetConfig, PPOConfig
    ppo = PPOConfig().load(os.path.join(CS.ROOT, CS.PPO_CONFIG))
    ppo.model_type = "cnn"
    planet = PlanetConfig().load(os.path.join(CS.ROOT, CS.PLANET_CONFIG))
    cfg = PL.cfg_from_config(planet, envs.make(planet.env_name,
                                               device="cpu").nu)
    for s in SEEDS:
        show(f"seed {s}, pixel PPO {CS.PAIR_ENVS} envs, card vs CPU",
             [CS.pixel_pair_diffs(CS.pixel_ppo_pair(envs, ["cuda", "cpu"],
                                                    ppo, seed=7 + s))])
        tree = PL.planet_to_numpy(PL.make_planet(cfg, device="cpu")[0](s)
                                  .params)
        out = CS.planet_update_pair(["cuda", "cpu"], cfg, tree, seed=11 + s)
        for dt in out:
            show(f"seed {s}, PlaNet update ({dt}), card vs CPU",
                 [CS.planet_update_diffs(out[dt], cfg.lr)])


def main():
    what = sys.argv[1:] or ["networks", "ppo", "npg", "sac", "npg_pair",
                            "sac_pair"]
    if "card_pairs" in what:
        return card_pairs()
    if "card_pixel_pairs" in what:
        return card_pixel_pairs()
    import conftest  # noqa: F401  (JAX on the CPU, x64 as in the tests)
    torch.set_num_threads(2)
    if "networks" in what:
        import test_torch_networks as TN
        for dt in (torch.float64, torch.float32):
            show(f"networks {dt}", [TN.network_errors(s, dt) for s in SEEDS])
    if "ppo" in what:
        import test_torch_ppo as TP
        show("gae (float64)", [TP.gae_errors(s) for s in SEEDS])
        show("loss and gradients (float64)",
             [TP.loss_grad_errors(s) for s in SEEDS])
        show("adam, 6 steps (float64)",
             [dict(params=TP.adam_errors(s)) for s in SEEDS])
        for dt in (torch.float64, torch.float32):
            show(f"update 2 x 4 ({dt})",
                 [TP.update_errors(s, dt) for s in SEEDS])
        show("door-v0 iteration (float64)",
             [TP.iteration_errors(torch.float64, s) for s in SEEDS])

    if "pixel_ppo" in what:
        import test_torch_pixel_ppo as TPP
        torch.set_num_threads(1)
        show("pixel PPO rollout, hammer 4 x 2 (float32)",
             [TPP.pixel_iteration_errors(s) for s in SEEDS])
        for dt in (torch.float64, torch.float32):
            show(f"pixel PPO update on the JAX trajectory ({dt})",
                 [TPP.pixel_update_errors(s, dt) for s in SEEDS])
        torch.set_num_threads(2)
    if "planet" in what:
        import test_torch_planet as TPL
        show("loss and gradients (float64)",
             [TPL.loss_errors(s, torch.float64) for s in SEEDS])
        show("update (float64)",
             [TPL.update_errors(s, torch.float64) for s in SEEDS])
        show("float32 plan, top-k swaps per iteration (worst)",
             [dict(swaps=TPL.f32_swaps(s)) for s in SEEDS])

    if "npg" in what:
        import test_torch_dapg as TD
        import test_torch_npg as TNPG
        show("baseline (float64)", [TNPG.baseline_errors(s) for s in SEEDS])
        show("Fisher-vector product and CG (float64)",
             [TNPG.fisher_errors(s) for s in SEEDS])
        for demos in (False, True):
            show(f"toy iteration, demos {demos} (float64)",
                 [TNPG.toy_errors(s, demos)[0] for s in SEEDS])
        show("door-v0 iteration (float64)",
             [TNPG.door_errors(torch.float64, s) for s in SEEDS])
        show("door-v0 iteration (float32)",
             [TNPG.door_f32_errors(s) for s in SEEDS])
        show("door-v0 iteration with demos (float64)",
             [TD.dapg_door_errors(s) for s in SEEDS])
    if "sac" in what:
        import test_torch_sac as TS
        for dt in (torch.float64, torch.float32):
            show(f"sample_tanh and q ({dt})",
                 [TS.piece_errors(s, dt) for s in SEEDS])
        show("toy update (float64)", [TS.update_once_errors(s) for s in SEEDS])
        show("toy iterations (float64)",
             [{f"{k}_{i + 1}": v for i, r in enumerate(TS.toy_runs(s))
               for k, v in r["errors"].items()} for s in SEEDS])
        for dt in (torch.float64, torch.float32):
            show(f"door-v0 iterations ({dt})",
                 [TS.door_errors(dt, s) for s in SEEDS])

    if "npg_pair" in what or "sac_pair" in what:
        import chip_smoke as CS
        from mj_envs_torch import envs
        from mj_envs_torch.algos import npg as NPG
    if "npg_pair" in what:
        gaps, worst = [], []
        for s in SEEDS:
            pair = lambda dt: CS.npg_pair(envs, ["cpu"], dt, s)
            r64, before = pair(torch.float64)
            gaps.append(CS.npg_diffs(pair(torch.float32)[0][0], r64[0],
                                     before))
            torch.set_num_threads(1)
            one = pair(torch.float64)[0][0]
            torch.set_num_threads(4)
            rows = {"1 thread vs 4": CS.npg_diffs(one, r64[0], before)}
            for name, attrs in witnesses(NPG).items():
                rows[name] = CS.npg_diffs(
                    patched(NPG, attrs, lambda: pair(torch.float64))[0][0],
                    r64[0], before)
            show(f"seed {s}: float64 with another sum order, the CPU",
                 list(rows.values()))
            worst.append({k: max(r[k] for r in rows.values())
                          for k in gaps[-1]})
        show("NPG pair, float32 vs float64 on the CPU", gaps)
        show("NPG pair, float64 with another sum order (worst of the "
             "witnesses)", worst)
    if "sac_pair" in what:
        gaps = []
        for s in SEEDS:
            a = CS.sac_pair(envs, ["cpu"], torch.float32, s)[0][0]
            b = CS.sac_pair(envs, ["cpu"], torch.float64, s)[0][0]
            gaps.append(CS.sac_diffs(a, b))
        show("SAC pair, float32 vs float64 on the CPU", gaps)

if __name__ == "__main__":
    main()
