"""Print the errors behind the bounds of this slice's tests, per seed,
with the worst (CPU):

    JAX_PLATFORMS=cpu python tests/measure_torch_f64_floors.py \
        [f64] [stages] [f32] [oracle] [env_state]

* f64: `test_torch_f64.py`'s stages, substeps and hammer trajectory;
* stages: `test_torch_f64.py`'s stages at 1 and at 6 torch threads, each
  stage's max |error|, its max |value| and the error in units of
  eps64 x max |value| (the unit of the bounds in `REL_BOUNDS`);
* f32: the 50-substep trajectory of each task file (`test_torch_hammer.py`
  and its siblings);
* oracle: `test_torch_oracle.py`, the port's float64 step against mujoco;
* env_state: `test_torch_env_state.py`'s forward after
  `set_physics_state`, qacc and efc_force relative to their largest
  value, for seeds 4 (the test's), 5 and 6; then, on pen at seed 6 in
  float64, how far apart the two packages put the cylinder-box contacts.

Seeds 0, 1 and 2 unless said; each bound is 2-4x the worst printed here.
(Not collected by pytest: the name does not start with `test_`.)
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, x64 as in the tests)
import numpy as np  # noqa: E402
import torch  # noqa: E402

SEEDS = (0, 1, 2)


def show(title, per_seed):
    print(title)
    for k in per_seed[0]:
        vals = [e[k] for e in per_seed]
        print(f"  {k:24s} " + "  ".join(f"{v:.2e}" for v in vals)
              + f"   worst {max(vals):.2e}", flush=True)


def main():
    torch.set_num_threads(2)
    what = sys.argv[1:] or ["f64", "stages", "f32", "oracle", "env_state"]
    if "f64" in what:
        import test_torch_f64 as F
        show("stages (hammer)", [F.stage_errors(s) for s in SEEDS])
        for task in F.TASKS:
            show(f"substep {task}", [F.substep_errors(task, s)
                                     for s in SEEDS])
        show("hammer 50 substeps", [F.trajectory_errors(s) for s in SEEDS])
    if "stages" in what:
        stages_scaled()
    if "f32" in what:
        import test_torch_hammer as TH
        for task in ("hammer-v0", "door-v0", "pen-v0", "relocate-v0"):
            p = TH.make_pair(task)
            show(f"f32 50 substeps {task}",
                 [TH.trajectory_errors(p, s) for s in SEEDS])
    if "oracle" in what:
        import test_torch_oracle as TO
        for task in TO.TASKS:
            show(f"oracle {task}", [TO.oracle_errors(task, s)
                                    for s in SEEDS])

    if "env_state" in what:
        env_state()


def stages_scaled():
    import test_torch_f64 as F
    eps = float(np.finfo(np.float64).eps)
    worst = {}
    for threads in (1, 6):
        torch.set_num_threads(threads)
        for seed in SEEDS:
            scales = {}
            errs = F.stage_errors(seed, scales)
            print(f"stages, seed {seed}, {threads} thread(s): "
                  "error / max |value| / error in eps64 x max |value|")
            for k, e in errs.items():
                u = e / (eps * scales[k])
                worst[k] = max(worst.get(k, 0.0), u)
                print(f"  {k:24s} {e:.3e}  {scales[k]:.3e}  {u:.3g}",
                      flush=True)
    print("worst in eps64 x max |value| (seeds 0-2, 1 and 6 threads):")
    for k, u in worst.items():
        print(f"  {k:24s} {u:.3g}   4x: {4 * u:.3g}")
    torch.set_num_threads(2)


def env_state():
    import test_torch_env_state as E
    for task in E.TASKS:
        rows = []
        for seed in (4, 5, 6):
            _, _, _, out_t, out_j, _, _ = E.set_state_pair(task, seed)
            e = {}
            for f in ("qacc", "efc_force"):
                want = np.asarray(getattr(out_j.data, f), np.float64)
                got = getattr(out_t.data, f).double().numpy()
                e[f] = np.abs(got - want).max() / np.abs(want).max()
            rows.append(e)
        show(f"set_physics_state {task} (seeds 4, 5, 6; of the scale)", rows)
    cylinder_box_pen_seed6()


def cylinder_box_pen_seed6():
    """pen, seed 6 of `set_state_pair`, in float64 on both sides: the
    largest distance between the two packages' contact points and their
    depths over the active cylinder-box slots."""
    import jax.numpy as jnp
    from mj_envs_tpu.physics import kinematics as JK
    from mj_envs_tpu.physics.collision import driver as JC
    from mj_envs_torch.physics import kinematics as TK
    from mj_envs_torch.physics.collision import driver as TC
    from mj_envs_torch.physics.model import GEOM_BOX, GEOM_CYLINDER
    import test_torch_env_state as E
    import test_torch_f64 as F
    _, _, st_t, _, _, qpos, _ = E.set_state_pair("pen-v0", 6)
    w = F.make_world("pen-v0", 6, substeps=0)
    tm = w["tm"].replace(**{f: t.double() for f, t in st_t.var.items()})
    var = w["var"].__class__(**{
        f: None if getattr(w["var"], f) is None
        else jnp.asarray(getattr(st_t.var, f).double().numpy())
        for f in w["var"].__dataclass_fields__})
    q = qpos.astype(np.float64)
    full_j = F.jvmap(w, lambda m, x: JC.narrowphase_all(
        m, JK.kinematics(m, x)))(var, q)
    full = TC.narrowphase_all(tm, TK.kinematics(tm, torch.as_tensor(q)))
    start, dp, dd = 0, 0.0, 0.0
    for key, pids in TC._groups(tm.spec):
        n = len(pids) * TC._SLOTS[key]
        if key == (GEOM_CYLINDER, GEOM_BOX):
            sl = slice(start, start + n)
            act = np.asarray(full_j.active)[:, sl] & \
                full.active[:, sl].numpy()
            p = np.linalg.norm(full.pos[:, sl].numpy()
                               - np.asarray(full_j.pos)[:, sl], axis=-1)
            d = np.abs(full.dist[:, sl].numpy()
                       - np.asarray(full_j.dist)[:, sl])
            dp, dd = float(p[act].max()), float(d[act].max())
        start += n
    print(f"pen seed 6, float64, cylinder-box slots in contact: contact "
          f"points up to {dp:.2e} apart, depths within {dd:.2e}")


if __name__ == "__main__":
    main()
