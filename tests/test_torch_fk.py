"""The FK front end of the PyTorch port against the JAX package, on all
four tasks (float32, CPU).

On the CPU `kinematics` runs its plain version (`kinematics_plain`); it
is held against the JAX `_kinematics_ref` under `jax.vmap`, the batched
path the JAX package takes off the TPU.  The TPU kernel `fk_pallas` is
not run here: the JAX package itself calls it impractically slow in
interpret mode on the CPU (`tests/test_tpu_e2e.py`), and
`_kinematics_ref` is the math it computes.  The CUDA kernel (`csrc/fk.cu`)
is held against the plain version on the card by
`tests/test_torch_cuda.py` and `chip_smoke.py`.

Each task runs twice: with every model field shared by the envs, and
with the fields that task varies per env (hammer body_pos, body_mass and
geom_pos; door body_pos; pen body_quat; relocate body_pos and site_pos)
carried per env, as a task's ModelVar carries them.  Tolerance
2e-5 * max(1, |x|) per field, the JAX package's own limit for its FK
kernel against `_kinematics_ref` (`tests/test_kernels.py`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.physics import kinematics as JK
from mj_envs_torch import envs as tenvs
from mj_envs_torch.physics import kinematics as TK
from mj_envs_torch.physics.model import JNT_HINGE, JNT_SLIDE, Model

B = 8
PER_ENV = {
    "hammer-v0": ("body_pos", "body_mass", "geom_pos"),
    "door-v0": ("body_pos",),
    "pen-v0": ("body_quat",),
    "relocate-v0": ("body_pos", "site_pos"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # xdist runs six workers on the CPU: keep torch from oversubscribing.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _per_env_fields(jm, names, rng):
    """Seeded per-env copies (B, ...) of the named model fields."""
    out = {}
    for name in names:
        base = np.asarray(getattr(jm, name), dtype=np.float32)
        x = np.broadcast_to(base, (B,) + base.shape)
        if name == "body_quat":
            x = x + 0.2 * rng.standard_normal(x.shape)
            x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        elif name == "body_mass":
            x = x * rng.uniform(0.5, 2.0, x.shape)
        else:
            x = x + 0.02 * rng.standard_normal(x.shape)
        out[name] = x.astype(np.float32)
    return out


def _assert_kin_close(k_t, k_j, label):
    for f in TK.Kin._fields:
        a = np.asarray(getattr(k_j, f))
        b = getattr(k_t, f).numpy()
        assert a.shape == b.shape, (label, f, a.shape, b.shape)
        scale = max(1.0, float(np.max(np.abs(a))) if a.size else 1.0)
        err = float(np.max(np.abs(a - b))) if a.size else 0.0
        assert err <= 2e-5 * scale, (label, f, err, scale)


@pytest.mark.parametrize("task", sorted(PER_ENV))
def test_fk_matches_jax_kinematics_ref(task):
    jm = jenvs.make(task).model
    spec = tenvs.make(task, device="cpu").spec
    s = jm.spec
    rng = np.random.default_rng(3)
    qpos = (np.asarray(jm.qpos0)[None]
            + 0.3 * rng.standard_normal((B, s.nq))).astype(np.float32)
    tm = Model.from_numpy({n: np.asarray(getattr(jm, n))
                           for n in Model.leaf_names()},
                          spec, device="cpu")

    def jax_fk(fields):
        fn = lambda f, q: JK._kinematics_ref(jm.replace(**f), q)  # noqa: E731
        return jax.jit(jax.vmap(fn, in_axes=({k: 0 for k in fields}, 0)))(
            {k: jnp.asarray(v) for k, v in fields.items()},
            jnp.asarray(qpos))

    k_j = jax_fk({})
    k_t = TK.kinematics(tm, torch.as_tensor(qpos))
    _assert_kin_close(k_t, k_j, f"{task} shared")

    fields = _per_env_fields(jm, PER_ENV[task], rng)
    k_j = jax_fk(fields)
    k_t = TK.kinematics(tm.replace(**{k: torch.as_tensor(v)
                                      for k, v in fields.items()}),
                        torch.as_tensor(qpos))
    _assert_kin_close(k_t, k_j, f"{task} per-env {sorted(fields)}")


@pytest.mark.parametrize("task", sorted(PER_ENV))
def test_fk_table_encodes_the_tree(task):
    """The int32 table the CUDA kernel walks (layout in csrc/fk.cu):
    parents before children, each body's joints in joint order, and the
    id arrays of the spec."""
    s = tenvs.make(task, device="cpu").spec
    nb, nj, ng, ns = s.nbody, s.njnt, s.ngeom, s.nsite
    tab = TK.fk_table(s)
    assert tab.dtype == np.int32
    nlevel = tab.size - (5 * nb + 1 + 4 * nj + ng + ns) - 1
    assert nlevel >= 1
    parent, tab = tab[:nb], tab[nb:]
    adr, tab = tab[:nb + 1], tab[nb + 1:]
    order, jtype, qadr, jbody, tab = np.split(tab, [nj, 2 * nj, 3 * nj,
                                                    4 * nj])
    gbody, sbody, root = tab[:ng], tab[ng:ng + ns], tab[ng + ns:ng + ns + nb]
    np.testing.assert_array_equal(parent, s.body_parentid)
    assert np.all(parent[1:] < np.arange(1, nb))
    for b in range(nb):
        np.testing.assert_array_equal(
            order[adr[b]:adr[b + 1]], np.flatnonzero(s.jnt_bodyid == b))
    assert adr[-1] == nj
    np.testing.assert_array_equal(jtype, s.jnt_type)
    assert np.all((jtype == JNT_HINGE) | (jtype == JNT_SLIDE))
    np.testing.assert_array_equal(qadr, s.jnt_qposadr)
    np.testing.assert_array_equal(jbody, s.jnt_bodyid)
    np.testing.assert_array_equal(gbody, s.geom_bodyid)
    np.testing.assert_array_equal(sbody, s.site_bodyid)
    np.testing.assert_array_equal(root, s.body_rootid)


@pytest.mark.parametrize("task", sorted(PER_ENV))
def test_fk_table_levels_and_subtrees(task):
    """The table's tail, which the kernel's level-parallel walk and its
    subtree sums read: subtree sizes, the bodies in depth order and the
    offset of each level.  Every body's parent lies in an earlier level,
    each level in id order, and body b's subtree is the id range
    [b, b + size_b) of `spec.subtree_mask`."""
    s = tenvs.make(task, device="cpu").spec
    nb = s.nbody
    tab = TK.fk_table(s)
    head = 5 * nb + 1 + 4 * s.njnt + s.ngeom + s.nsite   # to by_depth's end
    size, by_depth = tab[head - 2 * nb:head - nb], tab[head - nb:head]
    level_adr = tab[head:]
    assert level_adr[0] == 0 and level_adr[-1] == nb
    assert np.all(np.diff(level_adr) > 0)
    assert sorted(by_depth) == list(range(nb))
    level = np.empty(nb, dtype=np.int64)
    for L in range(len(level_adr) - 1):
        bodies = by_depth[level_adr[L]:level_adr[L + 1]]
        assert np.all(np.diff(bodies) > 0)
        level[bodies] = L
    assert by_depth[0] == 0 and level_adr[1] == 1    # the world alone
    parent = np.asarray(s.body_parentid)
    assert np.all(level[parent[1:]] == level[1:] - 1)
    mask = np.asarray(s.subtree_mask, dtype=bool)
    for b in range(nb):
        want = np.zeros(nb, dtype=bool)
        want[b:b + size[b]] = True
        np.testing.assert_array_equal(mask[b], want)


def test_fk_dispatch_and_limits():
    """A CPU qpos takes the plain version (no launch counted); a qpos on
    another non-CUDA device raises; a model beyond the shared memory of
    the kernel's block or with another joint type is refused by name."""
    from mj_envs_torch.physics import kernels
    env = tenvs.make("door-v0", device="cpu")
    kernels.reset_launches()
    TK.kinematics(env.model, env.model.qpos0[None])
    assert kernels.launches["fk"] == 0
    with pytest.raises(TypeError):
        TK.kinematics(env.model, torch.empty(2, env.nq, device="meta"))
    s = env.spec
    assert TK.fk_smem_bytes(s, s.nbody) < TK.FK_MAX_SMEM // 4
    nb = 400                  # a chain of 400 bodies, 400 levels
    big = type(s)(**{**vars(s), "nbody": nb,
                     "body_parentid": np.arange(-1, nb - 1)})
    assert TK.fk_smem_bytes(big, nb) > TK.FK_MAX_SMEM
    with pytest.raises(ValueError, match=str(TK.FK_MAX_SMEM)):
        TK.fk_table(big)
    ball = type(s)(**{**vars(s), "jnt_type": np.full(s.njnt, 1)})
    with pytest.raises(ValueError, match="hinge and slide"):
        TK.fk_table(ball)
    gap = np.eye(s.nbody, dtype=bool)
    gap[0] = True
    gap[1, 3] = True          # body 1's subtree {1, 3}: not a range
    with pytest.raises(ValueError, match="depth-first"):
        TK.fk_table(type(s)(**{**vars(s), "subtree_mask": gap}))
