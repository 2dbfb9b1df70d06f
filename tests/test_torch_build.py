"""The port's MJCF parse and model build against the JAX build.

Every ModelSpec field and every Model leaf of the port equals the JAX
package's: integer, boolean and static fields exactly, float leaves at
rtol 1e-6.  The inverse weights are computed by the port (M^-1 at qpos0
in float64, then cast) while the JAX f32 build may have computed them in
float32, so in f32 they are held at rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.mjcf import builder as JB, task_xml_path as jxml
from mj_envs_torch import envs as tenvs
from mj_envs_torch.mjcf import builder as TB, task_xml_path as txml
from mj_envs_torch.physics.model import Model

# Declared by the JAX ModelSpec but never set or read by the JAX package.
_UNUSED_SPEC_FIELDS = {"body_treelevels"}
_INVWEIGHTS = {"dof_invweight0", "body_invweight0", "ten_invweight0"}


def _compare_spec(js, ts):
    keys = set(vars(js)) - _UNUSED_SPEC_FIELDS
    assert keys <= set(vars(ts)), sorted(keys - set(vars(ts)))
    for k in sorted(keys):
        a, b = getattr(js, k), getattr(ts, k)
        if isinstance(a, np.ndarray):
            assert a.shape == np.asarray(b).shape, k
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=k)
            assert a.dtype.kind == np.asarray(b).dtype.kind, k
        else:
            assert a == b, k


def _compare_model(jm, tm, dtype, inv_rtol):
    assert set(Model.leaf_names()) == set(jm.__dataclass_fields__) - {"spec"}
    for name in Model.leaf_names():
        a = np.asarray(getattr(jm, name))
        t = getattr(tm, name)
        b = t.cpu().numpy()
        assert a.shape == b.shape, name
        if a.dtype == np.bool_:
            assert t.dtype == torch.bool, name
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        assert t.dtype == dtype, name
        rtol = inv_rtol if name in _INVWEIGHTS else 1e-6
        np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=name)


def test_hammer_env_model_f32_matches_jax():
    """The env's model (actuator override included), float32."""
    jenv = jenvs.make("hammer-v0")
    tenv = tenvs.make("hammer-v0", device="cpu")
    _compare_spec(jenv.model.spec, tenv.model.spec)
    _compare_model(jenv.model, tenv.model, torch.float32, inv_rtol=1e-5)
    np.testing.assert_allclose(tenv.act_mid.numpy(), np.asarray(jenv.act_mid))
    np.testing.assert_allclose(tenv.act_rng.numpy(), np.asarray(jenv.act_rng))
    assert tenv.ncmax == jenv.ncmax == 32


def test_hammer_build_f64_matches_jax():
    jm = JB.build_from_xml(jxml("hammer"), dtype=np.float64)
    tm = TB.build_from_xml(txml("hammer"), dtype=torch.float64, device="cpu")
    _compare_spec(jm.spec, tm.spec)
    _compare_model(jm, tm, torch.float64, inv_rtol=1e-6)


def test_hammer_shapes():
    """The sizes the port's kernels are built for (PERF.md)."""
    s = tenvs.make("hammer-v0", device="cpu").spec
    assert (s.nq, s.nv, s.nu, s.nbody, s.ngeom, s.nsite, s.njnt) == \
        (33, 33, 26, 31, 36, 30, 33)
    assert (s.npair, s.iterations, s.noslip_iterations) == (257, 20, 20)
    assert int(np.sum(s.dof_hasfrictionloss)) == 33
    nrows = 33 + int(np.sum(s.jnt_limited)) + int(np.sum(s.ten_limited))
    assert nrows + 6 * 32 == 296


@pytest.mark.parametrize("task", ["door", "pen", "relocate"])
def test_other_tasks_parse_and_build(task):
    """Spec and f32 leaves of the other three tasks match too, and each
    scene collides at qpos0 (relocate's through the sphere pair
    functions, which `test_torch_physics.py` holds against JAX)."""
    jm = JB.build_from_xml(jxml(task), dtype=np.float32)
    tm = TB.build_from_xml(txml(task), dtype=torch.float32, device="cpu")
    _compare_spec(jm.spec, tm.spec)
    _compare_model(jm, tm, torch.float32, inv_rtol=1e-5)
    assert jnp.asarray(jm.qpos0).dtype == jnp.float32

    from mj_envs_torch.physics import kinematics as K
    from mj_envs_torch.physics.collision import driver as C
    s = tm.spec
    con, cc = C.collide(tm, K.kinematics(tm, tm.qpos0[None]), 32)
    assert con.dist.shape == (1, s.ncon_cap)
    assert bool(torch.isfinite(con.dist).all())
