"""The bound counts against the port's kernel table (PERF.md, findings,
"Kernel table": bound µs at B = 512, hammer's nv = 33, R = 129 noslip
rows, 296 solver rows)."""
import pytest
import torch

from benchmark.lib import bounds

B, NV, R, NEFC = 512, 33, 129, 296


def z(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("fn,args,table_us", [
    (bounds.chol_factor, (z(B, NV, NV),), 1.01),
    (bounds.chol_solve_fac, (z(B, NV, NV), z(B, NV, R)), 5.55),
    (bounds.chol_solve_fac, (z(B, NV, NV), z(B, NV, 1)), 0.38),
    (bounds.chol_factor_solve, (z(B, NV, NV), z(B, NV)), 0.38),
    (bounds.chol_factor_solve, (z(B, 30, 30), z(B, 30)), 0.32),
    (bounds.chol_factor_solve, (z(B, 36, 36), z(B, 36)), 0.45),
    (bounds.linesearch_cost, (z(B, NEFC),) * 5 + (z(B), z(B), 12, 16), 0.82),
    (bounds.noslip_sweep, (z(B, R, R),), 10.73),
])
def test_kernel_bounds(fn, args, table_us):
    assert fn(*args) * 1e6 == pytest.approx(table_us, abs=0.006)


def test_fk_bound_hammer():
    # The table's hammer entry carries body_pos, body_mass and geom_pos
    # per env (chip_smoke.py phase 3), the others their task's fields.
    from mj_envs_torch import envs
    env = envs.make("hammer-v0", device="cpu")
    m = env.model
    m = m.replace(**{f: getattr(m, f).expand((B,) + getattr(m, f).shape)
                     for f in ("body_pos", "body_mass", "geom_pos")})
    assert bounds.fk(m, z(B, env.nq)) * 1e6 == pytest.approx(1.99, abs=0.006)


def test_bound_is_the_larger_of_the_two():
    assert bounds.seconds(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.seconds(0, 67e12) == pytest.approx(1.0)
    assert bounds.seconds(3.35e12, 2 * 67e12) == pytest.approx(2.0)
