"""Cylinder-box contacts at deep penetration: both packages compute the
same thing, and a tie in the box's support gradient is what splits them
(float64, CPU).

On pen at `tests/test_torch_env_state.py`'s `set_state_pair(seed=6)`
(fingers pressed into the pen), the two packages' cylinder-box contacts
were up to 5.3e-2 apart in float64 (`python
tests/measure_torch_f64_floors.py env_state`).  The inputs below are the
worst pair there (pair 121, env 3: a finger cylinder 1.26e-2 deep in a
box), as the port's FK and the JAX package's FK give them; they differ
by at most 4.4e-16.

* On the same inputs the port and the jitted JAX `cylinder_box` give the
  same depths and points bit for bit, and normals within 6.9e-18 (XLA
  rounds the last normalisation otherwise): the alternating projections,
  the candidate gaps, every polish step and the witness switch are the
  same code.
* The polish starts on a box face normal, -m2[:, 1] (candidate 7 wins,
  equal to the projections' own gap to 1e-17).  There the box's support
  gradient is the sign of the box-local direction, and its first
  component is m2[:, 0] . m2[:, 1], the frame's orthogonality residue:
  -6.2e-18 from the port's FK, +6.0e-18 from the JAX package's.  Its
  sign picks one corner of the face; the ascent climbs from there to one
  of two local maxima of the support gap, 5.5e-4 apart in depth and
  5.3e-2 apart in position.  The margin of that threshold is the
  residue itself: nudging m2[:, 0] by 1e-15 m2[:, 1] moves either input
  to the other branch, in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu.physics.collision import narrowphase as JN
from mj_envs_torch.physics.collision import narrowphase as TN


def _arr(*hexes):
    return np.array([float.fromhex(h) for h in hexes])


# (p1, m1, s1, p2, m2, s2): cylinder (geom 30) and box (geom 10).
_SHARED = dict(
    p1=_arr("0x1.e6ea812805aadp-8", "-0x1.cda772199999ap-3",
            "0x1.819ea09960485p-3"),
    s1=_arr("0x1.eb851eb851eb8p-7", "0x1.0a3d70a3d70a4p-4", "0x0.0p+0"),
    s2=_arr("0x1.0624dd2f1a9fcp-5", "0x1.6bb98c7e28241p-7",
            "0x1.916872b020c4ap-5"))
INPUTS = {
    "port_fk": dict(
        _SHARED,
        m1=_arr("-0x1.f320af13e1200p-8", "-0x1.cd354bea69d31p-5",
                "0x1.ff2c4cd3ba826p-1", "-0x1.1863ccd8a6b73p-5",
                "0x1.fee5569a51daep-1", "0x1.cad1b49f50f7fp-5",
                "-0x1.ffaf65e1a4dc0p-1", "-0x1.14714c418694bp-5",
                "-0x1.382b536e35f80p-7").reshape(3, 3),
        p2=_arr("0x1.b6c1ef56ab05ep-7", "-0x1.dc136254396d6p-3",
                "0x1.9e640fd8f68adp-3"),
        m2=_arr("0x1.ffb74e8484f6bp-1", "0x1.c3dcb12bca530p-10",
                "0x1.106dfb12001dcp-5", "-0x1.10cb948882832p-5",
                "0x1.ae524cd3f9a90p-5", "0x1.ff023ea98d2dfp-1",
                "-0x1.bce4ade834c00p-16", "-0x1.ff4ad7f53ddefp-1",
                "0x1.ae8d948a8b000p-5").reshape(3, 3)),
    "jax_fk": dict(
        _SHARED,
        m1=_arr("-0x1.f320af13e1000p-8", "-0x1.cd354bea69d30p-5",
                "0x1.ff2c4cd3ba824p-1", "-0x1.1863ccd8a6b72p-5",
                "0x1.fee5569a51daep-1", "0x1.cad1b49f50f7fp-5",
                "-0x1.ffaf65e1a4dbep-1", "-0x1.14714c418694bp-5",
                "-0x1.382b536e35f00p-7").reshape(3, 3),
        p2=_arr("0x1.b6c1ef56ab05ep-7", "-0x1.dc136254396d5p-3",
                "0x1.9e640fd8f68acp-3"),
        m2=_arr("0x1.ffb74e8484f6bp-1", "0x1.c3dcb12bca533p-10",
                "0x1.106dfb12001ddp-5", "-0x1.10cb948882833p-5",
                "0x1.ae524cd3f9a60p-5", "0x1.ff023ea98d2e2p-1",
                "-0x1.bce4ade834cf2p-16", "-0x1.ff4ad7f53ddf2p-1",
                "0x1.ae8d948a8afd0p-5").reshape(3, 3)),
}
ORDER = ("p1", "m1", "s1", "p2", "m2", "s2")
# The perturbation that moves an input across the tie, and how far the
# result may then lie from the other input's (the perturbation's own
# effect on the depth, point and normal, measured at most 3.7e-16).
NUDGE, AFTER_NUDGE = 1e-15, 1e-15


def port(inp):
    d, p, n = TN.cylinder_box(
        *[torch.as_tensor(inp[k])[None] for k in ORDER],
        torch.zeros(1, dtype=torch.float64))
    return d[0].numpy(), p[0].numpy(), n[0].numpy()


_jax_cylinder_box = jax.jit(JN.cylinder_box)


def jax_pkg(inp):
    return tuple(np.asarray(x) for x in
                 _jax_cylinder_box(*[jnp.asarray(inp[k]) for k in ORDER]))


def residue(inp):
    """m2[:, 0] . m2[:, 1]: the box-local first component of the polish's
    first support direction, whose sign decides the tie."""
    return float(inp["m2"][:, 0] @ inp["m2"][:, 1])


def nudged(inp, sign):
    m2 = inp["m2"].copy()
    m2[:, 0] = m2[:, 0] + sign * NUDGE * m2[:, 1]
    return dict(inp, m2=m2)


def test_inputs_differ_in_the_last_bits_only():
    a, b = INPUTS["port_fk"], INPUTS["jax_fk"]
    assert max(np.abs(a[k] - b[k]).max() for k in ORDER) <= 4.5e-16
    assert residue(a) < 0 < residue(b)
    assert max(abs(residue(a)), abs(residue(b))) < 1e-17


@pytest.mark.parametrize("which", sorted(INPUTS))
def test_port_equals_jax_bit_for_bit(which):
    (d, p, n), (wd, wp, wn) = port(INPUTS[which]), jax_pkg(INPUTS[which])
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(p, wp)
    np.testing.assert_allclose(n, wn, rtol=0, atol=1e-17)   # 6.9e-18


def test_the_tie_splits_the_two_inputs():
    (da, pa, _), (db, pb, _) = port(INPUTS["port_fk"]), port(INPUTS["jax_fk"])
    assert da[0] < 0 and db[0] < 0                 # both in deep contact
    assert abs(da[0] - db[0]) > 5e-4               # measured 5.52e-4
    assert np.linalg.norm(pa[0] - pb[0]) > 5e-2    # measured 5.29e-2


@pytest.mark.parametrize("impl", [port, jax_pkg], ids=["port", "jax"])
@pytest.mark.parametrize("which", sorted(INPUTS))
def test_the_residue_sign_decides_the_branch(impl, which):
    """Either input, nudged to either sign of the residue, lands on the
    branch of the input with that sign, in both packages."""
    by_sign = {np.sign(residue(v)): port(v) for v in INPUTS.values()}
    for sign in (1.0, -1.0):
        inp = nudged(INPUTS[which], sign)
        assert np.sign(residue(inp)) == sign
        d, p, n = impl(inp)
        wd, wp, wn = by_sign[sign]
        np.testing.assert_allclose(d, wd, rtol=0, atol=AFTER_NUDGE)
        np.testing.assert_allclose(p, wp, rtol=0, atol=AFTER_NUDGE)
        np.testing.assert_allclose(n, wn, rtol=0, atol=AFTER_NUDGE)
