"""The narrowphase kernels (`csrc/narrow_cyl.cu`, `csrc/narrow_plain.cu`)
from the CPU: their dispatch, counters, tables, probe generator and the
constants they share with the plain functions.

On the CPU `narrowphase_all` takes the plain functions in float32 and
float64 and launches nothing; under the tracer every (env, pair) row is
counted as a plain row.  The kernels themselves run only on the card
(`tests/test_torch_cuda.py` holds them against the plain functions
there, bit for bit).
"""
import inspect
import os
import re

import numpy as np
import pytest
import torch

from mj_envs_torch import envs, trace
from mj_envs_torch.physics import _build, kernels
from mj_envs_torch.physics.collision import driver as C
from mj_envs_torch.physics.collision import narrow_cuda as NC
from mj_envs_torch.physics.collision import narrowphase as NP

from narrow_probes import random_pairs
from test_torch_port_rules import REFERENCES

B = 2
NAMES = [name for name, _ in NC.KERNELS.values()]
KEYS = list(NC.KERNELS)
IDS = [name[len("narrow_"):] for name in NAMES]


@pytest.fixture(scope="module")
def hammer_states():
    """hammer-v0 on the CPU at B = 2 in float32 and float64, a reset."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        env = envs.make("hammer-v0", device="cpu", dtype=dtype)
        out[dtype] = (env, env.reset(B, env.generator(0)))
    return out


@pytest.fixture
def tracer():
    trace.enable()
    yield
    trace.enable(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_cpu_narrowphase_takes_the_plain_functions(hammer_states, tracer,
                                                   dtype):
    """No narrowphase kernel launches on the CPU; the tracer counts
    hammer's 257 pairs x B rows, its nine groups with a kernel among
    them, as plain rows and none as kernel rows."""
    env, st = hammer_states[dtype]
    before = dict(trace.counters)
    con = C.narrowphase_all(env.model, st.data)
    gained = trace.since(before)
    assert all(gained[k] == 0 for k in NAMES)
    assert gained.get("collide.kernel_rows", 0) == 0
    assert gained["collide.plain_rows"] == env.spec.npair * B == 257 * B
    assert len([k for k, _ in C._groups(env.spec) if k in NC.KERNELS]) == 9
    assert con.dist.dtype == dtype and con.dist.shape[1] == env.spec.ncon_cap


def test_names_are_counted_kernels_and_no_reference():
    assert set(NAMES) <= set(kernels.KERNELS)
    assert all(k in kernels.launches for k in NAMES)
    assert not set(NAMES) & set(REFERENCES)
    assert not any(r in n for r in REFERENCES for n in NAMES)
    assert "narrow_cyl.cu" in _build.SOURCES
    assert "narrow_plain.cu" in _build.SOURCES
    assert "narrow.cuh" in _build.HEADERS
    src = "".join(open(os.path.join(_build.CSRC, f)).read()
                  for f in ("narrow_cyl.cu", "narrow_plain.cu"))
    for name in NAMES:
        assert len(re.findall(rf"NARROW_ENTRY\({name},", src)) == 1, name


def test_kernel_trip_counts_are_the_plain_functions():
    """The kernels' fixed trip counts are narrowphase.py's."""
    src = "".join(open(os.path.join(_build.CSRC, f)).read()
                  for f in ("narrow_cyl.cu", "narrow_plain.cu"))
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+Iters|kSamples) = (\d+);", src)}
    fixed_point = re.findall(r"for _ in range\((\d+)\):",
                             inspect.getsource(NP.capsule_box))
    assert got == {"kApIters": NP.AP_ITERS, "kPolishIters": NP.POLISH_ITERS,
                   "kGsIters": NP.GS_ITERS, "kSamples": 17,
                   "kFixedPointIters": int(fixed_point[0])}


def test_group_tables_are_built_once(hammer_states):
    """Each group's geom ids are uploaded once per model; its margins are
    a view of the model's own `pair_margin`, never a copy."""
    env, _ = hammer_states[torch.float32]
    m, s = env.model, env.spec
    groups = [(k, p) for k, p in C._groups(s) if k in NC.KERNELS]
    assert sorted(k for k, _ in groups) == sorted(NC.KERNELS)
    for _, pids in groups:
        g1, g2, marg = NC.group_tables(m, pids)
        assert g1.dtype == torch.int32 and g2.dtype == torch.int32
        assert g1.tolist() == np.asarray(s.pair_geom1)[pids].tolist()
        assert g2.tolist() == np.asarray(s.pair_geom2)[pids].tolist()
        assert torch.equal(marg, m.pair_margin[pids])
        assert marg.untyped_storage().data_ptr() \
            == m.pair_margin.untyped_storage().data_ptr()
        again = NC.group_tables(m, pids)
        assert again[0] is g1 and again[1] is g2
    with pytest.raises(ValueError, match="consecutive"):
        NC.group_tables(m, [0, 2])


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_wrapper_refuses_cpu_tensors(key):
    name = NC.KERNELS[key][0]
    xpos, xmat, size = (torch.as_tensor(x) for x in random_pairs(
        np.random.default_rng(0), key, 4))
    g = torch.zeros(1, dtype=torch.int32)
    n = kernels.launches[name]
    with pytest.raises(ValueError, match="CUDA"):
        NC.narrow_cuda(key, xpos, xmat, size, g, g + 1, torch.zeros(1))
    assert kernels.launches[name] == n


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_probes_reach_every_branch(key):
    """`random_pairs`'s quarters, read from the plain function's own
    outputs: each quarter's branch at least 9 in 10 of the quarter (a
    random pose may fall in a special case, a drawn one miss it by its
    gap).  Capsule-box also at a margin of 1e9, where only a miss takes
    the fallback contact."""
    n = 400
    xpos, xmat, size = (torch.as_tensor(x) for x in
                        random_pairs(np.random.default_rng(1), key, n))

    def plain(margin):
        return C._FNS[key][0](xpos[:, 0], xmat[:, 0], size[:, 0],
                              xpos[:, 1], xmat[:, 1], size[:, 1],
                              torch.full((n,), margin))
    d, p, nrm = plain(0.0)
    q = torch.arange(n) % 4
    big = d >= NP.BIG

    def most(branch, quarter):          # 9 in 10 of the quarter, or more
        return float(branch[quarter].float().mean()) >= 0.9
    if key == (0, 5):                      # plane-cylinder: standing
        ca = (xmat[:, 0, :, 2] * xmat[:, 1, :, 2]).sum(-1, keepdim=True)
        prj = xmat[:, 1, :, 2] * ca - xmat[:, 0, :, 2]
        standing = prj.norm(dim=-1) < 1e-10
        assert most(standing, q >= 2) and most(~standing, q < 2)
    elif key in ((0, 3), (0, 6)):          # plane-capsule, plane-box
        assert most((d > 0).all(-1), q % 2 == 0)        # above
        assert most((d < 0).any(-1), q % 2 == 1)        # into the plane
    elif key in ((3, 3), (3, 5)):          # capsule-capsule, -cylinder:
        assert most(~big[:, 1], q >= 2) and most(big[:, 1], q < 2)  # parallel
    elif key == (3, 6):                    # capsule-box
        miss = plain(1e9)[0][:, 1] >= NP.BIG
        axis_in_box = torch.einsum("nji,nj->ni", xmat[:, 1], xmat[:, 0, :, 2])
        parallel = (axis_in_box == 0).any(-1)
        assert most(miss, q == 1) and most(~miss, q != 1)
        assert most(parallel & ~big[:, 1], q == 2)      # clipped, two
        assert most(big[:, 1] & ~miss, q == 3)          # the fallback
        assert most(~parallel, q == 0)
    elif key == (5, 5):                    # cylinder-cylinder
        cap = (d == d[:, :1]).all(-1)
        side = (d[:, 0] == d[:, 1]) & big[:, 2:].all(-1)
        generic = big[:, 1:].all(-1)
        assert most(cap, q == 2) and most(side, q == 3)
        assert most(generic, q < 2)
    elif key == (5, 6):                    # cylinder-box
        standing = ~big.any(-1)
        lying = (d[:, 0] == d[:, 1]) & big[:, 2:].all(-1)
        generic = big[:, 1:].all(-1)
        assert most(standing, q == 2) and most(lying, q == 3)
        assert most(generic, q < 2)
    else:                                  # box-box
        edge = big[:, 1:].all(-1) & (p == p[:, :1]).all(-1).all(-1)

        def along(m):                      # the normal along m's axes
            return torch.einsum("nji,nj->ni", m, nrm[:, 0]).abs() \
                .amax(-1) > 1 - 1e-5
        face1 = ~edge & along(xmat[:, 0])
        face2 = ~edge & ~along(xmat[:, 0]) & along(xmat[:, 1])
        assert most(face1, q == 0) and most(face2, q == 1)
        assert most(edge, q == 2)
    assert torch.isfinite(d).all() and torch.isfinite(p).all()
