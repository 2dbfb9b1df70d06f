"""The narrowphase's cylinder kernel (`csrc/narrow_cyl.cu`) from the CPU:
its dispatch, counters, tables, probe generator and the constants it
shares with the plain functions.

On the CPU `narrowphase_all` takes the plain functions in float32 and
float64 and launches nothing; under the tracer every (env, pair) row is
counted as a plain row.  The kernel itself runs only on the card
(`tests/test_torch_cuda.py` holds it against the plain functions there,
bit for bit).
"""
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
    """No cylinder kernel launches on the CPU; the tracer counts hammer's
    257 pairs x B rows as plain rows and none as kernel rows."""
    env, st = hammer_states[dtype]
    before = dict(trace.counters)
    con = C.narrowphase_all(env.model, st.data)
    gained = trace.since(before)
    assert all(gained[k] == 0 for k in NAMES)
    assert gained.get("collide.kernel_rows", 0) == 0
    assert gained["collide.plain_rows"] == env.spec.npair * B == 257 * B
    assert con.dist.dtype == dtype and con.dist.shape[1] == env.spec.ncon_cap


def test_names_are_counted_kernels_and_no_reference():
    assert set(NAMES) <= set(kernels.KERNELS)
    assert all(k in kernels.launches for k in NAMES)
    assert not set(NAMES) & set(REFERENCES)
    assert not any(r in n for r in REFERENCES for n in NAMES)
    assert "narrow_cyl.cu" in _build.SOURCES
    src = open(os.path.join(_build.CSRC, "narrow_cyl.cu")).read()
    for name in NAMES:
        assert re.search(rf"NARROW_ENTRY\({name},", src), name


def test_kernel_trip_counts_are_the_plain_functions():
    """The kernel's fixed trip counts are narrowphase.py's."""
    src = open(os.path.join(_build.CSRC, "narrow_cyl.cu")).read()
    got = {k: int(v) for k, v in
           re.findall(r"constexpr int (k\w+Iters|kSamples) = (\d+);", src)}
    assert got == {"kApIters": NP.AP_ITERS, "kPolishIters": NP.POLISH_ITERS,
                   "kGsIters": NP.GS_ITERS, "kSamples": 17}


def test_group_tables_are_built_once(hammer_states):
    env, _ = hammer_states[torch.float32]
    s = env.spec
    groups = [(k, p) for k, p in C._groups(s) if k in NC.KERNELS]
    assert [k for k, _ in groups] == [(0, 5), (3, 5), (5, 5), (5, 6)]
    for _, pids in groups:
        g1, g2 = NC.group_tables(s, pids, torch.device("cpu"))
        assert g1.dtype == torch.int32 and g2.dtype == torch.int32
        assert g1.tolist() == np.asarray(s.pair_geom1)[pids].tolist()
        assert g2.tolist() == np.asarray(s.pair_geom2)[pids].tolist()
        again = NC.group_tables(s, pids, torch.device("cpu"))
        assert again[0] is g1 and again[1] is g2


def test_wrapper_refuses_cpu_tensors():
    xpos, xmat, size = (torch.as_tensor(x) for x in NC.random_cylinder_pairs(
        np.random.default_rng(0), KEYS[0], 4))
    g = torch.zeros(1, dtype=torch.int32)
    n = kernels.launches[NAMES[0]]
    with pytest.raises(ValueError, match="CUDA"):
        NC.narrow_cylinder_cuda(KEYS[0], xpos, xmat, size, g, g + 1)
    assert kernels.launches[NAMES[0]] == n


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_probes_reach_every_branch(key):
    """`random_cylinder_pairs`'s quarters, read from the plain function's
    own outputs: 0 and 1 random (the generic path), 2 and 3 the special
    cases of each type, each at least 9 in 10 of its quarter (a random
    pose may fall in a special case, a drawn one miss it by its gap)."""
    n = 400
    xpos, xmat, size = (torch.as_tensor(x) for x in
                        NC.random_cylinder_pairs(np.random.default_rng(1),
                                                 key, n))
    d, p, nrm = C._FNS[key][0](xpos[:, 0], xmat[:, 0], size[:, 0],
                               xpos[:, 1], xmat[:, 1], size[:, 1],
                               torch.zeros(n))
    q = torch.arange(n) % 4
    big = d >= NP.BIG

    def most(branch, quarter):          # 9 in 10 of the quarter, or more
        return float(branch[quarter].float().mean()) >= 0.9
    if key == KEYS[0]:                     # plane-cylinder: standing
        ca = (xmat[:, 0, :, 2] * xmat[:, 1, :, 2]).sum(-1, keepdim=True)
        prj = xmat[:, 1, :, 2] * ca - xmat[:, 0, :, 2]
        standing = prj.norm(dim=-1) < 1e-10
        assert most(standing, q >= 2) and most(~standing, q < 2)
    elif key == KEYS[1]:                   # capsule-cylinder: parallel
        assert most(~big[:, 1], q >= 2) and most(big[:, 1], q < 2)
    elif key == KEYS[2]:                   # cylinder-cylinder
        cap = (d == d[:, :1]).all(-1)
        side = (d[:, 0] == d[:, 1]) & big[:, 2:].all(-1)
        generic = big[:, 1:].all(-1)
        assert most(cap, q == 2) and most(side, q == 3)
        assert most(generic, q < 2)
    else:                                  # cylinder-box
        standing = ~big.any(-1)
        lying = (d[:, 0] == d[:, 1]) & big[:, 2:].all(-1)
        generic = big[:, 1:].all(-1)
        assert most(standing, q == 2) and most(lying, q == 3)
        assert most(generic, q < 2)
    assert torch.isfinite(d).all() and torch.isfinite(p).all()
