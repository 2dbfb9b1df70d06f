"""The port's PlaNet sequence replay (`mj_envs_torch/algos/replay.py`)
against the JAX package's (`mj_envs_tpu/algos/replay.py`): both are
numpy on the host, so the same appends and the same seed must give the
same ring and the same sampled batches bit for bit, including chunks
that wrap the ring and the rejection of chunks across the write head."""
import numpy as np
import pytest

from mj_envs_tpu.algos import replay as JR
from mj_envs_torch.algos import replay as TR

OBS = (8, 8, 3)
ACT = 4


def fill(mem, n, seed, episode=7):
    rng = np.random.default_rng(seed)
    for i in range(n):
        mem.append(rng.uniform(0.0, 255.0, OBS).astype(np.float32),
                   rng.uniform(-1.0, 1.0, ACT).astype(np.float32),
                   float(rng.standard_normal()), (i + 1) % episode == 0)


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("n", [20, 37], ids=["partial", "wrapped"])
def test_replay_matches_jax_bit_for_bit(n):
    """A 30-slot ring after 20 appends (not full) and after 37 (wrapped
    past the end, the write head at 7): four samples of 6 chunks of 5."""
    j = JR.ExperienceReplay(30, OBS, ACT, bit_depth=5, seed=3)
    t = TR.ExperienceReplay(30, OBS, ACT, bit_depth=5, seed=3)
    fill(j, n, 0)
    fill(t, n, 0)
    assert (t.idx, t.full, t.steps, t.episodes) == \
        (j.idx, j.full, j.steps, j.episodes)
    np.testing.assert_array_equal(t.observations, j.observations)
    np.testing.assert_array_equal(t.nonterminals, j.nonterminals)
    for _ in range(4):
        got, want = t.sample(6, 5), j.sample(6, 5)
        same(got, want)
        assert got["obs"].shape == (5, 6) + OBS
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_wrapped_chunks_never_cross_the_write_head():
    t = TR.ExperienceReplay(30, OBS, ACT, seed=1)
    fill(t, 37, 1)
    for _ in range(50):
        t.sample(4, 5)
    starts = [t._valid_start(5) for _ in range(200)]
    for s in starts:
        idxs = np.arange(s, s + 5) % 30
        assert t.idx not in idxs[1:]


def test_quantize_and_dequantize_match_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(0.0, 255.99, (3, 8, 8, 3)).astype(np.float32)
    for bits in (5, 8):
        q = TR.quantize_obs(x, bits)
        np.testing.assert_array_equal(q, JR.quantize_obs(x, bits))
        assert q.dtype == np.uint8
        # truncation, not rounding: 6.9 -> 6 -> 0 at 5 bits
        assert TR.quantize_obs(np.array([6.9], np.float32), 5)[0] == 0
        got = TR.dequantize_obs(q, bits, np.random.default_rng(9))
        want = JR.dequantize_obs(q, bits, np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
        assert got.min() >= -0.5 and got.max() <= 0.5


def test_symbolic_replay_keeps_floats():
    t = TR.ExperienceReplay(10, (5,), 2, symbolic=True, seed=0)
    j = JR.ExperienceReplay(10, (5,), 2, symbolic=True, seed=0)
    for mem in (t, j):
        for i in range(8):
            mem.append(np.full(5, i + 0.25, np.float32), np.ones(2), 1.0,
                       i == 3)
    same(t.sample(3, 4), j.sample(3, 4))
