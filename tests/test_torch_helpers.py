"""The port's gif / plot / image helpers (`mj_envs_torch/utils/helpers.py`)
against the JAX package's (`mj_envs_tpu/utils/helpers.py`), CPU.

* `to_image_frame` and `to_input_obs` on the same seeded arrays (numpy
  and tensors): equal.
* `visualise_trajectory` and `visualise_batch_from_experience` on the
  same seeded frames / replay: the two packages' gifs decode (PIL) to
  the same frames, and to the frames given.
* The port's own GIF encoder decodes to the frames it was given: exactly
  for frames of at most 256 colours (also through several resets of the
  LZW table), within its palette's buckets above that.
* The reward plots: a PNG that decodes to `plot_rewards`' image, with
  its labels in text chunks, for vector- and scalar-per-epoch data.
"""
import numpy as np
import pytest
import torch
from PIL import Image

from mj_envs_tpu.utils import helpers as JH
from mj_envs_torch.algos.replay import ExperienceReplay
from mj_envs_torch.utils import helpers as TH


def _decode(path):
    with Image.open(path) as im:
        out = []
        for i in range(im.n_frames):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out, dict(im.info)


def _frames(seed, n=4, hw=(24, 32), colours=40):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (colours, 3)).astype(np.uint8)
    return [pal[rng.integers(0, colours, hw)] for _ in range(n)]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_image_conversions_match_jax(as_tensor):
    rng = np.random.default_rng(0)
    obs = rng.uniform(-0.5, 0.5, (3, 16, 20)).astype(np.float32)
    frame = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    wrap = torch.as_tensor if as_tensor else (lambda x: x)
    got_f, want_f = TH.to_image_frame(wrap(obs)), JH.to_image_frame(obs)
    assert got_f.dtype == want_f.dtype and np.array_equal(got_f, want_f)
    got_o, want_o = TH.to_input_obs(wrap(frame)), JH.to_input_obs(frame)
    assert got_o.dtype == want_o.dtype and np.array_equal(got_o, want_o)


def test_visualise_trajectory_matches_jax(tmp_path):
    frames = _frames(1)
    JH.visualise_trajectory(3, frames, str(tmp_path / "jax"), prefix="w")
    TH.visualise_trajectory(3, [torch.as_tensor(f, dtype=torch.float32)
                                for f in frames],
                            str(tmp_path / "torch"), prefix="w")
    want, jinfo = _decode(tmp_path / "jax" / "w_3.gif")
    got, tinfo = _decode(tmp_path / "torch" / "w_3.gif")
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        assert np.array_equal(g, w) and np.array_equal(g, f)
    for k in ("duration", "loop"):
        assert tinfo[k] == jinfo[k], k


def _replay(seed=4):
    rep = ExperienceReplay(64, (8, 8, 3), 2, bit_depth=5, seed=seed)
    rng = np.random.default_rng(seed)
    for t in range(40):
        rep.append(rng.uniform(0, 255, (8, 8, 3)), rng.normal(size=2),
                   float(t), t % 13 == 12)
    return rep


def test_visualise_batch_from_experience_matches_jax(tmp_path):
    class Cfg:
        batch_size, chunk_size = 3, 5

    JH.visualise_batch_from_experience(2, Cfg, _replay(), str(tmp_path / "j"))
    TH.visualise_batch_from_experience(2, Cfg, _replay(), str(tmp_path / "t"))
    want, _ = _decode(tmp_path / "j" / "experience_2.gif")
    got, _ = _decode(tmp_path / "t" / "experience_2.gif")
    assert len(got) == len(want) == 15
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("colours,hw", [(2, (5, 7)), (256, (128, 128)),
                                        (1, (64, 64))])
def test_gif_decodes_to_its_frames(tmp_path, colours, hw):
    """Exact for at most 256 colours; 256 random colours over 128x128
    overflow the 4096-code LZW table several times a frame."""
    frames = _frames(colours, n=3, hw=hw, colours=colours)
    path = tmp_path / "f.gif"
    TH.save_as_gif(frames, str(path))
    got, info = _decode(path)
    assert info["duration"] == TH.GIF_DURATION
    assert len(got) == 3
    for g, f in zip(got, frames):
        assert np.array_equal(g, f)


def test_gif_of_many_colours_within_its_buckets(tmp_path):
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    path = tmp_path / "m.gif"
    TH.save_as_gif([frame], str(path))
    got = _decode(path)[0][0].astype(int)
    # each channel kept its high bits: the decoded value lies in the
    # input's bucket of 2^shift, shift the smallest that leaves <= 256
    shift = next(s for s in range(8)
                 if len(np.unique(frame.reshape(-1, 3) >> s, axis=0)) <= 256)
    assert np.array_equal(got >> shift, frame.astype(int) >> shift)


def test_gif_of_model_observations(tmp_path):
    rng = np.random.default_rng(8)
    obs = [rng.uniform(-0.5, 0.5, (3, 6, 6)) for _ in range(2)]
    small = [TH.to_image_frame(o) // 64 * 64 for o in obs]
    TH.save_as_gif([TH.to_input_obs(f) for f in small], str(tmp_path / "o.gif"),
                   is_obs=True)
    got, _ = _decode(tmp_path / "o.gif")
    assert all(np.array_equal(g, TH.to_image_frame(TH.to_input_obs(f)))
               for g, f in zip(got, small))


@pytest.mark.parametrize("vector", [True, False])
def test_rewards_plot_png(tmp_path, vector):
    rng = np.random.default_rng(9)
    series = [(ep, rng.normal(size=10) if vector else float(rng.normal()))
              for ep in range(5)]
    path = tmp_path / "r.png"
    TH.save_rewards_plot(series, str(path), "total rewards")
    img = TH.plot_rewards(series, "total rewards")
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (1000, 500)
        got, text = np.asarray(im), dict(im.text)
    assert np.array_equal(got, img)
    assert text["ylabel"] == f"total rewards n=({10 if vector else 1})"
    assert text["xlabel"] == "epochs"
    # the curve's colours are drawn, the band only where it is wide
    assert (img == np.array(TH._MEAN_RGB, np.uint8)).all(-1).any()
    assert (img == np.array(TH._MEDIAN_RGB, np.uint8)).all(-1).any() \
        == vector
