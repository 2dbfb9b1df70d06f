"""Gif / plot / image-conversion helpers of the PyTorch port
(`mj_envs_tpu/utils/helpers.py`; the reference's
`mj_envs_vision/utils/helpers.py:85-134`): to_image_frame, to_input_obs,
save_as_gif, plot_rewards with mean / median / sigma band,
visualise_batch_from_experience and visualise_trajectory.

Host-side numpy and the standard library only: the card's machine has
no matplotlib, so the GIF (LZW) and PNG (zlib) encoders are written out
here, and a reward plot is a numpy rasterisation of the series.  Every
function takes tensors as well as numpy arrays (tensors are copied to
the host with `.cpu()`).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

GIF_DURATION = 150   # ms per frame (reference helpers.py GIF_DURATION)


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def to_image_frame(obs) -> np.ndarray:
    """Model-input image (C, H, W) pels in [-0.5, 0.5] -> (H, W, C) uint8
    [0, 255] (reference `helpers.py:88-90`)."""
    obs = _host(obs)
    return (255 * (obs.transpose((1, 2, 0)) + 0.5)).astype("uint8")


def to_input_obs(frame) -> np.ndarray:
    """(H, W, C) uint8 [0, 255] -> (C, H, W) float [-0.5, 0.5]
    (reference `helpers.py:92-94`)."""
    frame = _host(frame)
    return (frame.transpose((2, 0, 1)) / 255 - 0.5).astype("float")


# -- GIF ---------------------------------------------------------------------

def _palette(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(256 x 3 palette, (H, W) uint8 indices) of an (H, W, 3) uint8
    frame: exact when it has at most 256 colours; otherwise each channel
    drops its low bits until at most 256 colours are left, each shown as
    the middle of its bucket."""
    rgb = frame.reshape(-1, 3)
    for shift in range(8):
        colours, idx = np.unique(rgb >> shift, axis=0, return_inverse=True)
        if len(colours) <= 256:
            break
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(colours)] = (colours.astype(np.int32) << shift) \
        + ((1 << shift) >> 1)
    return pal, idx.reshape(frame.shape[:2]).astype(np.uint8)


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of 8-bit indices (codes of 9 to 12 bits,
    least significant bit first; a clear code when the table is full)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    width, nxt, table = min_size + 1, eoi + 1, {}
    emit(clear, width)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear, width)
            width, nxt, table = min_size + 1, eoi + 1, {}
        prefix = b
    emit(prefix, width)
    emit(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _gif_frame(frame: np.ndarray, delay_cs: int) -> bytes:
    h, w = frame.shape[:2]
    pal, idx = _palette(frame)
    data = _lzw(idx.tobytes())
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
            + b"\x2c" + struct.pack("<4H", 0, 0, w, h) + b"\x87"
            + pal.tobytes() + b"\x08" + blocks + b"\x00")


def save_as_gif(frames: Sequence, gif_path: str, is_obs: bool = False
                ) -> None:
    """Write frames as an animated gif (reference `helpers.py:96-101`):
    each frame (H, W, 3) float / uint8 in [0, 255] (cast to uint8 as the
    reference does), or a CHW [-0.5, 0.5] model observation when
    `is_obs`; GIF_DURATION ms a frame, the loop count 1 that PIL writes
    for the reference's `loop=True`."""
    arrs = []
    for frame in frames:
        frame = _host(frame)
        arrs.append(to_image_frame(frame) if is_obs
                    else frame.astype("uint8"))
    h, w = arrs[0].shape[:2]
    os.makedirs(os.path.dirname(gif_path) or ".", exist_ok=True)
    with open(gif_path, "wb") as f:
        f.write(b"GIF89a" + struct.pack("<2H", w, h) + b"\x00\x00\x00")
        f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01"
                + struct.pack("<H", 1) + b"\x00")
        for a in arrs:
            f.write(_gif_frame(a, GIF_DURATION // 10))
        f.write(b"\x3b")


# -- PNG reward plots ----------------------------------------------------------

PLOT_HW = (500, 1000)          # the reference's figsize (10, 5) at 100 dpi
_MARGIN = 40
_MEAN_RGB = (31, 119, 180)     # matplotlib's first two cycle colours
_MEDIAN_RGB = (255, 127, 14)


def write_png(path: str, img: np.ndarray, text: dict = None) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, with `text` as tEXt chunks."""
    img = np.ascontiguousarray(_host(img).astype(np.uint8))
    h, w = img.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    out = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">2I5B", w, h, 8, 2, 0, 0, 0))
           + b"".join(chunk(b"tEXt", k.encode("latin-1") + b"\x00"
                            + str(v).encode("latin-1"))
                      for k, v in (text or {}).items())
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)


def _line(img, xs, ys, rgb, dash: int = 0, width: int = 2):
    """Draw the polyline through pixel points (xs, ys); with `dash`,
    alternate `dash` pixels on and off along it."""
    h, w = img.shape[:2]
    pts = []
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        t = np.linspace(0.0, 1.0, n + 1)
        pts.append(np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], 1))
    p = np.concatenate(pts) if pts else np.stack([xs, ys], 1)
    if dash:
        p = p[(np.arange(len(p)) // dash) % 2 == 0]
    for d in range(width):
        x = np.clip(np.round(p[:, 0]).astype(int), 0, w - 1)
        y = np.clip(np.round(p[:, 1]).astype(int) + d, 0, h - 1)
        img[y, x] = rgb


def plot_rewards(rewards: List[Tuple], yaxis_label: str = "total reward"
                 ) -> np.ndarray:
    """The reward curve (reference `helpers.py:103-120`) as an (H, W, 3)
    uint8 image: one solid line for scalar-per-epoch data; for
    vector-per-epoch data the mean (dashed), the median (solid) and a
    mean ± std band.  `rewards` = [(episode, value-or-values)].  The
    axes span the data: epochs left to right, values bottom to top."""
    ep = np.array([float(x[0]) for x in rewards])
    rwd = np.array([_host(x[1]).astype(np.float64) for x in rewards])
    h, w = PLOT_HW
    img = np.full((h, w, 3), 255, np.uint8)
    if rwd.ndim == 1:
        series, lo, hi = [(rwd, _MEAN_RGB, 0)], rwd, rwd
    else:
        mu, std = rwd.mean(-1), rwd.std(-1)
        med = np.median(rwd, -1)
        series = [(mu, _MEAN_RGB, 6), (med, _MEDIAN_RGB, 0)]
        lo, hi = mu - std, mu + std
    ymin, ymax = float(np.min(lo)), float(np.max(hi))
    if ymax - ymin < 1e-12:
        ymin, ymax = ymin - 0.5, ymax + 0.5
    xmin, xmax = float(ep.min()), float(ep.max())
    if xmax - xmin < 1e-12:
        xmin, xmax = xmin - 0.5, xmax + 0.5
    px = lambda x: _MARGIN + (x - xmin) / (xmax - xmin) * (w - 2 * _MARGIN)
    py = lambda y: h - _MARGIN - (y - ymin) / (ymax - ymin) \
        * (h - 2 * _MARGIN)
    if rwd.ndim > 1:                       # the ± std band, 5 % opaque
        cols = np.arange(int(np.ceil(px(xmin))), int(px(xmax)) + 1)
        xv = xmin + (cols - _MARGIN) / (w - 2 * _MARGIN) * (xmax - xmin)
        top, bot = py(np.interp(xv, ep, hi)), py(np.interp(xv, ep, lo))
        rows = np.arange(h)[:, None]
        band = (rows >= np.floor(top)) & (rows <= np.ceil(bot))
        sub = img[:, cols].astype(np.float64)
        tint = 0.95 * sub + 0.05 * np.array(_MEAN_RGB)
        img[:, cols] = np.where(band[..., None], tint, sub).astype(np.uint8)
    box = [(_MARGIN, _MARGIN), (w - _MARGIN, _MARGIN),
           (w - _MARGIN, h - _MARGIN), (_MARGIN, h - _MARGIN),
           (_MARGIN, _MARGIN)]
    _line(img, *map(np.array, zip(*box)), (0, 0, 0), width=1)
    for y, rgb, dash in series:
        _line(img, px(ep), py(y), rgb, dash)
    return img


def save_rewards_plot(rewards: List[Tuple], path: str,
                      yaxis_label: str = "total reward") -> None:
    """`plot_rewards` written as a PNG; the axis labels, the value range
    and the series' names go into its text chunks."""
    rwd = [_host(x[1]) for x in rewards]
    n = np.asarray(rwd[0]).size if rwd else 0
    allv = np.concatenate([np.ravel(r) for r in rwd]).astype(np.float64)
    write_png(path, plot_rewards(rewards, yaxis_label), {
        "xlabel": "epochs", "ylabel": f"{yaxis_label} n=({n})",
        "range": f"{allv.min():.6g} .. {allv.max():.6g}",
        "legend": "mean (dashed), median (solid), mean +- std (band)"
                  if n > 1 else "value (solid)"})


def visualise_batch_from_experience(id: int, config, experience,
                                    out_dir: str) -> None:
    """Dump a sampled replay batch (`algos/replay.py`) as a gif
    (reference `helpers.py:126-128`): a debugging aid for PlaNet's
    replay."""
    batch = experience.sample(min(config.batch_size, experience.idx - 1),
                              min(config.chunk_size, experience.idx - 1))
    obs = _host(batch["obs"])                # (chunk, batch, H, W, C)
    frames = obs.reshape(-1, *obs.shape[-3:])
    if frames.dtype != np.uint8:             # dequantized [-0.5, 0.5]
        frames = np.clip((frames + 0.5) * 255.0, 0, 255)
    save_as_gif(list(frames), os.path.join(out_dir, f"experience_{id}.gif"))


def visualise_trajectory(id: int, frames: Sequence, out_dir: str,
                         prefix: str = "trajectory") -> None:
    """Save one rollout's frames as `<prefix>_<id>.gif` (reference
    `helpers.py:130-131`)."""
    save_as_gif(list(frames), os.path.join(out_dir, f"{prefix}_{id}.gif"))
