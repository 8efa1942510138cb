"""Sample grids as PNG files (the counterpart of scripts/eval_quality.py::
save_grid): rows are samples, columns are frames spread evenly over the
clip.

The PNG is written with the standard library alone (``zlib`` and
``struct``: 8-bit samples, filter 0 on every row), since the card's machine
has no ``imageio``; ``read_png`` decodes what ``write_png`` writes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def grid_array(videos, n_rows: int = 6, n_frames: int = 8) -> np.ndarray:
    """(N, T, H, W, C) in [0, 1] (NumPy or torch) -> the (rows H, n_frames
    W, C) uint8 grid of the first ``n_rows`` samples at ``n_frames`` frames
    from linspace(0, T - 1), as the JAX script's save_grid lays it out."""
    if hasattr(videos, "detach"):
        videos = videos.detach().float().cpu().numpy()
    v = np.clip(np.asarray(videos[:n_rows], np.float32), 0, 1)
    t_idx = np.linspace(0, v.shape[1] - 1, n_frames).astype(int)
    rows = [np.concatenate([v[i, t] for t in t_idx], axis=1) for i in range(v.shape[0])]
    return (np.concatenate(rows, axis=0) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: Union[str, Path], image: np.ndarray) -> None:
    """An (H, W) or (H, W, C) uint8 image (C 1-4: grey, grey + alpha, RGB,
    RGBA) as an 8-bit PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"write_png: {c} channels")
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b""))


def read_png(path: Union[str, Path]) -> np.ndarray:
    """The (H, W, C) uint8 image of a PNG ``write_png`` wrote (8-bit, not
    interlaced, every row filtered 0)."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit, non-interlaced PNGs are read")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, c).copy()


def save_grid(path: Union[str, Path], videos, n_rows: int = 6, n_frames: int = 8) -> None:
    """``grid_array`` of ``videos`` written to ``path`` as a PNG."""
    write_png(path, grid_array(videos, n_rows, n_frames))
