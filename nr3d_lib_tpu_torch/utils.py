"""Image IO and small helpers of the port's program layer (port of
nr3d_lib_tpu/utils.py `img_to_uint8`, `save_image`, `save_video`,
`cond_mkdir`).

`save_image` writes PNG with the standard library alone (`zlib` and
`struct`), so that it runs where neither PIL nor matplotlib is installed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Sequence

import numpy as np

__all__ = ["to_numpy", "cond_mkdir", "img_to_uint8", "write_png",
           "save_image", "save_video"]


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or an array-like → numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cond_mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def img_to_uint8(img) -> np.ndarray:
    img = to_numpy(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels → PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + \
        struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] or [H, W, C] (C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA)
    → an 8-bit PNG, every row with filter type 0."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"a PNG holds 1 to 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def save_image(path: str, img) -> None:
    """Save a float [0,1] or uint8 image as PNG."""
    write_png(path, img_to_uint8(img))


def save_video(path: str, frames: Sequence, fps: int = 24) -> str:
    """Write frames ([T,H,W,3] float [0,1] or uint8) to a video file when a
    video writer (imageio with ffmpeg) is installed; otherwise, as in JAX,
    a PNG sequence directory beside it. Returns the path written."""
    frames_u8 = [img_to_uint8(f) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, frames_u8, fps=fps)
        return path
    except Exception:
        if os.path.exists(path):   # leave no truncated video behind
            os.remove(path)
        root = os.path.splitext(path)[0] + "_frames"
        cond_mkdir(root)
        for i, f in enumerate(frames_u8):
            save_image(os.path.join(root, f"{i:05d}.png"), f)
        return root
