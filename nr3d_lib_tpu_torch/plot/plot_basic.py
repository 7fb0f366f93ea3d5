"""Basic 2D plotting (port of nr3d_lib_tpu/plot/plot_basic.py `gallery`;
the matplotlib helpers wait in ROADMAP.md A15)."""

from __future__ import annotations

import numpy as np

from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["gallery"]


def gallery(images, ncols: int = 4, pad: int = 2,
            pad_value: float = 1.0) -> np.ndarray:
    """Tile a list of [H,W,C] images into one grid image."""
    images = [to_numpy(im) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    c = images[0].shape[2] if images[0].ndim == 3 else 1
    nrows = (len(images) + ncols - 1) // ncols
    grid = np.full((nrows * (h + pad) - pad, ncols * (w + pad) - pad, c),
                   pad_value, dtype=images[0].dtype)
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = im[..., None]
        r, col = divmod(i, ncols)
        grid[r * (h + pad): r * (h + pad) + im.shape[0],
             col * (w + pad): col * (w + pad) + im.shape[1]] = im
    return grid.squeeze()
