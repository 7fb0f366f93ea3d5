"""Basic 2D plotting (port of nr3d_lib_tpu/plot/plot_basic.py).

The array functions run without matplotlib: `color_depth` and
`color_error_map` look their values up in the `turbo` and `coolwarm`
tables kept in `plot/_colormaps.py`, as matplotlib does. Only
`figure_to_image`, which takes a matplotlib figure, imports matplotlib.
Tensors (on any device) are accepted wherever JAX takes arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from nr3d_lib_tpu_torch.plot._colormaps import lookup_u8
from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["figure_to_image", "color_depth", "gallery", "draw_2dbox",
           "overlay_mask", "colorize_normals", "color_error_map",
           "sdf_slice_image", "draw_segments_2d"]


def figure_to_image(fig, close: bool = True) -> np.ndarray:
    """Render a matplotlib figure to an RGB uint8 array."""
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = buf.reshape(h, w, 4)[..., :3].copy()
    if close:
        import matplotlib.pyplot as plt

        plt.close(fig)
    return img


def color_depth(depth, scale: Optional[float] = None,
                cmap: str = "turbo") -> np.ndarray:
    """Colorize a depth map → uint8 RGB (NaN black)."""
    depth = np.asarray(to_numpy(depth), dtype=np.float32)
    if scale is None:
        scale = max(float(np.nanmax(depth)), 1e-8)
    normed = np.clip(depth / scale, 0.0, 1.0)
    return lookup_u8(cmap, normed)


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


def draw_2dbox(img: np.ndarray, xy_min, xy_max, color=(255, 0, 0),
               thickness: int = 1) -> np.ndarray:
    """Draw an axis-aligned box outline on a copy of the image."""
    img = np.array(to_numpy(img), copy=True)
    x0, y0 = [int(v) for v in xy_min]
    x1, y1 = [int(v) for v in xy_max]
    t = thickness
    img[y0:y0 + t, x0:x1] = color
    img[y1 - t:y1, x0:x1] = color
    img[y0:y1, x0:x0 + t] = color
    img[y0:y1, x1 - t:x1] = color
    return img


def overlay_mask(img: np.ndarray, mask: np.ndarray, color=(255, 0, 0),
                 alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend a boolean/float mask onto an RGB image."""
    img = to_numpy(img)
    out = img.astype(np.float32).copy()
    m = np.asarray(to_numpy(mask), np.float32)
    if m.ndim == 2:
        m = m[..., None]
    c = np.asarray(color, np.float32).reshape(1, 1, 3)
    out = out * (1.0 - alpha * m) + c * (alpha * m)
    return out.astype(img.dtype if img.dtype == np.uint8 else np.float32)


def colorize_normals(normals) -> np.ndarray:
    """Unit normals [-1,1]³ → uint8 RGB (the standard (n+1)/2 mapping)."""
    n = np.asarray(to_numpy(normals), np.float32)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    return ((n * 0.5 + 0.5) * 255).astype(np.uint8)


def color_error_map(err, scale: Optional[float] = None,
                    cmap: str = "coolwarm") -> np.ndarray:
    """Signed error map → diverging-colormap uint8 RGB, symmetric about 0."""
    err = np.asarray(to_numpy(err), np.float32)
    if scale is None:
        scale = max(float(np.nanmax(np.abs(err))), 1e-8)
    normed = np.clip(err / (2.0 * scale) + 0.5, 0.0, 1.0)
    return lookup_u8(cmap, normed)


def sdf_slice_image(query_sdf, axis: int = 2, coord: float = 0.0,
                    resolution: int = 256, aabb_min=(-1.0, -1.0, -1.0),
                    aabb_max=(1.0, 1.0, 1.0), scale: Optional[float] = None,
                    band: float = 0.01) -> np.ndarray:
    """Colorized planar slice of an SDF: diverging colors (inside blue,
    outside red), the zero level set dark.

    query_sdf: fn numpy [N,3] float32 → [N] (array or tensor); axis/coord
    pick the slicing plane. Returns uint8 [resolution, resolution, 3].
    """
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    ax_u, ax_v = [a for a in range(3) if a != axis]
    u = np.linspace(aabb_min[ax_u], aabb_max[ax_u], resolution,
                    dtype=np.float32)
    v = np.linspace(aabb_min[ax_v], aabb_max[ax_v], resolution,
                    dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    pts = np.empty((resolution * resolution, 3), np.float32)
    pts[:, ax_u] = uu.ravel()
    pts[:, ax_v] = vv.ravel()
    pts[:, axis] = coord
    sdf = to_numpy(query_sdf(pts)).reshape(resolution, resolution)
    img = color_error_map(sdf, scale=scale)
    img = img.copy()
    img[np.abs(sdf) < band] = (20, 20, 20)          # zero level set
    return img


def draw_segments_2d(img: np.ndarray, p0: np.ndarray, p1: np.ndarray,
                     color=(0, 255, 0), n_samples: int = 64) -> np.ndarray:
    """Rasterize 2D line segments into a copy of a uint8 image (sampled
    painting for debug overlays, not an antialiased renderer).

    p0/p1: [S,2] pixel coords (x, y)."""
    img = np.array(to_numpy(img), copy=True)
    h, w = img.shape[:2]
    p0 = np.asarray(to_numpy(p0), np.float32)
    p1 = np.asarray(to_numpy(p1), np.float32)
    if len(p0) == 0:
        return img
    t = np.linspace(0.0, 1.0, n_samples, dtype=np.float32)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t     # [S, T, 2]
    pix = np.round(pts.reshape(-1, 2)).astype(np.int64)
    keep = ((pix[:, 0] >= 0) & (pix[:, 0] < w)
            & (pix[:, 1] >= 0) & (pix[:, 1] < h))
    pix = pix[keep]
    img[pix[:, 1], pix[:, 0]] = np.asarray(color, img.dtype)
    return img
