"""3D line sets: camera frusta, occupancy-grid boxes, oriented boxes,
trajectories and forest blocks (port of nr3d_lib_tpu/plot/plot_3d.py).

The line-set builders return (points [P,3] float32, segments [S,2]
int32) with numpy alone, for any viewer or for `gui_datalayers`;
`plot_camera_frusta`, `plot_occ_grid` and `plot_lineset` draw them on
matplotlib 3D axes and import matplotlib inside the function.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["camera_frustum_lines", "occgrid_box_lines", "plot_camera_frusta",
           "plot_occ_grid", "obb_lines", "trajectory_lines",
           "forest_block_lines", "merge_linesets", "plot_lineset"]


def camera_frustum_lines(c2w, intr, hw: Tuple[int, int], scale: float = 0.3
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One camera → (points [5,3], segments [8,2]) frustum line set."""
    c2w = np.asarray(to_numpy(c2w))
    intr = np.asarray(to_numpy(intr))
    h, w = hw
    corners_px = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    x = (corners_px[:, 0] - intr[0, 2]) / intr[0, 0]
    y = (corners_px[:, 1] - intr[1, 2]) / intr[1, 1]
    dirs = np.stack([x, y, np.ones(4)], -1) * scale
    pts_cam = np.concatenate([np.zeros((1, 3)), dirs], 0)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    segs = np.asarray([[0, 1], [0, 2], [0, 3], [0, 4],
                       [1, 2], [2, 3], [3, 4], [4, 1]])
    return pts.astype(np.float32), segs


def occgrid_box_lines(occ: np.ndarray, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1),
                      max_boxes: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """Occupied cells → wireframe boxes (points, segments)."""
    occ = np.asarray(to_numpy(occ))
    aabb_min, aabb_max = to_numpy(aabb_min), to_numpy(aabb_max)
    res = np.asarray(occ.shape)
    cells = np.argwhere(occ)
    if len(cells) > max_boxes:
        cells = cells[np.linspace(0, len(cells) - 1, max_boxes).astype(int)]
    size = (np.asarray(aabb_max) - np.asarray(aabb_min)) / res
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                       -1).reshape(8, 3)
    box_edges = np.asarray([[0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3],
                            [2, 6], [3, 7], [4, 5], [4, 6], [5, 7], [6, 7]])
    pts, segs = [], []
    for i, c in enumerate(cells):
        lo = np.asarray(aabb_min) + c * size
        pts.append(lo + corners * size)
        segs.append(box_edges + 8 * i)
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(segs).astype(np.int32))


def _plot_lines(ax, pts, segs, color="b", lw=0.5):
    for a, b in segs:
        ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 1], pts[b, 1]],
                [pts[a, 2], pts[b, 2]], color=color, linewidth=lw)


def plot_camera_frusta(c2ws, intr, hw, scale: float = 0.3, ax=None,
                       show: bool = False):
    """matplotlib 3D frusta plot."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    for c2w in to_numpy(c2ws).reshape(-1, 4, 4):
        pts, segs = camera_frustum_lines(c2w, intr, hw, scale)
        _plot_lines(ax, pts, segs, color="tab:blue")
    if show:
        plt.show()
    return ax


def plot_occ_grid(occ, aabb_min=(-1, -1, -1), aabb_max=(1, 1, 1), ax=None,
                  show: bool = False):
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    pts, segs = occgrid_box_lines(occ, aabb_min, aabb_max)
    _plot_lines(ax, pts, segs, color="tab:orange", lw=0.3)
    if show:
        plt.show()
    return ax


def obb_lines(mat_3x4, size) -> Tuple[np.ndarray, np.ndarray]:
    """Oriented 3D box → (points [8,3], segments [12,2]) line set.

    mat_3x4: box→world transform (rotation|translation); size: box side
    lengths [3] (box-local extent [-s/2, s/2])."""
    mat = np.asarray(to_numpy(mat_3x4), np.float64).reshape(3, 4)
    s = np.asarray(size, np.float64) * 0.5
    corners = np.stack(np.meshgrid([-1, 1], [-1, 1], [-1, 1],
                                   indexing="ij"), -1).reshape(8, 3) * s
    pts = corners @ mat[:, :3].T + mat[:, 3]
    segs = np.asarray([[0, 1], [0, 2], [0, 4], [1, 3], [1, 5], [2, 3],
                       [2, 6], [3, 7], [4, 5], [4, 6], [5, 7], [6, 7]])
    return pts.astype(np.float32), segs.astype(np.int32)


def trajectory_lines(positions) -> Tuple[np.ndarray, np.ndarray]:
    """Polyline through positions [N,3] → line set (camera/ego paths)."""
    pts = np.asarray(to_numpy(positions), np.float32).reshape(-1, 3)
    n = len(pts)
    segs = np.stack([np.arange(n - 1), np.arange(1, n)], -1).astype(np.int32)
    return pts, segs


def forest_block_lines(space, occupied_only: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """ForestBlockSpace → wireframe boxes of its (occupied) blocks."""
    occ = to_numpy(space.occupied)
    if not occupied_only:
        occ = np.ones_like(occ)
    o = to_numpy(space.origin)
    hi = o + np.asarray(space.resolution) * space.block_size
    return occgrid_box_lines(occ, o, hi, max_boxes=1 << 16)


def merge_linesets(linesets) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate [(points, segments), ...] into one line set."""
    pts_all, segs_all, off = [], [], 0
    for pts, segs in linesets:
        pts_all.append(np.asarray(to_numpy(pts), np.float32))
        segs_all.append(np.asarray(to_numpy(segs), np.int32) + off)
        off += len(pts)
    return np.concatenate(pts_all), np.concatenate(segs_all)


def plot_lineset(pts, segs, ax=None, color="tab:green", lw=0.5,
                 show: bool = False):
    """Generic matplotlib-3D line-set plot (consumes any *_lines output)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    _plot_lines(ax, np.asarray(pts), np.asarray(segs), color=color, lw=lw)
    if show:
        plt.show()
    return ax
