"""Debug data layers: live model and accel state → named line sets (port
of nr3d_lib_tpu/gui_datalayers.py).

A layer is a plain ``{"name", "points", "edges", "color"}`` dict of
numpy arrays, for `plot.plot_lineset`, a PLY file (`save_linesets_ply`)
or the viewer's overlays (`draw_datalayers`, which projects them into a
rendered frame). The layers read the port's occupancy grids, forest
space and cameras on any device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from nr3d_lib_tpu_torch.plot.plot_3d import (camera_frustum_lines,
                                             forest_block_lines,
                                             merge_linesets,
                                             occgrid_box_lines)
from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["occgrid_datalayer", "forest_datalayer", "camera_datalayer",
           "aabb_datalayer", "save_linesets_ply", "project_datalayer",
           "draw_datalayers"]

Lineset = Dict[str, np.ndarray]


def _layer(name: str, pts, segs, color) -> Lineset:
    return {"name": name, "points": np.asarray(pts, np.float32),
            "edges": np.asarray(segs, np.int32),
            "color": np.asarray(color, np.float32)}


def occgrid_datalayer(accel, name: str = "occgrid",
                      color=(1.0, 0.55, 0.0)) -> Lineset:
    """Occupied cells of an occupancy-grid accel as wireframe boxes, in
    its space's AABB when it has one, else [-1,1]³."""
    occ = to_numpy(accel.occ.occ() if hasattr(accel.occ, "occ")
                   else accel.occ())
    lo, hi = (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)
    space = getattr(accel, "space", None)
    if space is not None and hasattr(space, "aabb"):
        ab = to_numpy(space.aabb)
        lo, hi = ab[0], ab[1]
    pts, segs = occgrid_box_lines(occ, lo, hi)
    return _layer(name, pts, segs, color)


def forest_datalayer(space, accel=None, name: str = "forest",
                     color=(0.1, 0.7, 0.3)) -> List[Lineset]:
    """Forest block outlines, plus each block's occupied cells when an
    `OccGridAccelForest` is given."""
    layers = [_layer(name + "/blocks", *forest_block_lines(space), color)]
    if accel is not None:
        occ = to_numpy(accel.occ.occ())                    # [n_trees, r,r,r]
        o = to_numpy(space.origin)
        bs = space.block_size
        cells = []
        for slot, c in enumerate(to_numpy(space.block_coords)):
            lo = o + c * bs
            pts, segs = occgrid_box_lines(occ[slot], lo, lo + bs,
                                          max_boxes=512)
            if len(pts):
                cells.append((pts, segs))
        if cells:
            pts, segs = merge_linesets(cells)
            layers.append(_layer(name + "/cells", pts, segs,
                                 (1.0, 0.55, 0.0)))
    return layers


def camera_datalayer(c2ws, intr, hw, scale: float = 0.3,
                     name: str = "cameras",
                     color=(0.2, 0.4, 1.0)) -> Lineset:
    """View frusta of a camera set."""
    c2ws = to_numpy(c2ws).reshape(-1, 4, 4)
    pts, segs = merge_linesets(
        [camera_frustum_lines(c2w, intr, hw, scale) for c2w in c2ws])
    return _layer(name, pts, segs, color)


def aabb_datalayer(aabb, name: str = "aabb",
                   color=(0.6, 0.6, 0.6)) -> Lineset:
    """A single AABB [2,3] outline."""
    ab = np.asarray(to_numpy(aabb), np.float32)
    occ = np.ones((1, 1, 1), bool)
    pts, segs = occgrid_box_lines(occ, ab[0], ab[1])
    return _layer(name, pts, segs, color)


def save_linesets_ply(path: str, layers: Sequence[Lineset]):
    """Write layers to an ASCII PLY with edges (meshlab, open3d)."""
    pts, segs = merge_linesets([(l["points"], l["edges"]) for l in layers])
    cols = np.concatenate([
        np.tile((np.asarray(l["color"]) * 255).astype(np.uint8),
                (len(l["points"]), 1)) for l in layers])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(segs)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for a, b in segs:
            f.write(f"{a} {b}\n")


def project_datalayer(layer: Lineset, intr, c2w,
                      hw) -> "tuple[np.ndarray, np.ndarray]":
    """Project a line-set layer into pixel space: (p0, p1) [S,2] segment
    endpoints; a segment with an endpoint behind the camera is culled."""
    intr = np.asarray(to_numpy(intr), np.float32)
    c2w = np.asarray(to_numpy(c2w), np.float32)
    R, t = c2w[:3, :3], c2w[:3, 3]
    pts_cam = (np.asarray(layer["points"], np.float32) - t) @ R  # w2c
    z = pts_cam[:, 2]
    uv = pts_cam[:, :2] / np.maximum(z[:, None], 1e-9)
    pix = uv @ intr[:2, :2].T + intr[:2, 2]
    e = np.asarray(layer["edges"], np.int64)
    ok = (z[e[:, 0]] > 1e-3) & (z[e[:, 1]] > 1e-3)
    e = e[ok]
    return pix[e[:, 0]], pix[e[:, 1]]


def draw_datalayers(img: np.ndarray, layers: Sequence[Lineset], intr, c2w
                    ) -> np.ndarray:
    """Paint projected line-set layers over a rendered uint8 frame."""
    from nr3d_lib_tpu_torch.plot.plot_basic import draw_segments_2d

    hw = img.shape[:2]
    for layer in layers:
        p0, p1 = project_datalayer(layer, intr, c2w, hw)
        color = (np.clip(np.asarray(layer.get("color", (0, 1, 0))), 0, 1)
                 * 255).astype(np.uint8)
        img = draw_segments_2d(img, p0, p1,
                               color=tuple(int(c) for c in color))
    return img
