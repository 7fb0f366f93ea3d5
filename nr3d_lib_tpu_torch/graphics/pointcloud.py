"""Point-cloud IO (port of nr3d_lib_tpu/graphics/pointcloud.py `save_ply`,
`load_ply`): ASCII PLY, xyz with optional 8-bit rgb."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["save_ply", "load_ply"]


def save_ply(path: str, pts, colors=None) -> None:
    """pts [N,3]; colors [N,3] uint8 or float in [0,1]."""
    pts = to_numpy(pts).astype(np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            c = to_numpy(colors)
            if c.dtype != np.uint8:
                c = (np.clip(c, 0, 1) * 255).astype(np.uint8)
            for p, cc in zip(pts, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {cc[0]} {cc[1]} {cc[2]}\n")
        else:
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """ASCII PLY → (pts [N,3] float32, colors [N,3] uint8 or None)."""
    with open(path) as f:
        if f.readline().strip() != "ply":
            raise ValueError(f"{path} is not a PLY file")
        n, has_color = 0, False
        while True:
            line = f.readline().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar red"):
                has_color = True
            if line == "end_header":
                break
        data = np.loadtxt(f, max_rows=n, ndmin=2)
    pts = data[:, :3].astype(np.float32)
    colors = data[:, 3:6].astype(np.uint8) \
        if has_color and data.shape[1] >= 6 else None
    return pts, colors
