"""Triangle-mesh IO and mesh extraction (port of
nr3d_lib_tpu/graphics/trianglemesh.py `save_obj`, `load_obj`,
`marching_cubes`, `_surface_nets`, `extract_mesh`).

`extract_mesh` evaluates the SDF on a dense grid on the model's device, in
chunks, and meshes the volume on the host with the native marching
tetrahedra (`bindings.py`). There is no skimage branch: the card's machine
has no skimage, and a failed native build raises. `_surface_nets`, the
JAX package's dependency-free mesher, is kept as a plain function.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["save_obj", "load_obj", "marching_cubes", "extract_mesh"]


def save_obj(path: str, vertices, faces) -> None:
    vertices = to_numpy(vertices)
    faces = to_numpy(faces)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces + 1:  # obj is 1-indexed
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                faces.append([int(tok.split("/")[0]) - 1
                              for tok in line.split()[1:4]])
    return (np.asarray(verts, np.float32).reshape(-1, 3),
            np.asarray(faces, np.int32).reshape(-1, 3))


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
    """Isosurface of a dense scalar grid → (verts, faces), by the native
    marching tetrahedra."""
    from nr3d_lib_tpu_torch.bindings import marching_tets_native

    verts, faces = marching_tets_native(volume, level)
    return verts * np.asarray(spacing, np.float32), faces


def _surface_nets(volume: np.ndarray, level: float, spacing
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Naive surface nets: one vertex per sign-change cell, quads split
    into triangles."""
    vol = np.asarray(volume, np.float32) - level
    nx, ny, nz = vol.shape
    inside = vol < 0
    acc = np.zeros((nx - 1, ny - 1, nz - 1), dtype=np.int32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                acc += inside[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
    crossing = (acc > 0) & (acc < 8)
    idx = np.full(crossing.shape, -1, dtype=np.int64)
    xs, ys, zs = np.nonzero(crossing)
    idx[xs, ys, zs] = np.arange(len(xs))
    verts = (np.stack([xs, ys, zs], -1).astype(np.float32) + 0.5) * \
        np.asarray(spacing, np.float32)

    faces = []
    for axis in range(3):
        # an edge along `axis` whose ends differ in sign: a quad of the
        # four cells around it
        e0 = inside[1:-1, 1:-1, 1:-1]
        shift = [0, 0, 0]
        shift[axis] = 1
        e1 = inside[1 + shift[0]:nx - 1 + shift[0],
                    1 + shift[1]:ny - 1 + shift[1],
                    1 + shift[2]:nz - 1 + shift[2]]
        o1, o2 = [(1, 2), (0, 2), (0, 1)][axis]
        for x, y, z in zip(*np.nonzero(e0 != e1)):
            cells = []
            for da in (0, 1):
                for db in (0, 1):
                    cpos = [x, y, z]
                    cpos[o1] -= da
                    cpos[o2] -= db
                    cells.append(idx[tuple(cpos)])
            if all(ci >= 0 for ci in cells):
                a, b, cc, d = cells[0], cells[1], cells[3], cells[2]
                quad = (a, b, cc, d) if e0[x, y, z] else (d, cc, b, a)
                faces.append([quad[0], quad[1], quad[2]])
                faces.append([quad[0], quad[2], quad[3]])
    faces = np.asarray(faces, np.int32) if faces else \
        np.zeros((0, 3), np.int32)
    return verts, faces


@torch.no_grad()
def extract_mesh(query_sdf: Callable[[torch.Tensor], torch.Tensor],
                 resolution: int = 256, level: float = 0.0,
                 aabb_min=(-1.0, -1.0, -1.0), aabb_max=(1.0, 1.0, 1.0),
                 chunk: int = 2 ** 16, filepath: Optional[str] = None,
                 device=None):
    """Evaluate an SDF on a dense grid, chunk by chunk on `device` (None
    means CUDA), and mesh it. query_sdf: [N,3] tensor → [N] tensor."""
    dev = resolve_device(device)
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    lin = [np.linspace(aabb_min[i], aabb_max[i], resolution,
                       dtype=np.float32) for i in range(3)]
    grid = torch.from_numpy(np.stack(np.meshgrid(*lin, indexing="ij"),
                                     axis=-1).reshape(-1, 3)).to(dev)
    sdf = torch.cat([query_sdf(grid[s:s + chunk]).reshape(-1)
                     for s in range(0, grid.shape[0], chunk)])
    volume = to_numpy(sdf).astype(np.float32).reshape((resolution,) * 3)
    spacing = (aabb_max - aabb_min) / (resolution - 1)
    verts, faces = marching_cubes(volume, level=level, spacing=tuple(spacing))
    verts = verts + aabb_min
    if filepath is not None:
        save_obj(filepath, verts, faces)
    return verts, faces
