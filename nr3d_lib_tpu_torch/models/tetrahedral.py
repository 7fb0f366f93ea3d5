"""DMTet: differentiable marching tetrahedra over a deformable tet grid
(port of nr3d_lib_tpu/models/tetrahedral.py).

Static shapes as in the JAX version: every tet emits two triangle slots
and a validity mask (an empty tet's slots are degenerate and masked), so
the gradients reach both the SDF values and the vertex positions through
the crossing-point lerp. `make_tet_grid` builds the grid vectorised, with
the JAX version's tets in its order (cubes x-major, then z fastest, six
tets a cube). `marching_tets_jax` keeps the JAX name, its public API; it
gathers the triangles' corners from the [Nt, 6, 3] edge points without
JAX's two repeats, which at resolution 128 (12,290,298 tets) would cost
~1.8 GB each. `DMTet.to_mesh` deduplicates on the host in numpy, as the
JAX version does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nr3d_lib_tpu_torch.device import resolve_device

__all__ = ["make_tet_grid", "marching_tets_jax", "DMTet"]

# the crack-free 6-tet split of a cube (csrc/host/mcubes.cpp's too)
_CUBE_TETS = np.asarray([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], np.int64)

# a tet's edges in a fixed order
_TET_EDGES = np.asarray([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                        np.int64)


def _tri_table() -> np.ndarray:
    """For each 4-bit inside mask, two triangles as edge-index triples (−1
    padded); the winding is fixed at run time."""
    table = -np.ones((16, 2, 3), np.int64)

    def edge_id(a, b):
        a, b = min(a, b), max(a, b)
        return int(np.nonzero((_TET_EDGES == [a, b]).all(-1))[0][0])

    for mask in range(1, 15):
        ins = [k for k in range(4) if (mask >> k) & 1]
        outs = [k for k in range(4) if not (mask >> k) & 1]
        if len(ins) in (1, 3):
            ref = ins[0] if len(ins) == 1 else outs[0]
            table[mask, 0] = [edge_id(ref, o) for o in range(4) if o != ref]
        else:
            q = [edge_id(ins[0], outs[0]), edge_id(ins[0], outs[1]),
                 edge_id(ins[1], outs[1]), edge_id(ins[1], outs[0])]
            table[mask, 0] = [q[0], q[1], q[2]]
            table[mask, 1] = [q[0], q[2], q[3]]
    return table


_TRI_TABLE = _tri_table()


def make_tet_grid(resolution: int, aabb_min=(-1.0, -1.0, -1.0),
                  aabb_max=(1.0, 1.0, 1.0), device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A regular grid of resolution³ vertices → (verts [Nv, 3] float32,
    tets [6·(resolution−1)³, 4] int32) on `device` (the card unless "cpu"
    is asked for)."""
    dev = resolve_device(device)
    n = resolution
    lin = [np.linspace(aabb_min[d], aabb_max[d], n) for d in range(3)]
    verts = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    c = torch.arange(n - 1, device=dev)
    base = ((c[:, None, None] * n + c[None, :, None]) * n +
            c[None, None, :]).reshape(-1)                 # vid(x, y, z)
    k = np.arange(8)
    corner = ((k >> 2) & 1) * n * n + ((k >> 1) & 1) * n + (k & 1)
    off = torch.from_numpy(corner[_CUBE_TETS]).to(dev)     # [6, 4]
    tets = (base[:, None, None] + off[None]).reshape(-1, 4)
    return (torch.from_numpy(verts.astype(np.float32)).to(dev),
            tets.to(torch.int32))


def marching_tets_jax(verts: torch.Tensor, sdf: torch.Tensor,
                      tets: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """verts [Nv, 3] (deformation included), sdf [Nv], tets [Nt, 4] →
    (tri_verts [Nt, 2, 3, 3], tri_mask [Nt, 2], mask_bits [Nt]): a
    fixed-shape triangle soup, each triangle wound with its normal away
    from the tet's inside vertices; masked slots are degenerate. Gradients
    flow into verts and sdf."""
    dev = verts.device
    tl = tets.to(torch.int64)
    tv = verts[tl]                                  # [Nt, 4, 3]
    ts = sdf[tl]                                    # [Nt, 4]
    inside = ts < 0
    weights = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=dev)
    mask_bits = torch.sum(inside.to(torch.int64) * weights, -1)

    ea = torch.from_numpy(_TET_EDGES[:, 0]).to(dev)
    eb = torch.from_numpy(_TET_EDGES[:, 1]).to(dev)
    va, vb = ts[:, ea], ts[:, eb]                   # [Nt, 6]
    denom = va - vb
    t = va / torch.where(torch.abs(denom) < 1e-12,
                         torch.full_like(denom, 1e-12), denom)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    pa, pb = tv[:, ea], tv[:, eb]                   # [Nt, 6, 3]
    edge_pts = pa + t * (pb - pa)

    tri_edges = torch.from_numpy(_TRI_TABLE).to(dev)[mask_bits]  # [Nt,2,3]
    tri_mask = tri_edges[..., 0] >= 0
    safe = torch.clamp(tri_edges, min=0)
    nt = tl.shape[0]

    def corners(idx):                               # [Nt,2,3] → [Nt,2,3,3]
        g = idx.reshape(nt, 6, 1).expand(nt, 6, 3)
        return torch.gather(edge_pts, 1, g).reshape(nt, 2, 3, 3)

    with torch.no_grad():
        # the winding: normal away from the centroid of the inside vertices
        tri = corners(safe)
        w_in = inside.to(verts.dtype)[..., None]
        in_centroid = torch.sum(tv * w_in, 1) / torch.clamp(
            torch.sum(w_in, 1), min=1e-8)
        v0, v1, v2 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
        nrm = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
        outward = torch.sum(nrm * ((v0 + v1 + v2) / 3 -
                                   in_centroid[:, None]), -1) >= 0
        del tri, v0, v1, v2, nrm
    flipped = safe[..., [0, 2, 1]]
    tri_verts = corners(torch.where(outward[..., None], safe, flipped))
    return tri_verts, tri_mask, mask_bits


class DMTet:
    """Deformable marching tetrahedra over a regular grid: `dmtet(sdf,
    deform)` → `marching_tets_jax` of the base vertices moved by
    tanh(deform)·max_deform·cell."""

    def __init__(self, resolution: int = 32, aabb_min=(-1, -1, -1),
                 aabb_max=(1, 1, 1), max_deform: float = 0.45, device=None):
        self.base_verts, self.tets = make_tet_grid(resolution, aabb_min,
                                                   aabb_max, device)
        self.cell = float((aabb_max[0] - aabb_min[0]) / (resolution - 1))
        self.max_deform = max_deform

    def __call__(self, sdf: torch.Tensor,
                 deform: Optional[torch.Tensor] = None):
        verts = self.base_verts
        if deform is not None:
            verts = verts + torch.tanh(deform) * (self.max_deform * self.cell)
        return marching_tets_jax(verts, sdf, self.tets)

    def to_mesh(self, tri_verts: torch.Tensor, tri_mask: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray]:
        """The masked triangles → (verts float32, faces int32) on the host,
        vertices merged where they agree to 6 decimals."""
        tv = tri_verts.detach()[tri_mask].cpu().numpy()
        uniq, inv = np.unique(np.round(tv.reshape(-1, 3), 6), axis=0,
                              return_inverse=True)
        return uniq.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)
