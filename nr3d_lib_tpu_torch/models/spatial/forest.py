"""Forest block space: a large scene as a grid of occupied blocks (port of
nr3d_lib_tpu/models/spatial/forest.py `ForestBlockSpace`).

Blocks are cubes of side `block_size` anchored at `origin`; the occupied
ones get dense slots [0, n_trees) through `block_idx` (−1 = empty), and
each block's LoTD table is the slot's part of the forest table (the
`bidx` of `ops.lotd_brick.brick_encode_batched`).

State: the buffers `origin`, `occupied` and `block_idx`. The slots, the
occupied blocks' coordinates and the culling hierarchy are rebuilt from
`occupied` whenever it is populated or loaded (`load_state_dict` of the
space or of any module that holds it).

`populate_from_mesh` and `populate_from_pinhole_cameras` are not ported
yet (ROADMAP.md A11).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.graphics.raytest import ray_box_intersection
from nr3d_lib_tpu_torch.ops.occgrid_march import march_steps

__all__ = ["ForestBlockSpace"]


def _topk_by_key(key: torch.Tensor, payloads, k: int):
    """The k smallest-key entries of each row with their payloads: a
    stable sort on the key, so ties (the misses' inf) keep their order."""
    order = torch.sort(key, dim=-1, stable=True).indices[:, :k]
    return tuple(p.gather(-1, order) for p in payloads)


class ForestBlockSpace(nn.Module):
    def __init__(self, *, level: int = 4, origin=(-1.0, -1.0, -1.0),
                 block_size: float = 0.5,
                 resolution: Optional[Sequence[int]] = None, device=None):
        """resolution: blocks per axis (default 2^level)."""
        super().__init__()
        if resolution is None:
            resolution = (2 ** level,) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.level = level
        self.block_size = float(block_size)
        self.register_buffer("origin", torch.as_tensor(
            origin, dtype=torch.float32, device=device).clone())
        self.register_buffer("occupied", torch.zeros(
            self.resolution, dtype=torch.bool, device=device))
        self.register_buffer("block_idx", torch.full(
            self.resolution, -1, dtype=torch.int32, device=device))
        self.n_trees = 0
        self._set_coords(np.zeros((0, 3), np.int64))
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._rebuild_slots())

    # ------------------------------------------------------------ populate
    def _set_coords(self, coords: np.ndarray) -> None:
        self._block_coords = torch.as_tensor(
            coords, dtype=torch.int32, device=self.origin.device)
        self._build_hierarchy()

    def _rebuild_slots(self) -> None:
        occ = self.occupied.cpu().numpy()
        idx = -np.ones(self.resolution, np.int32)
        coords = np.argwhere(occ)
        idx[tuple(coords.T)] = np.arange(len(coords), dtype=np.int32)
        self.block_idx.copy_(torch.from_numpy(idx))
        self.n_trees = int(len(coords))
        self._set_coords(coords)

    def _build_hierarchy(self, factor: int = 4, max_top: int = 4096) -> None:
        """Supercells of factor³ children per level, stacked until the
        coarsest level has ≤ max_top cells (at most 4 levels): the culling
        levels of `ray_test_segments(hierarchy=True)`. Built on the host
        with numpy, as in JAX."""
        dev = self.origin.device
        self._hier_factor = int(factor)
        coords = self._block_coords.cpu().numpy()
        self._hier_coords, self._hier_members = [], []
        if len(coords) == 0:
            return
        cur = coords
        while True:
            sc = cur // factor
            uniq, inv = np.unique(sc, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            members = -np.ones((len(uniq), factor ** 3), np.int32)
            fill = np.zeros(len(uniq), np.int64)
            for slot, s in enumerate(inv):
                members[s, fill[s]] = slot
                fill[s] += 1
            self._hier_coords.append(torch.as_tensor(uniq, dtype=torch.int32,
                                                     device=dev))
            self._hier_members.append(torch.as_tensor(members, device=dev))
            cur = uniq
            if len(uniq) <= max_top or len(self._hier_coords) >= 4:
                break

    def populate_from_corners(self, corners) -> None:
        """corners: [N,3] integer block coordinates to occupy."""
        occ = np.zeros(self.resolution, bool)
        c = np.asarray(corners, np.int64)
        occ[c[:, 0], c[:, 1], c[:, 2]] = True
        self.occupied.copy_(torch.from_numpy(occ))
        self._rebuild_slots()

    def populate_from_points(self, pts, dilate: int = 0) -> None:
        """Occupy the blocks that hold any of `pts` [N,3] (then dilate)."""
        pts = np.asarray(pts)
        origin = self.origin.cpu().numpy()
        b = np.floor((pts - origin) / self.block_size).astype(np.int64)
        res = np.asarray(self.resolution)
        b = b[((b >= 0) & (b < res)).all(-1)]
        occ = np.zeros(self.resolution, bool)
        occ[b[:, 0], b[:, 1], b[:, 2]] = True
        if dilate > 0:
            from scipy import ndimage

            occ = ndimage.binary_dilation(occ, iterations=dilate)
        self.occupied.copy_(torch.from_numpy(occ))
        self._rebuild_slots()

    # ------------------------------------------------------------- mapping
    @property
    def block_coords(self) -> torch.Tensor:
        """[n_trees, 3] integer coordinates of the occupied blocks."""
        return self._block_coords

    def block_aabb(self) -> torch.Tensor:
        """World AABB of the whole forest [2,3]."""
        o = self.origin
        return torch.stack([o, o + torch.as_tensor(
            self.resolution, dtype=o.dtype, device=o.device) *
            self.block_size])

    def block_of_points(self, x: torch.Tensor) -> torch.Tensor:
        """World points → block slot (−1 outside or empty), int32."""
        b = torch.floor((x - self.origin) / self.block_size).to(torch.int64)
        res = torch.as_tensor(self.resolution, device=x.device)
        inb = torch.all((b >= 0) & (b < res), -1)
        b = torch.minimum(torch.clamp(b, min=0), res - 1)
        slot = self.block_idx[b[..., 0], b[..., 1], b[..., 2]]
        return torch.where(inb, slot, torch.full_like(slot, -1))

    def normalize_coords(self, x: torch.Tensor, bidx: torch.Tensor
                         ) -> torch.Tensor:
        """World → block-local [-1,1] in each point's block slot (slot 0
        for bidx < 0)."""
        corners = self._block_coords[torch.clamp(bidx, min=0).long()]
        lo = self.origin + corners.to(x.dtype) * self.block_size
        return (x - lo) / self.block_size * 2.0 - 1.0

    # ------------------------------------------------------------- ray test
    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near: Optional[float] = None, far: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
        """Slab test against the forest's bounds."""
        aabb = self.block_aabb()
        t_near, t_far, hit = ray_box_intersection(
            rays_o, rays_d, aabb[0], aabb[1], t_min=near or 0.0,
            t_max=far or 1e10)
        return {"near": t_near, "far": t_far, "mask": hit,
                "rays_o": rays_o, "rays_d": rays_d,
                "num_rays": rays_o.shape[0]}

    @staticmethod
    def _inv_d(rays_d: torch.Tensor) -> torch.Tensor:
        return 1.0 / torch.where(rays_d.abs() < 1e-12,
                                 torch.full_like(rays_d, 1e-12), rays_d)

    def _slab(self, lo: torch.Tensor, hi: torch.Tensor, rays_o: torch.Tensor,
              rays_d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Boxes [M, 3] against rays [R, 3] → (t_in, t_out) [R, M]."""
        o = rays_o[:, None, :]
        inv_d = self._inv_d(rays_d)[:, None, :]
        t1 = (lo[None] - o) * inv_d
        t2 = (hi[None] - o) * inv_d
        return (torch.minimum(t1, t2).amax(-1),
                torch.maximum(t1, t2).amin(-1))

    def ray_test_segments(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                          near=None, far=None, max_segments: int = 32,
                          hierarchy: Optional[bool] = None,
                          coarse_keep: int = 16) -> Dict[str, torch.Tensor]:
        """Per-ray block segments, sorted by entry: segment k of ray r
        covers t ∈ [seg_t_in, seg_t_out) inside block slot seg_bidx.
        Small forests slab-test every block; large ones (or
        hierarchy=True) cull against the supercell levels first, keeping
        the `coarse_keep` nearest hits a level. Returns {seg_t_in,
        seg_t_out, seg_bidx, seg_mask [R,K], n_segs [R], near, far,
        mask, rays_o, rays_d, num_rays}."""
        r_n, dev, dt = rays_o.shape[0], rays_o.device, rays_o.dtype
        t_lo = torch.zeros((r_n,), dtype=dt, device=dev) if near is None \
            else torch.as_tensor(near, dtype=dt, device=dev).expand(r_n)
        t_hi = torch.full((r_n,), 1e10, dtype=dt, device=dev) \
            if far is None \
            else torch.as_tensor(far, dtype=dt, device=dev).expand(r_n)
        if hierarchy is None:
            hierarchy = self.n_trees > 4096

        blk_lo = (self.origin[None]
                  + self._block_coords.to(dt) * self.block_size)
        if hierarchy and self._hier_coords:
            f = self._hier_factor
            n_lv = len(self._hier_coords)
            kc = int(coarse_keep)
            o = rays_o[:, None, :]
            inv_d = self._inv_d(rays_d)[:, None, :]

            def boxes_t(lo, size):
                t1 = (lo - o) * inv_d
                t2 = (lo + size - o) * inv_d
                return (torch.minimum(t1, t2).amax(-1),
                        torch.maximum(t1, t2).amin(-1))

            # dense test of the coarsest level
            size_top = self.block_size * f ** n_lv
            s_lo = (self.origin[None]
                    + self._hier_coords[n_lv - 1].to(dt) * size_top)
            ts_in, ts_out = self._slab(s_lo, s_lo + size_top, rays_o,
                                       rays_d)
            s_hit = (torch.maximum(ts_in, t_lo[:, None])
                     < torch.minimum(ts_out, t_hi[:, None]))
            k_top = min(kc, ts_in.shape[1])
            iota = torch.arange(ts_in.shape[1], dtype=torch.int32,
                                device=dev).expand(ts_in.shape)
            inf = torch.full_like(ts_in, float("inf"))
            kept_idx, kept_valid = _topk_by_key(
                torch.where(s_hit, ts_in, inf), (iota, s_hit.to(torch.int32)),
                k_top)
            kept_valid = kept_valid.bool()
            # descend: the children of the K nearest hits, level by level
            for i in range(n_lv, 0, -1):
                cand = self._hier_members[i - 1][kept_idx.long()]
                cand = torch.where(kept_valid[..., None], cand,
                                   torch.full_like(cand, -1)
                                   ).reshape(r_n, -1)
                safe = torch.clamp(cand, min=0)
                size_c = self.block_size * f ** (i - 1)
                if i - 1 == 0:
                    lo = blk_lo[safe.long()]
                else:
                    lo = (self.origin[None] + self._hier_coords[i - 2].to(dt)
                          [safe.long()] * size_c)
                t_in, t_out = boxes_t(lo, size_c)
                valid = ((cand >= 0)
                         & (torch.maximum(t_in, t_lo[:, None])
                            < torch.minimum(t_out, t_hi[:, None])))
                if i - 1 == 0:
                    bidx_cand = cand
                    break
                kept_idx, kept_valid = _topk_by_key(
                    torch.where(valid, t_in,
                                torch.full_like(t_in, float("inf"))),
                    (safe, valid.to(torch.int32)), kc)
                kept_valid = kept_valid.bool()
        else:
            t_in, t_out = self._slab(blk_lo, blk_lo + self.block_size,
                                     rays_o, rays_d)
            valid = torch.ones_like(t_in, dtype=torch.bool)
            bidx_cand = torch.arange(t_in.shape[1], dtype=torch.int32,
                                     device=dev).expand(t_in.shape)

        t_in = torch.maximum(t_in, t_lo[:, None])
        t_out = torch.minimum(t_out, t_hi[:, None])
        hit = valid & (t_in < t_out)
        k = min(int(max_segments), t_in.shape[1])
        seg_t_in, seg_t_out, seg_mask, seg_bidx = _topk_by_key(
            torch.where(hit, t_in, torch.full_like(t_in, float("inf"))),
            (t_in, t_out, hit.to(torch.int32), bidx_cand), k)
        seg_mask = seg_mask.bool()
        seg_bidx = torch.where(seg_mask, seg_bidx,
                               torch.full_like(seg_bidx, -1))
        n_segs = seg_mask.to(torch.int32).sum(1)
        ray_near = torch.where(seg_mask[:, 0], seg_t_in[:, 0], t_lo)
        last = torch.where(seg_mask, seg_t_out,
                           torch.full_like(seg_t_out, -float("inf"))).amax(1)
        ray_far = torch.where(n_segs > 0, last, t_hi)
        return {"seg_t_in": seg_t_in, "seg_t_out": seg_t_out,
                "seg_bidx": seg_bidx, "seg_mask": seg_mask, "n_segs": n_segs,
                "near": ray_near, "far": ray_far, "mask": n_segs > 0,
                "rays_o": rays_o, "rays_d": rays_d, "num_rays": r_n}

    def march_segments(self, segs: Dict[str, torch.Tensor], *,
                       steps_per_segment: int,
                       u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
        """S uniform steps inside each block segment, in segment order (so
        sorted by t: blocks are disjoint). `u` [R, K, S] in [0,1) jitters
        the steps (the JAX version's `perturb_key` draw, handed in); None
        takes their midpoints. → (t, dt, bidx, mask), each [R, K·S]."""
        s = int(steps_per_segment)
        t_in, t_out = segs["seg_t_in"], segs["seg_t_out"]
        r, k = t_in.shape
        dt = (torch.clamp(t_out - t_in, min=0.0) / s)[..., None]
        i = torch.arange(s, dtype=t_in.dtype, device=t_in.device)
        t = t_in[..., None] + (i + (0.5 if u is None else u)) * dt
        mask = segs["seg_mask"][..., None] & (t < t_out[..., None])
        bidx = segs["seg_bidx"][..., None].expand(r, k, s)
        return (t.reshape(r, k * s), dt.expand(r, k, s).reshape(r, k * s),
                bidx.reshape(r, k * s), mask.reshape(r, k * s))

    def ray_march_blocks(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                         near: torch.Tensor, far: torch.Tensor, *,
                         n_steps: int, step_size: float,
                         u: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, ...]:
        """March world rays at fixed steps (`u` [R, S] jitters them) →
        (t, dt, bidx (−1 empty), mask) [R, S]."""
        t, dt, in_range = march_steps(near, far, n_steps, step_size, u=u)
        x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
        bidx = self.block_of_points(x)
        return t, dt, bidx, in_range & (bidx >= 0)
