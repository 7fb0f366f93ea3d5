"""Cell-packed permutohedral lattice: geometry shared by the cell layouts.

Port of the geometry of nr3d_lib_tpu/ops/permuto_cell.py (and of
`_simplex_parts` in nr3d_lib_tpu/ops/permuto.py, kept here as a private
helper: the port imports nothing of the JAX package). A point's simplex in
the permutohedral lattice is found by elevating it onto the sum-zero
hyperplane, rounding to the nearest remainder-0 point and ranking the
differential. The cell layout hashes that remainder-0 base point (the
cell) to a table row and gives each of the cell's 2^(d+1) vertex slots its
own lanes in the row, so one row holds every vertex of whichever simplex
of the cell a point falls in. Coarse levels whose reachable cells fit the
row budget index a box bijectively instead (dense levels).

Only the geometry lives here: the F=4 bf16-packed encode that uses it is
`ops/permuto_cell4.py`. Its CUDA kernels (`csrc/permuto_cell4.cu`) repeat
this arithmetic operation by operation, so a point picks the same simplex
and row on both routes:
  * the elevation sums the scaled coordinates from the last one, and
    `tail − i·cf[i−1]` is two separately rounded operations (no FMA);
  * the hyperplane constants `sf` are float32 values computed on the host
    (`hyperplane_scales`), the way the JAX package computes them;
  * a rounding tie goes down (`up − e < e − down` is strict);
  * rank ties break by index; negative coordinates enter the hash as
    int32 → uint32 (two's complement).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nr3d_lib_tpu_torch.ops.lotd_brick import HASH_PRIMES

__all__ = ["PermutoCellLevel", "PermutoCellMeta", "make_permuto_cell_meta",
           "hyperplane_scales", "f32_scalars", "LANES", "N_FEAT"]

LANES = 128
N_FEAT = 2            # features per vertex slot of the F=2 lane layout
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class PermutoCellLevel:
    scale: Tuple[float, ...]          # per-axis lattice scale
    n_rows: int
    row_offset: int
    # dense (collision-free) levels: bijective index over the reachable
    # k-coordinate box instead of a hash; None means a hashed level
    box_lo: Optional[Tuple[int, ...]] = None
    box_dims: Optional[Tuple[int, ...]] = None

    @property
    def kind(self) -> str:
        return "hash" if self.box_dims is None else "dense"


@dataclass(frozen=True)
class PermutoCellMeta:
    n_dims: int
    levels: Tuple[PermutoCellLevel, ...]

    @cached_property
    def n_slots(self) -> int:                      # vertex slots per cell
        return 1 << (self.n_dims + 1)

    @cached_property
    def cells_per_row(self) -> int:
        return LANES // (self.n_slots * N_FEAT)

    @cached_property
    def n_levels(self) -> int:
        return len(self.levels)

    @cached_property
    def total_rows(self) -> int:
        return sum(l.n_rows for l in self.levels)


def _k_ranges(n_dims: int, scale: Tuple[float, ...]
              ) -> Tuple[List[int], List[int]]:
    """Per-coordinate integer range [lo_i, hi_i] of rem0_i/(d+1) over
    x ∈ [0,1]^d at this lattice scale: the elevation is linear in
    nonnegative cf_j ∈ [0, scale_j·sf_j], so each elevated coordinate's
    extremes follow from its coefficients' signs; ±1 covers the rounding
    and the sum fix-up."""
    d = n_dims
    dp1 = d + 1
    inv_std = dp1 * math.sqrt(2.0 / 3.0)
    sf = [inv_std / math.sqrt((i + 1) * (i + 2)) for i in range(d)]
    cfmax = [scale[i] * sf[i] for i in range(d)]
    los, his = [], []
    for i in range(dp1):
        mx = sum(cfmax[i:])
        mn = -i * cfmax[i - 1] if i > 0 else 0.0
        los.append(math.floor(mn / dp1 + 0.5) - 1)
        his.append(math.ceil(mx / dp1 - 0.5) + 1)
    return los, his


def make_permuto_cell_meta(n_dims: int,
                           res_list: Sequence[Union[float, Sequence[float]]],
                           hashmap_rows: int = 4096,
                           auto_dense: bool = True) -> PermutoCellMeta:
    """hashmap_rows: rows per level (capacity rows · cells_per_row cells).
    With auto_dense, a level whose reachable box of the first d
    k-coordinates fits that capacity becomes dense, with only as many rows
    as it has cells."""
    if not 2 <= n_dims <= 5:
        raise ValueError(f"n_dims must be in [2, 5], got {n_dims}")
    c = LANES // ((1 << (n_dims + 1)) * N_FEAT)
    levels: List[PermutoCellLevel] = []
    off = 0
    for s in res_list:
        scale = (float(s),) * n_dims if np.isscalar(s) \
            else tuple(float(v) for v in s)
        rows = int(hashmap_rows)
        box_lo = box_dims = None
        if auto_dense:
            los, his = _k_ranges(n_dims, scale)
            dims = [hi - lo + 1 for lo, hi in zip(los[:-1], his[:-1])]
            n_cells = int(np.prod(dims))
            if n_cells <= int(hashmap_rows) * c:
                box_lo = tuple(los[:-1])
                box_dims = tuple(dims)
                rows = max(1, -(-n_cells // c))
        levels.append(PermutoCellLevel(scale, rows, off, box_lo, box_dims))
        off += rows
    return PermutoCellMeta(n_dims, tuple(levels))


# ---------------------------------------------------------- lattice math
def hyperplane_scales(d: int) -> np.ndarray:
    """sf [d] float32: the elevation's per-axis factors, an f32 array of
    1/√((i+1)(i+2)) times the f32 of (d+1)·√(2/3), as JAX computes them."""
    inv_std = np.float32((d + 1) * math.sqrt(2.0 / 3.0))
    base = np.asarray([1.0 / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
                      np.float32)
    return (base * inv_std).astype(np.float32)


def f32_scalars(values) -> List[float]:
    """Python floats holding float32 values: a tensor times one of them
    rounds once in float32, as a product with a float32 tensor does, and
    needs no host-to-device copy (which would synchronize the stream)."""
    return [float(v) for v in np.asarray(values, np.float32)]


def _simplex_parts(x: torch.Tensor, d: int):
    """x [N, d] (already scaled) → (rem0 [N,d+1] float, rank [N,d+1]
    int64, bary [N,d+1]): the enclosing simplex's remainder-0 base point,
    the rank permutation picking which of the cell's (d+1)! simplices
    holds x, and the barycentric weights of its d+1 vertices.
    Differentiable in x through the barycentric weights."""
    n = x.shape[0]
    dp1 = d + 1
    cf = [x[:, a] * s for a, s in enumerate(f32_scalars(
        hyperplane_scales(d)))]
    # elevated[i] = Σ_{j≥i} cf_j − i·cf_{i−1}, the sums taken from the last
    rev = [None] * d
    rev[d - 1] = cf[d - 1]
    for i in range(d - 2, -1, -1):
        rev[i] = rev[i + 1] + cf[i]
    zero = torch.zeros(n, dtype=x.dtype, device=x.device)
    elev = torch.stack([rev[0]] + [(rev[i] if i < d else zero)
                                   - i * cf[i - 1]
                                   for i in range(1, dp1)], -1)

    # nearest remainder-0 point: round each coordinate to a multiple of d+1
    e = elev.detach()
    v = e / dp1
    up = torch.ceil(v) * dp1
    down = torch.floor(v) * dp1
    rem0 = torch.where(up - e < e - down, up, down)
    sum_ = torch.round(rem0.sum(-1) / dp1).to(torch.int64)          # [N]

    # rank the differential; ties break by index
    diff = e - rem0
    ii = torch.arange(dp1, device=x.device)
    gt = diff[:, :, None] < diff[:, None, :]
    tie = (diff[:, :, None] == diff[:, None, :]) & (ii[:, None] > ii[None, :])
    rank = (gt | tie).sum(-1) + sum_[:, None]

    # fix points whose remainder sum is not 0
    low, high = rank < 0, rank > d
    rank = torch.where(low, rank + dp1, torch.where(high, rank - dp1, rank))
    rem0 = rem0 + low.to(x.dtype) * dp1 - high.to(x.dtype) * dp1

    # barycentric weights: bary_k = vdiff[rank = d−k] − vdiff[rank = d+1−k],
    # bary_0 = vdiff[rank = d] + 1 − vdiff[rank = 0] (one-hot sums, as JAX)
    vdiff = (elev - rem0) / dp1                                      # [N,d+1]
    j = torch.arange(dp1 + 1, device=x.device)
    oh = ((d - rank)[..., None] == j).to(x.dtype) - \
        ((dp1 - rank)[..., None] == j).to(x.dtype)            # [N,d+1,d+2]
    bary_full = torch.sum(oh * vdiff[..., None], 1)                 # [N, d+2]
    b0 = bary_full[:, 0] + 1.0 + bary_full[:, dp1]
    bary = torch.cat([b0[:, None], bary_full[:, 1:dp1]], -1)
    return rem0, rank, bary


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a · prime) mod 2^32 for int64 a ∈ [0, 2^32), without overflowing
    int64 (split into 16-bit halves)."""
    lo = (a & 0xFFFF) * prime
    hi = (((a >> 16) * prime) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _level_rows_lanes_bary(x: torch.Tensor, level: PermutoCellLevel,
                           meta: PermutoCellMeta):
    """For one level: (row [N] int64 absolute, lane [N, d+1] int64 — the
    F=2 lane of vertex k's first feature —, bary [N, d+1], rank [N, d+1])."""
    d = meta.n_dims
    dp1 = d + 1
    scaled = torch.stack([x[:, a] * s for a, s in
                          enumerate(f32_scalars(level.scale))], -1)
    rem0, rank, bary = _simplex_parts(scaled, d)
    rem0_i = rem0.to(torch.int64)
    c = meta.cells_per_row
    if level.box_dims is not None:
        k = torch.div(rem0_i, dp1, rounding_mode="floor")
        idx = torch.zeros_like(k[:, 0])
        for i in range(d):                                 # first d coords
            ki = (k[:, i] - level.box_lo[i]).clamp(0, level.box_dims[i] - 1)
            idx = idx * level.box_dims[i] + ki
    else:
        u = rem0_i & _U32                                  # int32 → uint32
        h = _mul_u32(u[:, 0], HASH_PRIMES[0])
        for i in range(1, d):
            h = h ^ _mul_u32(u[:, i], HASH_PRIMES[i % 7])
        idx = h % (level.n_rows * c)
    row = idx // c + level.row_offset
    lane_base = (idx % c) * (meta.n_slots * N_FEAT)
    # vertex k sits at slot Σ_i [rank_i ≥ d+1−k]·2^i
    ks = torch.arange(dp1, device=x.device)
    cond = rank[:, None, :] >= (dp1 - ks)[None, :, None]            # [N,k,i]
    slot = torch.sum(cond.to(torch.int64) << ks[None, None, :], -1)
    lane = lane_base[:, None] + slot * N_FEAT
    return row, lane, bary, rank
