"""Cell-packed permutohedral lattice: the geometry shared by the cell
layouts, and the F=2 cell encoding: forward (B10), its backward (B11, B12)
and nablas (B13).

Port of nr3d_lib_tpu/ops/permuto_cell.py (and of `_simplex_parts` in
nr3d_lib_tpu/ops/permuto.py, kept here as a private helper: the port
imports nothing of the JAX package). A point's simplex in the
permutohedral lattice is found by elevating it onto the sum-zero
hyperplane, rounding to the nearest remainder-0 point and ranking the
differential. The cell layout hashes that remainder-0 base point (the
cell) to a table row and gives each of the cell's 2^(d+1) vertex slots its
own lanes in the row, so one row holds every vertex of whichever simplex
of the cell a point falls in. Coarse levels whose reachable cells fit the
row budget index a box bijectively instead (dense levels).

The plain versions are written once for F features per vertex: the F=2
layout here (an f32 [rows, 128] table, vertex k's features at lanes
lane_k, lane_k + 1), and the F=4 bf16-packed layout of
`ops/permuto_cell4.py`, which reads the same rows as quads of an unpacked
[rows, 256] table after quantizing it. In both, vertex k is slot
row · 64 + lane_k / 2 of the table viewed as [rows · 64, F].

The CUDA kernels (`csrc/permuto_cell.cu`, `csrc/permuto_cell4.cu`, their
simplex search shared in `csrc/permuto_simplex.cuh`) repeat this
arithmetic operation by operation, so a point picks the same simplex and
row on both routes:
  * the elevation sums the scaled coordinates from the last one, and
    `tail − i·cf[i−1]` is two separately rounded operations (no FMA);
  * the hyperplane constants `sf` are float32 values computed on the host
    (`hyperplane_scales`), the way the JAX package computes them;
  * a rounding tie goes down (`up − e < e − down` is strict);
  * rank ties break by index; negative coordinates enter the hash as
    int32 → uint32 (two's complement).

Routes: `permuto_cell_encode`, `permuto_cell_encode_frozen_x` and
`permuto_cell_nablas` take the plain PyTorch version (and torch autograd)
for a CPU tensor, and the CUDA kernels for a CUDA tensor. On CUDA,
`_PermutoEncode` runs B10 forward and, as its backward, `permuto_bwd`:
dL/dtable alone (B11) or with dL/dx when x needs it (B12);
`_PermutoNablas` runs B13 forward and, as its backward, the plain
PyTorch vjp of the plain nablas (gathers and `index_add_`): the JAX
package computes that second order in XLA, not in a Pallas kernel. The
barycentric weights are affine in x inside a simplex, so the nablas'
derivative in x is zero.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops.lotd_brick import (HASH_PRIMES, _vjp, aligned,
                                               ptr, wants_grad)

__all__ = ["PermutoCellLevel", "PermutoCellMeta", "make_permuto_cell_meta",
           "hyperplane_scales", "f32_scalars", "c_meta", "fastmod_constants",
           "atomic_groups", "LANES", "N_FEAT",
           "permuto_cell_encode", "permuto_cell_encode_frozen_x",
           "permuto_cell_nablas", "permuto_cell_encode_xla",
           "permuto_cell_encode_bwd_xla", "permuto_cell_nablas_xla",
           "permuto_cell_nablas_bwd_xla"]

LANES = 128
N_FEAT = 2            # features per vertex slot of the F=2 lane layout
_U32 = 0xFFFFFFFF
MAX_DIMS = 5          # the kernels' meta holds up to 5 input dimensions
MAX_LEVELS = 16       # and up to 16 levels


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

    @cached_property
    def out_features(self) -> int:                 # of the F=2 encode
        return N_FEAT * self.n_levels


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


# ------------------------------------- plain versions, F features per vertex
def _level_vertices(x: torch.Tensor, level: PermutoCellLevel,
                    meta: PermutoCellMeta):
    """(vertex slot [N, d+1] into the table viewed as [rows·64, F], bary
    [N, d+1], rank [N, d+1]) of one level."""
    row, lane, bary, rank = _level_rows_lanes_bary(x, level, meta)
    return row[:, None] * (LANES // N_FEAT) + lane // N_FEAT, bary, rank


def atomic_groups(x: torch.Tensor, meta: PermutoCellMeta,
                  warp: int = 32) -> List[int]:
    """Per level, the table-gradient atomics that the cell backward kernels
    issue at the points x [N, d] in their order, where a warp takes `warp`
    consecutive points at one level and its lanes that add to one slot sum
    first (one atomic per distinct (warp, slot) pair; one lane alone issues
    N·(d+1)). Vertex k's slot has k bits set, so lanes meet only at the
    same k."""
    n_slots = meta.total_rows * (LANES // N_FEAT)
    with torch.no_grad():
        wid = torch.arange(x.shape[0], device=x.device) // warp
        return [int(torch.unique(wid[:, None] * n_slots + _level_vertices(
            x, level, meta)[0]).numel()) for level in meta.levels]


def _gather_vertices(table: torch.Tensor, vtx: torch.Tensor,
                     n_feat: int) -> torch.Tensor:
    """table [rows, 64·F], vtx [N, K] → vertex features [N, K, F]: an
    `index_select` of single elements from the flat table, whose backward
    is `index_add_`. (A select of 8- or 16-byte rows runs PyTorch's
    vectorized row gather, which took 1.2 ms for 2 M rows of 16 bytes on
    the H100.)"""
    idx = vtx[..., None] * n_feat + torch.arange(n_feat, device=vtx.device)
    return table.reshape(-1).index_select(0, idx.reshape(-1)).reshape(
        idx.shape)


def _elevation_vjp(delev: torch.Tensor, level: PermutoCellLevel,
                   d: int) -> torch.Tensor:
    """dL/delevated [N, d+1] → dL/dx [N, d] through the elevation Jacobian
    M_ia = [a ≥ i] − i·[a = i−1], the hyperplane factors sf_a and the
    level's scale_a: dL/dcf_a = Σ_{i≤a} delev_i − (a+1)·delev_{a+1}. The
    running sum is written out: a CUDA `cumsum` over an innermost axis of
    d ≤ 5 took 2.3 ms at 393,216 rows on the H100."""
    sf, scale = f32_scalars(hyperplane_scales(d)), f32_scalars(level.scale)
    run, cols = delev[:, 0], []
    for a in range(d):
        if a:
            run = run + delev[:, a]
        cols.append((run - (a + 1) * delev[:, a + 1]) * sf[a] * scale[a])
    return torch.stack(cols, -1)


def encode_plain(x: torch.Tensor, table: torch.Tensor,
                 meta: PermutoCellMeta, n_feat: int) -> torch.Tensor:
    """x [N, d] in the lattice's [0,1] space, table [rows, 64·F] → [N, F·L],
    column l·F + f: the barycentric blend of the simplex's d+1 vertices.
    Differentiable in x (through the weights) and table."""
    outs = []
    for level in meta.levels:
        vtx, bary, _ = _level_vertices(x, level, meta)
        vals = _gather_vertices(table, vtx, n_feat)            # [N, d+1, F]
        outs.append(torch.sum(bary[..., None].to(vals.dtype) * vals, 1))
    return torch.cat(outs, -1)


def nablas_plain(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                 meta: PermutoCellMeta, n_feat: int) -> torch.Tensor:
    """J_enc(x)ᵀ·g_up [N, d], written out. With gf_k = Σ_f g_up[l·F + f]·
    val_k,f, dL/dvdiff_i = gf[d−rank_i] − gf[(d+1−rank_i) mod (d+1)],
    divided by d+1 for dL/delevated, then `_elevation_vjp`.
    Differentiable in g_up and table (gathers, whose backward is
    `index_add_`); x enters only through the simplex choice, so it gets no
    gradient (the true one is zero)."""
    d = meta.n_dims
    dp1 = d + 1
    dx = None
    for l, level in enumerate(meta.levels):
        vtx, _, rank = _level_vertices(x.detach(), level, meta)
        vals = _gather_vertices(table, vtx, n_feat)            # [N, d+1, F]
        gf = torch.sum(vals * g_up[:, None, n_feat * l:n_feat * (l + 1)], -1)
        dv = gf.gather(1, d - rank) - gf.gather(1, (dp1 - rank) % dp1)
        term = _elevation_vjp(dv / dp1, level, d)
        dx = term if dx is None else dx + term
    return dx


def permuto_cell_encode_xla(x: torch.Tensor, table: torch.Tensor,
                            meta: PermutoCellMeta) -> torch.Tensor:
    """Plain PyTorch version of B10 (CPU route; the card's reference).
    x [N, d] in the lattice's [0,1] space, table [rows, 128] → [N, 2L],
    column 2l + f; differentiable in x and table."""
    return encode_plain(x, table, meta, N_FEAT)


def permuto_cell_nablas_xla(g_up: torch.Tensor, x: torch.Tensor,
                            table: torch.Tensor, meta: PermutoCellMeta
                            ) -> torch.Tensor:
    """Plain PyTorch version of B13: J_enc(x)ᵀ·g_up [N, d]."""
    return nablas_plain(g_up, x, table, meta, N_FEAT)


def permuto_cell_encode_bwd_xla(x: torch.Tensor, table: torch.Tensor,
                                g: torch.Tensor, meta: PermutoCellMeta,
                                need_dx: bool = True):
    """Plain PyTorch version of B11 (need_dx False) and B12: the vjp of
    `permuto_cell_encode_xla` → (dL/dx [N, d] or None, dL/dtable
    [rows, 128])."""
    return _vjp(lambda xx, tt: permuto_cell_encode_xla(xx, tt, meta),
                (x, table), (need_dx, True), g)


def permuto_cell_nablas_bwd_xla(g_up: torch.Tensor, x: torch.Tensor,
                                table: torch.Tensor, gg: torch.Tensor,
                                meta: PermutoCellMeta):
    """The vjp of `permuto_cell_nablas_xla` → (dL/dg_up [N, 2L], dL/dx
    [N, d] (zeros), dL/dtable [rows, 128]): the nablas' backward on both
    routes."""
    return _vjp(lambda a, b, c: permuto_cell_nablas_xla(a, b, c, meta),
                (g_up, x, table), (True, True, True), gg)


# ------------------------------------------------------------ CUDA route
class _Level(ctypes.Structure):
    _fields_ = [("scale", ctypes.c_float * MAX_DIMS),
                ("box_lo", ctypes.c_int * MAX_DIMS),
                ("box_dims", ctypes.c_int * MAX_DIMS),
                ("n_rows", ctypes.c_int), ("row_offset", ctypes.c_int),
                ("is_dense", ctypes.c_int),
                ("hash_mod", ctypes.c_uint32), ("mod_magic", ctypes.c_uint32),
                ("mod_sh1", ctypes.c_int), ("mod_sh2", ctypes.c_int)]


class _Meta(ctypes.Structure):
    """`PCMeta` of `csrc/permuto_simplex.cuh`."""
    _fields_ = [("n_dims", ctypes.c_int), ("n_levels", ctypes.c_int),
                ("cells_per_row", ctypes.c_int),
                ("sf", ctypes.c_float * MAX_DIMS),
                ("lv", _Level * MAX_LEVELS)]


def fastmod_constants(m: int) -> Tuple[int, int, int]:
    """(magic, sh1, sh2) with which the kernels' `pc_mod` computes h % m
    for every 32-bit h (Granlund and Montgomery's unsigned division by a
    multiply-high): l = ⌈log2 m⌉, magic = ⌊2^32 (2^l − m) / m⌋ + 1 < 2^32,
    t = ⌊h·magic / 2^32⌋, ⌊h / m⌋ = (t + ((h − t) >> sh1)) >> sh2 with
    sh1 = min(l, 1), sh2 = max(l − 1, 0)."""
    if not 1 <= m < 1 << 32:
        raise ValueError(f"a modulus must be in [1, 2^32), got {m}")
    l = (m - 1).bit_length()
    return ((1 << 32) * ((1 << l) - m)) // m + 1, min(l, 1), max(l - 1, 0)


def c_meta(meta: PermutoCellMeta) -> _Meta:
    """A PermutoCellMeta as the kernels' by-value meta argument. Refuses
    what the kernels cannot take: more levels or dimensions than the meta
    holds, a cells_per_row other than 2^(5−d) (a constant of the kernels'
    dimension) and a table whose vertex slots (rows · 64) overflow int32."""
    if meta.n_levels > MAX_LEVELS or meta.n_dims > MAX_DIMS:
        raise ValueError(f"the permuto kernels take at most {MAX_LEVELS} "
                         f"levels of at most {MAX_DIMS} dimensions, got "
                         f"{meta.n_levels} of {meta.n_dims}")
    if meta.cells_per_row != 1 << (5 - meta.n_dims):
        raise ValueError(f"the permuto kernels take 2^(5-d) = "
                         f"{1 << (5 - meta.n_dims)} cells per row at d = "
                         f"{meta.n_dims}, got {meta.cells_per_row}")
    if meta.total_rows * (LANES // N_FEAT) >= 1 << 31:
        raise ValueError(f"the permuto kernels index vertex slots in int32: "
                         f"{meta.total_rows} rows × 64 slots is too many")
    m = _Meta()
    m.n_dims, m.n_levels = meta.n_dims, meta.n_levels
    m.cells_per_row = meta.cells_per_row
    m.sf[:meta.n_dims] = [float(v) for v in hyperplane_scales(meta.n_dims)]
    for i, lv in enumerate(meta.levels):
        m.lv[i].scale[:meta.n_dims] = list(lv.scale)
        if lv.box_dims is not None:
            m.lv[i].box_lo[:meta.n_dims] = list(lv.box_lo)
            m.lv[i].box_dims[:meta.n_dims] = list(lv.box_dims)
        m.lv[i].n_rows = lv.n_rows
        m.lv[i].row_offset = lv.row_offset
        m.lv[i].is_dense = int(lv.box_dims is not None)
        mod = lv.n_rows * meta.cells_per_row
        m.lv[i].hash_mod = mod
        m.lv[i].mod_magic, m.lv[i].mod_sh1, m.lv[i].mod_sh2 = \
            fastmod_constants(mod)
    return m


def check_cuda_args(x: torch.Tensor, table: torch.Tensor,
                    meta: PermutoCellMeta, n_feat: int, what: str,
                    g_up: Optional[torch.Tensor] = None) -> None:
    """Shapes, types and devices the F-feature kernels take (a [rows,
    64·F] f32 table); raises otherwise."""
    width = LANES // N_FEAT * n_feat
    if x.dim() != 2 or x.shape[1] != meta.n_dims or \
            x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be [N,{meta.n_dims}] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if table.shape != (meta.total_rows, width) or \
            table.dtype != torch.float32:
        raise ValueError(f"{what}: table must be [{meta.total_rows}, "
                         f"{width}] float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if g_up is not None and (g_up.shape != (x.shape[0], n_feat *
                                            meta.n_levels) or
                             g_up.dtype != torch.float32):
        raise ValueError(f"{what}: g_up must be [N, {n_feat * meta.n_levels}"
                         f"] float32, got {tuple(g_up.shape)} {g_up.dtype}")
    for t in (table,) if g_up is None else (table, g_up):
        if t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on {x.device}")


def _lib():
    vp, n = _build.VP, ctypes.c_longlong
    return _build.load("permuto_cell", {
        "permuto_fwd": [vp, vp, _Meta, vp, n, vp],
        "permuto_bwd": [vp, vp, vp, _Meta, vp, vp, n, vp],
        "permuto_dydx": [vp, vp, vp, _Meta, vp, n, vp]})


def _fwd_cuda(x: torch.Tensor, table: torch.Tensor,
              meta: PermutoCellMeta) -> torch.Tensor:
    """B10 → y [N, 2L]."""
    x, table = aligned(x), aligned(table)
    y = torch.empty((x.shape[0], meta.out_features), device=x.device,
                    dtype=torch.float32)
    err = _lib().permuto_fwd(x.data_ptr(), table.data_ptr(), c_meta(meta),
                             y.data_ptr(), x.shape[0],
                             _build.stream_ptr(x.device))
    _build.check(err, "permuto_fwd")
    _build.LAUNCHES["permuto_fwd"] += 1
    return y


def _bwd_cuda(x: torch.Tensor, g: torch.Tensor, meta: PermutoCellMeta, *,
              need_dx: bool, table: Optional[torch.Tensor] = None):
    """B11 (need_dx False) or B12 → (dL/dx [N, d] or None, dL/dtable
    [rows, 128]); dL/dx reads the vertex values from the table."""
    if need_dx and table is None:
        raise ValueError("permuto_bwd: dL/dx needs the table")
    x, g = aligned(x), aligned(g)
    table = aligned(table) if need_dx else None
    dtab = torch.empty((meta.total_rows, LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().permuto_bwd(x.data_ptr(), g.data_ptr(), ptr(table),
                             c_meta(meta), dtab.data_ptr(), ptr(dx),
                             x.shape[0], _build.stream_ptr(x.device))
    _build.check(err, "permuto_bwd")
    _build.LAUNCHES["permuto_bwd"] += 1
    return dx, dtab


def _dydx_cuda(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
               meta: PermutoCellMeta) -> torch.Tensor:
    """B13 → J_enc(x)ᵀ·g_up [N, d]."""
    g_up, x, table = aligned(g_up), aligned(x), aligned(table)
    dx = torch.empty_like(x)
    err = _lib().permuto_dydx(g_up.data_ptr(), x.data_ptr(),
                              table.data_ptr(), c_meta(meta), dx.data_ptr(),
                              x.shape[0], _build.stream_ptr(x.device))
    _build.check(err, "permuto_dydx")
    _build.LAUNCHES["permuto_dydx"] += 1
    return dx


class _PermutoEncode(torch.autograd.Function):
    """B10 forward; B11 backward, or B12 when x needs its gradient."""

    @staticmethod
    def forward(ctx, x, table, meta):
        ctx.meta = meta
        ctx.save_for_backward(x, table)
        return _fwd_cuda(x, table, meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dx, dtab = _bwd_cuda(x, g, ctx.meta, need_dx=need_dx,
                             table=table if need_dx else None)
        return dx, (dtab if ctx.needs_input_grad[1] else None), None


class _PermutoNablas(torch.autograd.Function):
    """B13 forward; the backward is the plain vjp of the plain nablas."""

    @staticmethod
    def forward(ctx, g_up, x, table, meta):
        ctx.meta = meta
        ctx.save_for_backward(g_up, x, table)
        return _dydx_cuda(g_up, x, table, meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        g_up, x, table = ctx.saved_tensors
        dgup, dx, dtab = permuto_cell_nablas_bwd_xla(g_up, x, table, gg,
                                                     ctx.meta)
        need = ctx.needs_input_grad
        return (dgup if need[0] else None, dx if need[1] else None,
                dtab if need[2] else None, None)


# ----------------------------------------------------------- the wrappers
def permuto_cell_encode(x: torch.Tensor, table: torch.Tensor,
                        meta: PermutoCellMeta) -> torch.Tensor:
    """F=2 cell permuto encode (B10): [N, d] × [rows, 128] → [N, 2L]. CPU
    tensor → plain version; CUDA tensor → the `permuto_fwd` kernel, with
    `permuto_bwd` (B11, or B12 when x needs its gradient) as its
    backward."""
    if x.device.type == "cpu":
        return permuto_cell_encode_xla(x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"permuto_cell_encode: unsupported device "
                         f"{x.device}")
    check_cuda_args(x, table, meta, N_FEAT, "permuto_cell_encode")
    if wants_grad(x, table):
        return _PermutoEncode.apply(x, table, meta)
    return _fwd_cuda(x, table, meta)


def permuto_cell_encode_frozen_x(x: torch.Tensor, table: torch.Tensor,
                                 meta: PermutoCellMeta) -> torch.Tensor:
    """`permuto_cell_encode` with x taken as a constant: the backward (B11)
    computes dL/dtable only."""
    return permuto_cell_encode(x.detach(), table, meta)


def permuto_cell_nablas(g_up: torch.Tensor, x: torch.Tensor,
                        table: torch.Tensor, meta: PermutoCellMeta
                        ) -> torch.Tensor:
    """nablas J_enc(x)ᵀ·g_up (B13): g_up [N, 2L], x [N, d] → [N, d]. CPU
    tensor → plain version; CUDA tensor → the `permuto_dydx` kernel, with
    the plain vjp as its backward when a gradient is needed."""
    if x.device.type == "cpu":
        return permuto_cell_nablas_xla(g_up, x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"permuto_cell_nablas: unsupported device "
                         f"{x.device}")
    check_cuda_args(x, table, meta, N_FEAT, "permuto_cell_nablas", g_up)
    if wants_grad(g_up, x, table):
        return _PermutoNablas.apply(g_up, x, table, meta)
    return _dydx_cuda(g_up, x, table, meta)
