"""Brick-layout LoTD encoding, F=2: geometry, plain versions and kernels.

Port of nr3d_lib_tpu/ops/lotd_brick.py: a 4×4×4-vertex brick is packed
into one 128-lane row (lane = vertex·2 + f), so one row fetch per (point,
level) holds all eight interpolation corners. Bricks cover 3×3×3 cells and
overlap by one vertex plane. Dense levels lay bricks out in C order; hash
levels hash the brick coordinates with the NGP XOR-primes. The geometry
here is shared with the F=4 packed path (`ops/lotd_brick4.py`).

The brick hash multiplies and XORs in uint32. PyTorch has no full uint32
multiply, so it runs in int64 with `& 0xFFFFFFFF` after each product (the
CUDA kernels use native `uint32_t`).

Kernels (`csrc/brick.cu`): the encode (B6), its backward (B7), the nablas
(B8) and the nablas' backward (B9). `brick_encode`,
`brick_encode_frozen_x` and `brick_nablas` take the plain PyTorch version
(and torch autograd) for a CPU tensor, and the kernels for a CUDA tensor.
On CUDA a gradient goes through two `torch.autograd.Function`s whose
backwards are kernels too: `_BrickEncode` (B6 forward, B7 backward; when x
requires grad, B6 saves the corner values that B7 reads for dL/dx) and
`_BrickNablas` (B8 forward, B9 backward). Neither backward is itself
differentiable. The plain backwards `brick_encode_bwd_xla` and
`brick_nablas_bwd_xla` are for tests and for holding the kernels against.

The forest (per-block tables, `brick_encode_batched` and
`brick_nablas_batched`) runs the same four kernels with a block row
offset `bidx` (launches counted as `brick_fwd_b`, `brick_bwd_b`,
`brick_dydx_b` and `brick_bwd2_b`) through `_BrickEncodeBatched` and
`_BrickNablasBatched`; their plain versions are
`brick_encode_xla_batched`, `brick_encode_bwd_xla_batched`,
`brick_nablas_xla_batched` and `brick_nablas_bwd_xla_batched`. On the
CPU both take plain autograd, to second order.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nr3d_lib_tpu_torch.ops import _build

__all__ = ["BrickLevel", "BrickMeta", "make_brick_meta",
           "vertex_grid_to_brick_rows", "materialize_dense_brick_table",
           "brick_encode", "brick_encode_frozen_x", "brick_nablas",
           "brick_encode_ho", "brick_bwd_dydx", "brick_encode_xla", "brick_corner_values_xla",
           "brick_encode_bwd_xla", "brick_nablas_xla", "brick_nablas_bwd_xla",
           "brick_atomic_groups", "make_forest_meta",
           "brick_encode_xla_batched", "brick_nablas_xla_batched",
           "brick_encode_bwd_xla_batched", "brick_nablas_bwd_xla_batched",
           "brick_encode_batched", "brick_nablas_batched",
           "HASH_PRIMES", "BRICK_W", "LANES", "MAX_LEVELS"]

# nr3d_lib_tpu/ops/lotd.py HASH_PRIMES (copied: the port imports nothing of
# the JAX package)
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
               2165219737)
_U32 = 0xFFFFFFFF

BRICK_W = 4           # vertices per axis in a brick
BRICK_CELLS = 3       # cells per axis covered (stride)
LANES = 128
N_FEAT = 2            # features per vertex of the F=2 lane layout
MAX_LEVELS = 8        # levels the F=2 kernels take (16 lanes each on a TPU)


@dataclass(frozen=True)
class BrickLevel:
    res: Tuple[int, int, int]        # vertex resolution per axis
    kind: str                        # 'dense' | 'hash'
    n_rows: int                      # brick rows in the table
    bricks_per_axis: Tuple[int, int, int]
    row_offset: int                  # into the concatenated table


@dataclass(frozen=True)
class BrickMeta:
    levels: Tuple[BrickLevel, ...]

    @cached_property
    def total_rows(self) -> int:
        return sum(l.n_rows for l in self.levels)

    @cached_property
    def n_params(self) -> int:
        return self.total_rows * LANES

    @cached_property
    def n_levels(self) -> int:
        return len(self.levels)

    @cached_property
    def out_features(self) -> int:
        return N_FEAT * len(self.levels)


def _bricks_per_axis(res: Sequence[int]) -> Tuple[int, ...]:
    # cells 0..res-2 → brick index cell//3 ∈ [0, ceil((res-1)/3))
    return tuple(int(math.ceil((r - 1) / BRICK_CELLS)) for r in res)


def make_brick_meta(lod_res: Sequence, lod_types: Sequence[str],
                    hashmap_rows: int = 4096) -> BrickMeta:
    """hashmap_rows: rows per hash level (capacity = rows·64 vertices)."""
    levels: List[BrickLevel] = []
    offset = 0
    for res, t in zip(lod_res, lod_types):
        if np.isscalar(res):
            res = (int(res),) * 3
        res = tuple(int(v) for v in res)
        bpa = _bricks_per_axis(res)
        t = t.lower()
        if t == "dense":
            n_rows = int(np.prod(bpa))
        elif t == "hash":
            n_rows = min(int(hashmap_rows), int(np.prod(bpa)))
            if n_rows == int(np.prod(bpa)):
                t = "dense"  # small enough: collision-free
        else:
            raise ValueError(f"brick backend supports Dense/Hash, got {t}")
        levels.append(BrickLevel(res, t, n_rows, bpa, offset))
        offset += n_rows
    return BrickMeta(tuple(levels))


def _level_rows_and_lanes(x: torch.Tensor, level: BrickLevel):
    """Per-point brick row index, base corner lane, and fractional coords.

    x: [N, 3] in [0,1] (reference kernel convention, scale = res-2).
    Returns (row [N] int64, lane0 [N] int64, frac [N,3]). The scale is
    applied as two separately rounded float32 operations (no FMA), as the
    CUDA kernels do."""
    brick, local, frac = [], [], []
    for a in range(3):
        v = x[:, a] * float(level.res[a] - 2) + 0.5
        cell = torch.floor(v)
        frac.append(v - cell.detach())
        cell = cell.to(torch.int64).clamp(0, level.res[a] - 2)
        b = cell // BRICK_CELLS
        local.append(cell - b * BRICK_CELLS)      # ∈ [0, 2]
        brick.append(b.clamp(max=level.bricks_per_axis[a] - 1))
    b0, b1, b2 = brick
    bpa = level.bricks_per_axis
    if level.kind == "dense":
        row = (b0 * bpa[1] + b1) * bpa[2] + b2
    else:
        h = (b0 * HASH_PRIMES[0]) & _U32
        h = h ^ ((b1 * HASH_PRIMES[1]) & _U32)
        h = h ^ ((b2 * HASH_PRIMES[2]) & _U32)
        row = h % level.n_rows
    l0, l1, l2 = local
    lane0 = ((l0 * BRICK_W + l1) * BRICK_W + l2) * N_FEAT
    return row + level.row_offset, lane0, torch.stack(frac, -1)


def _corner_bits(device) -> torch.Tensor:
    """[8,3] int64 bits (dx,dy,dz) of each corner, in the kernels' order."""
    k = torch.arange(8, device=device)
    return torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], -1)


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """[N,3] → [N,8] trilinear weights."""
    cb = _corner_bits(frac.device).to(frac.dtype)
    w = frac[..., None, :] * cb + (1.0 - frac[..., None, :]) * (1.0 - cb)
    return torch.prod(w, dim=-1)


def vertex_grid_to_brick_rows(level: BrickLevel) -> np.ndarray:
    """For a dense level: flat vertex index for every (row, lane) slot →
    [n_rows, 128] int32 (clamped at borders). Used to materialize the brick
    table from canonical vertex parameters so boundary vertices stay tied."""
    bx, by, bz = level.bricks_per_axis
    rx, ry, rz = level.res
    bxs, bys, bzs = np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                                indexing="ij")
    base = np.stack([bxs, bys, bzs], -1).reshape(-1, 1, 3) * BRICK_CELLS
    lx, ly, lz = np.meshgrid(np.arange(BRICK_W), np.arange(BRICK_W),
                             np.arange(BRICK_W), indexing="ij")
    local = np.stack([lx, ly, lz], -1).reshape(1, -1, 3)
    v = base + local                                                  # [R,64,3]
    v = np.minimum(v, np.asarray([rx - 1, ry - 1, rz - 1]))
    flat = (v[..., 0] * ry + v[..., 1]) * rz + v[..., 2]              # [R,64]
    lanes = np.zeros((flat.shape[0], LANES), np.int32)
    lanes[:, 0::2] = flat * N_FEAT
    lanes[:, 1::2] = flat * N_FEAT + 1
    return lanes


def materialize_dense_brick_table(vertex_params: torch.Tensor,
                                  level: BrickLevel) -> torch.Tensor:
    """Canonical vertex params [res³·2] → brick rows [n_rows, 128].
    Differentiable: gradients accumulate onto shared boundary vertices, so
    the encoding stays C0 like the reference Dense type. (The encoding
    module keeps this index on the device and gathers with it directly.)"""
    index = torch.as_tensor(vertex_grid_to_brick_rows(level),
                            device=vertex_params.device).long()
    return vertex_params[index]


# ---------------------------------------------------------- plain versions
def _level_corners(x: torch.Tensor, t_flat: torch.Tensor, level,
                   n_feat: int, row_add: Optional[torch.Tensor] = None):
    """Corner values [N,8,n_feat] and fractional coords [N,3] of one level
    of a table whose rows hold 64 vertices × n_feat values (`t_flat` is
    the table flattened); `row_add` [N] shifts each point's row (the
    forest's block offset)."""
    row, lane0, frac = _level_rows_and_lanes(x, level)
    if row_add is not None:
        row = row + row_add
    bits = _corner_bits(x.device)
    corner_v = (bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W + bits[:, 2]
    vert = row[:, None] * 64 + lane0[:, None] // N_FEAT + corner_v  # [N,8]
    idx = vert[..., None] * n_feat + torch.arange(n_feat, device=x.device)
    return t_flat[idx], frac


def brick_atomic_groups(x: torch.Tensor, meta: BrickMeta,
                        bidx: Optional[torch.Tensor] = None,
                        warp: int = 32) -> List[int]:
    """Per level, the table-gradient atomics that B7 (`brick_bwd`) and B9
    (`brick_bwd2`) each issue at the points x [N, 3] in their order, and
    at an F=4 meta (`lotd_brick4.make_brick4_meta`, the same geometry)
    B2 (`brick4_bwd`) and B4 (`brick4_bwd2`), float4 atomics there: a
    warp takes `warp` consecutive points at one level, and corner by
    corner its lanes that add to one slot (row·64 + vertex, in both
    layouts) sum first, so one atomic per distinct (warp, corner, slot);
    one lane alone issues N·8 a level. With `bidx` [N] the forest forms:
    the slot is global, in the point's block max(bidx, 0)."""
    bits = _corner_bits(x.device)
    corner_v = (bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W + bits[:, 2]
    with torch.no_grad():
        wid = torch.arange(x.shape[0], device=x.device)[:, None] // warp
        group = (wid * 8 + torch.arange(8, device=x.device)).reshape(-1)
        add = None if bidx is None else _block_rows(bidx, meta)
        out = []
        for level in meta.levels:
            row, lane0, _ = _level_rows_and_lanes(x, level)
            if add is not None:
                row = row + add
            slot = (row[:, None] * 64 + lane0[:, None] // N_FEAT +
                    corner_v).reshape(-1)
            n_slots = int(slot.max()) + 1 if slot.numel() else 1
            out.append(int(torch.unique(group * n_slots + slot).numel()))
        return out


def _encode_plain(x: torch.Tensor, t_flat: torch.Tensor, meta: BrickMeta,
                  n_feat: int, row_add: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Σ_corners w·value per level → [N, n_feat·L], column l·n_feat + f."""
    outs = []
    for level in meta.levels:
        vals, frac = _level_corners(x, t_flat, level, n_feat, row_add)
        w = _corner_weights(frac).to(vals.dtype)                     # [N,8]
        outs.append(torch.sum(w[..., None] * vals, 1))
    return torch.cat(outs, -1)


def _nablas_plain(g_up: torch.Tensor, x: torch.Tensor, t_flat: torch.Tensor,
                  meta: BrickMeta, n_feat: int,
                  row_add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """J_enc(x)ᵀ·g_up [N,3], written out analytically (the JAX reference
    takes the vjp of the plain encode):
    dx_a = Σ_l (res_a−2) Σ_corners (g_up·val)·(2·bit_a−1)·Π_{b≠a} s_b."""
    cb = _corner_bits(x.device).to(x.dtype)                          # [8,3]
    sign = 2.0 * cb - 1.0
    dx = [0.0, 0.0, 0.0]
    for l, level in enumerate(meta.levels):
        vals, frac = _level_corners(x, t_flat, level, n_feat, row_add)
        h = torch.sum(vals * g_up[:, None, n_feat * l:n_feat * (l + 1)], -1)
        s = frac[:, None, :] * cb + (1.0 - frac[:, None, :]) * (1.0 - cb)
        for a in range(3):
            b, c = [i for i in range(3) if i != a]
            da = torch.sum(h * sign[:, a] * s[..., b] * s[..., c], -1)
            dx[a] = dx[a] + da * float(level.res[a] - 2)
    return torch.stack(dx, -1)


def brick_encode_xla(x: torch.Tensor, table: torch.Tensor,
                     meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B6 (CPU route; the card's reference).
    x [N,3] in [0,1]; table [rows, 128]. Returns [N, 2L], column l·2+f;
    differentiable in x and table."""
    return _encode_plain(x, table.reshape(-1), meta, N_FEAT)


def brick_corner_values_xla(x: torch.Tensor, table: torch.Tensor,
                            meta: BrickMeta) -> torch.Tensor:
    """Plain version of B6's want_g output: the 8 corners' 2 features of
    each (point, level) → [N, L, 8, 2] f32 (a copy)."""
    t_flat = table.reshape(-1)
    return torch.stack([_level_corners(x, t_flat, lv, N_FEAT)[0]
                        for lv in meta.levels], 1)


def brick_nablas_xla(g_up: torch.Tensor, x: torch.Tensor,
                     table: torch.Tensor, meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B8: J_enc(x)ᵀ·g_up [N,3]."""
    return _nablas_plain(g_up, x, table.reshape(-1), meta, N_FEAT)


def _vjp(fn, inputs, need, cot):
    """The vjp of fn at detached copies of `inputs`, for those flagged in
    `need` (None for the others; zeros for a flagged input that fn does
    not differentiate)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
        wrt = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(fn(*ins), wrt, cot,
                                         allow_unused=True))
        out = []
        for t, n in zip(ins, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(t) if n and g is None else g)
        return tuple(out)


def brick_encode_bwd_xla(x: torch.Tensor, table: torch.Tensor,
                         g: torch.Tensor, meta: BrickMeta,
                         need_dx: bool = True):
    """Plain PyTorch version of B7: the vjp of `brick_encode_xla` →
    (dL/dx [N,3] or None, dL/dtable [rows,128])."""
    return _vjp(lambda xx, tt: brick_encode_xla(xx, tt, meta), (x, table),
                (need_dx, True), g)


def brick_nablas_bwd_xla(g_up: torch.Tensor, x: torch.Tensor,
                         table: torch.Tensor, gg: torch.Tensor,
                         meta: BrickMeta):
    """Plain PyTorch version of B9: the vjp of `brick_nablas_xla` →
    (dL/dg_up [N,2L], dL/dx [N,3], dL/dtable [rows,128])."""
    return _vjp(lambda a, b, c: brick_nablas_xla(a, b, c, meta),
                (g_up, x, table), (True, True, True), gg)


# ------------------------------------------------------ CUDA route (shared)
class _Level(ctypes.Structure):
    _fields_ = [("res", ctypes.c_int * 3), ("bpa", ctypes.c_int * 3),
                ("n_rows", ctypes.c_int), ("row_offset", ctypes.c_int),
                ("is_hash", ctypes.c_int)]


def meta_struct(max_levels: int) -> type:
    """The ctypes mirror of a kernel source's meta struct
    (`{int n_levels; Level lv[max_levels];}`)."""
    return type(f"_Meta{max_levels}", (ctypes.Structure,), {
        "_fields_": [("n_levels", ctypes.c_int),
                     ("lv", _Level * max_levels)]})


_Meta = meta_struct(MAX_LEVELS)


def c_meta(meta: BrickMeta, struct: type = _Meta):
    """A BrickMeta as the kernels' by-value meta argument. Refuses a meta
    with no level, as the JAX reference and the plain versions do (they
    have nothing to stack), and more levels or rows than the kernels
    take."""
    cap = struct._fields_[1][1]._length_
    if meta.n_levels == 0:
        raise ValueError("the brick kernels take at least one level, got a "
                         "meta with none")
    if meta.n_levels > cap:
        raise ValueError(f"the brick kernels take at most {cap} levels, got "
                         f"{meta.n_levels}")
    if meta.total_rows >= 1 << 25:
        raise ValueError(f"the brick kernels index slots in int32: at most "
                         f"2^25 - 1 rows, got {meta.total_rows}")
    m = struct()
    m.n_levels = meta.n_levels
    for i, lv in enumerate(meta.levels):
        m.lv[i].res[:] = list(lv.res)
        m.lv[i].bpa[:] = list(lv.bricks_per_axis)
        m.lv[i].n_rows = lv.n_rows
        m.lv[i].row_offset = lv.row_offset
        m.lv[i].is_hash = int(lv.kind == "hash")
    return m


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def check_cuda_args(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta,
                    width: int, what: str, *extra: torch.Tensor) -> None:
    """Shapes, types and devices a brick kernel takes; raises otherwise."""
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be [N,3] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if table.shape != (meta.total_rows, width) or \
            table.dtype != torch.float32:
        raise ValueError(f"{what}: table must be [{meta.total_rows}, {width}]"
                         f" float32, got {tuple(table.shape)} {table.dtype}")
    for t in (table, *extra):
        if t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on {x.device}")


# ------------------------------------------------------- CUDA route (F=2)
def _lib():
    vp, n = _build.VP, ctypes.c_longlong
    return _build.load("brick", {
        "brick_fwd": [vp, vp, vp, _Meta, vp, vp, n, vp],
        "brick_bwd": [vp, vp, vp, vp, vp, n, _Meta, vp, vp, n, vp],
        "brick_dydx": [vp, vp, vp, vp, _Meta, vp, n, vp],
        "brick_bwd2": [vp, vp, vp, vp, vp, n, _Meta, vp, vp, vp, n, vp]})


def _fwd_cuda(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta,
              want_g: bool = False, bidx: Optional[torch.Tensor] = None):
    """B6 → y [N,2L]; with `want_g` → (y, corners [N,L,8,2]), the corner
    values that B7 reads back for dL/dx; with `bidx` [N] int32 the forest
    form over a [B·total_rows, 128] table (no want_g). Counted as
    `brick_fwd`, `brick_fwd_g` or `brick_fwd_b`."""
    x, table = aligned(x), aligned(table)
    bidx = None if bidx is None else bidx.contiguous()
    n, L = x.shape[0], meta.n_levels
    y = torch.empty((n, N_FEAT * L), device=x.device, dtype=torch.float32)
    corners = torch.empty((n, L, 8, N_FEAT), device=x.device,
                          dtype=torch.float32) if want_g else None
    err = _lib().brick_fwd(x.data_ptr(), table.data_ptr(), ptr(bidx),
                           c_meta(meta), y.data_ptr(), ptr(corners), n,
                           _build.stream_ptr(x.device))
    name = "brick_fwd_g" if want_g else \
        "brick_fwd" if bidx is None else "brick_fwd_b"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return (y, corners) if want_g else y


def _n_tables(table: Optional[torch.Tensor], meta: BrickMeta,
              bidx: Optional[torch.Tensor], what: str) -> int:
    """The blocks of a forest table (1 without bidx; the forest form needs
    the table, which sizes dL/dtable)."""
    if bidx is None:
        return 1
    if table is None:
        raise ValueError(f"{what}: the forest form (bidx) needs the table")
    return table.shape[0] // meta.total_rows


def _bwd_cuda(x: torch.Tensor, g: torch.Tensor, meta: BrickMeta, *,
              need_dx: bool, corners: Optional[torch.Tensor] = None,
              table: Optional[torch.Tensor] = None,
              bidx: Optional[torch.Tensor] = None):
    """B7 → (dL/dx [N,3] or None, dL/dtable [rows,128]). dL/dx reads the
    corner values from `corners` (the want_g forward's) or else from the
    table; it is each point's own level sum, the same bits in any order of
    the points. With `bidx` [N] int32 the forest form: dL/dtable [B·
    total_rows, 128] is sized from `table` (required), dL/dx reads the
    table (no corners). Counted as `brick_bwd` or `brick_bwd_b`."""
    if need_dx and corners is None and table is None:
        raise ValueError("brick_bwd: dL/dx needs the forward's corners or "
                         "the table")
    if bidx is not None and corners is not None:
        raise ValueError("brick_bwd: the forest form takes no corners")
    n_tab = _n_tables(table, meta, bidx, "brick_bwd")
    x, g = aligned(x), aligned(g)
    table = None if table is None else aligned(table)
    corners = None if corners is None else aligned(corners)
    bidx = None if bidx is None else bidx.contiguous()
    dtab = torch.empty((n_tab * meta.total_rows, LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().brick_bwd(x.data_ptr(), g.data_ptr(), ptr(corners),
                           ptr(table), ptr(bidx), n_tab, c_meta(meta),
                           dtab.data_ptr(), ptr(dx), x.shape[0],
                           _build.stream_ptr(x.device))
    name = "brick_bwd" if bidx is None else "brick_bwd_b"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return dx, dtab


def _dydx_cuda(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
               meta: BrickMeta, bidx: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """B8 → J_enc(x)ᵀ·g_up [N,3]; with `bidx` [N] int32 the forest form
    over a [B·total_rows, 128] table. Counted as `brick_dydx` or
    `brick_dydx_b`."""
    g_up, x, table = aligned(g_up), aligned(x), aligned(table)
    bidx = None if bidx is None else bidx.contiguous()
    dx = torch.empty_like(x)
    err = _lib().brick_dydx(g_up.data_ptr(), x.data_ptr(), table.data_ptr(),
                            ptr(bidx), c_meta(meta), dx.data_ptr(),
                            x.shape[0], _build.stream_ptr(x.device))
    name = "brick_dydx" if bidx is None else "brick_dydx_b"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return dx


def _bwd2_cuda(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
               gg: torch.Tensor, meta: BrickMeta, need_dx: bool = True,
               bidx: Optional[torch.Tensor] = None):
    """B9 → (dL/dg_up [N,2L], dL/dx [N,3] or None, dL/dtable [rows,128]);
    with `bidx` [N] int32 the forest form over a [B·total_rows, 128] table
    (dL/dtable that shape). Counted as `brick_bwd2` or `brick_bwd2_b`."""
    n_tab = _n_tables(table, meta, bidx, "brick_bwd2")
    g_up, x, table, gg = (aligned(t) for t in (g_up, x, table, gg))
    bidx = None if bidx is None else bidx.contiguous()
    dgup = torch.empty_like(g_up)
    dtab = torch.empty((n_tab * meta.total_rows, LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().brick_bwd2(g_up.data_ptr(), x.data_ptr(), table.data_ptr(),
                            gg.data_ptr(), ptr(bidx), n_tab, c_meta(meta),
                            dgup.data_ptr(), dtab.data_ptr(), ptr(dx),
                            x.shape[0], _build.stream_ptr(x.device))
    name = "brick_bwd2" if bidx is None else "brick_bwd2_b"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return dgup, dx, dtab


class _BrickEncode(torch.autograd.Function):
    """B6 forward, B7 backward. `want_g` (x requires grad) makes B6 save
    the corner values that B7's dL/dx reads; dL/dx is computed only when x
    needs it."""

    @staticmethod
    def forward(ctx, x, table, meta, want_g):
        ctx.meta = meta
        if want_g:
            y, corners = _fwd_cuda(x, table, meta, want_g=True)
            ctx.save_for_backward(x, corners)
        else:
            y = _fwd_cuda(x, table, meta)
            ctx.save_for_backward(x)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *corners = ctx.saved_tensors
        dx, dtab = _bwd_cuda(x, g, ctx.meta, need_dx=ctx.needs_input_grad[0],
                             corners=corners[0] if corners else None)
        return dx, (dtab if ctx.needs_input_grad[1] else None), None, None


class _BrickNablas(torch.autograd.Function):
    """B8 forward, B9 backward."""

    @staticmethod
    def forward(ctx, g_up, x, table, meta):
        ctx.meta = meta
        ctx.save_for_backward(g_up, x, table)
        return _dydx_cuda(g_up, x, table, meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        g_up, x, table = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgup, dx, dtab = _bwd2_cuda(g_up, x, table, gg, ctx.meta,
                                    need_dx=need[1])
        return (dgup if need[0] else None, dx,
                dtab if need[2] else None, None)


# ----------------------------------------------------------- the wrappers
def brick_encode(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta
                 ) -> torch.Tensor:
    """F=2 brick encode (B6): [N,3] in [0,1] × [rows,128] → [N, 2L]. CPU
    tensor → plain version; CUDA tensor → the `brick_fwd` kernel, with B7
    as its backward when a gradient is needed."""
    if x.device.type == "cpu":
        return brick_encode_xla(x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick_encode: unsupported device {x.device}")
    check_cuda_args(x, table, meta, LANES, "brick_encode")
    if wants_grad(x, table):
        return _BrickEncode.apply(x, table, meta, wants_grad(x))
    return _fwd_cuda(x, table, meta)


def brick_encode_frozen_x(x: torch.Tensor, table: torch.Tensor,
                          meta: BrickMeta) -> torch.Tensor:
    """`brick_encode` for paths where positions carry no gradient (plain
    radiance-field training): x is taken as a constant, so the backward
    (B7) computes dL/dtable only."""
    return brick_encode(x.detach(), table, meta)


def brick_nablas(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                 meta: BrickMeta) -> torch.Tensor:
    """nablas J_enc(x)ᵀ·g_up (B8): g_up [N,2L], x [N,3] → [N,3]. CPU
    tensor → plain version; CUDA tensor → the `brick_dydx` kernel, with B9
    as its backward when a gradient is needed."""
    if x.device.type == "cpu":
        return brick_nablas_xla(g_up, x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick_nablas: unsupported device {x.device}")
    check_cuda_args(x, table, meta, LANES, "brick_nablas", g_up)
    if g_up.shape != (x.shape[0], N_FEAT * meta.n_levels) or \
            g_up.dtype != torch.float32:
        raise ValueError(f"brick_nablas: g_up must be [N, {2 * meta.n_levels}]"
                         f" float32, got {tuple(g_up.shape)} {g_up.dtype}")
    if wants_grad(g_up, x, table):
        return _BrickNablas.apply(g_up, x, table, meta)
    return _dydx_cuda(g_up, x, table, meta)


def brick_encode_ho(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta
                    ) -> torch.Tensor:
    """The encode differentiable to any order: the plain formulation on
    any device, as the JAX package runs its XLA formulation for this on
    the TPU too (the kernel pair B6/B7 is first-order)."""
    return brick_encode_xla(x, table, meta)


def brick_bwd_dydx(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                   meta: BrickMeta) -> torch.Tensor:
    """dL/dx = J_enc(x)ᵀ·g_up alone, not differentiable: on a CUDA tensor
    B7 (`brick_bwd`) with dL/dx asked for, its table gradient discarded;
    on a CPU tensor the plain vjp. Counted as `brick_bwd`."""
    if x.device.type == "cpu":
        return _vjp(lambda xx, tt: brick_encode_xla(xx, tt, meta),
                    (x, table), (True, False), g_up)[0]
    if x.device.type != "cuda":
        raise ValueError(f"brick_bwd_dydx: unsupported device {x.device}")
    check_cuda_args(x, table, meta, LANES, "brick_bwd_dydx", g_up)
    if g_up.shape != (x.shape[0], N_FEAT * meta.n_levels) or \
            g_up.dtype != torch.float32:
        raise ValueError(f"brick_bwd_dydx: g_up must be [N, "
                         f"{N_FEAT * meta.n_levels}] float32, got "
                         f"{tuple(g_up.shape)} {g_up.dtype}")
    dx, _ = _bwd_cuda(x.detach(), g_up.detach(), meta, need_dx=True,
                      table=table.detach())
    return dx


# ----------------------------------------------------------- forest/batched
def make_forest_meta(meta: BrickMeta) -> BrickMeta:
    """The meta of per-block tables: the same levels (the JAX version only
    turns off its TPU one-hot row gather, which the port does not have)."""
    return meta


def _block_rows(bidx: torch.Tensor, meta: BrickMeta) -> torch.Tensor:
    """Each point's first row in a [B·total_rows, 128] table: block
    max(bidx, 0) (bidx < 0 reads block 0; the callers zero those
    points)."""
    return torch.clamp(bidx.to(torch.int64), min=0) * meta.total_rows


def brick_encode_xla_batched(x: torch.Tensor, table: torch.Tensor,
                             meta: BrickMeta, bidx: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch version of the forest form of B6: table [B·total_rows,
    128], block b owns rows [b·total_rows, (b+1)·total_rows), bidx [N]
    int32 (< B). Differentiable in x and table."""
    return _encode_plain(x, table.reshape(-1), meta, N_FEAT,
                         _block_rows(bidx, meta))


def brick_nablas_xla_batched(g_up: torch.Tensor, x: torch.Tensor,
                             table: torch.Tensor, meta: BrickMeta,
                             bidx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forest form of B8: the vjp of
    `brick_encode_xla_batched` in x, written out as `brick_nablas_xla`."""
    return _nablas_plain(g_up, x, table.reshape(-1), meta, N_FEAT,
                         _block_rows(bidx, meta))


def brick_encode_bwd_xla_batched(x: torch.Tensor, table: torch.Tensor,
                                 g: torch.Tensor, meta: BrickMeta,
                                 bidx: torch.Tensor, need_dx: bool = True):
    """Plain PyTorch version of the forest form of B7: the vjp of
    `brick_encode_xla_batched` → (dL/dx [N,3] or None, dL/dtable
    [B·total_rows, 128])."""
    return _vjp(lambda xx, tt: brick_encode_xla_batched(xx, tt, meta, bidx),
                (x, table), (need_dx, True), g)


def brick_nablas_bwd_xla_batched(g_up: torch.Tensor, x: torch.Tensor,
                                 table: torch.Tensor, gg: torch.Tensor,
                                 meta: BrickMeta, bidx: torch.Tensor):
    """Plain PyTorch version of the forest form of B9: the vjp of
    `brick_nablas_xla_batched` → (dL/dg_up [N,2L], dL/dx [N,3], dL/dtable
    [B·total_rows, 128])."""
    return _vjp(lambda a, b, c: brick_nablas_xla_batched(a, b, c, meta,
                                                         bidx),
                (g_up, x, table), (True, True, True), gg)


def _check_batched(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta,
                   bidx: torch.Tensor, what: str) -> None:
    """Shapes, types and devices the forest forms take; raises otherwise
    (bidx must also be < B: the kernels do not check it)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be [N,3] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if table.dim() != 2 or table.shape[1] != LANES or \
            table.shape[0] % meta.total_rows or \
            table.dtype != torch.float32 or table.device != x.device:
        raise ValueError(f"{what}: table must be [B·{meta.total_rows}, "
                         f"{LANES}] float32 on {x.device}, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if bidx.shape != x.shape[:1] or bidx.dtype != torch.int32 or \
            bidx.device != x.device:
        raise ValueError(f"{what}: bidx must be [N] int32 on {x.device}, got "
                         f"{tuple(bidx.shape)} {bidx.dtype} {bidx.device}")


class _BrickEncodeBatched(torch.autograd.Function):
    """The forest forms of B6 (forward) and B7 (backward); dL/dx is
    computed only when x needs it, from the table at each point's
    block."""

    @staticmethod
    def forward(ctx, x, table, meta, bidx):
        ctx.meta = meta
        ctx.save_for_backward(x, table, bidx)
        return _fwd_cuda(x, table, meta, bidx=bidx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, table, bidx = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dtab = _bwd_cuda(x, g, ctx.meta, need_dx=need[0], table=table,
                             bidx=bidx)
        return dx, (dtab if need[1] else None), None, None


class _BrickNablasBatched(torch.autograd.Function):
    """The forest forms of B8 (forward) and B9 (backward)."""

    @staticmethod
    def forward(ctx, g_up, x, table, meta, bidx):
        ctx.meta = meta
        ctx.save_for_backward(g_up, x, table, bidx)
        return _dydx_cuda(g_up, x, table, meta, bidx=bidx)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        g_up, x, table, bidx = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgup, dx, dtab = _bwd2_cuda(g_up, x, table, gg, ctx.meta,
                                    need_dx=need[1], bidx=bidx)
        return (dgup if need[0] else None, dx,
                dtab if need[2] else None, None, None)


def brick_encode_batched(x: torch.Tensor, table: torch.Tensor,
                         meta: BrickMeta, bidx: torch.Tensor
                         ) -> torch.Tensor:
    """Per-block brick encode (the forest): x [N,3] in [0,1], table
    [B·total_rows, 128], bidx [N] int32 → [N, 2L]. One row gather per
    (point, level) whatever the block count. CPU tensor → plain version
    (autograd to any order); CUDA tensor → the `brick_fwd` kernel with its
    block row offset (counted as `brick_fwd_b`), with B7's forest form as
    its backward when a gradient is needed (`brick_bwd_b`)."""
    _check_batched(x, table, meta, bidx, "brick_encode_batched")
    if x.device.type == "cpu":
        return brick_encode_xla_batched(x, table, meta, bidx)
    if wants_grad(x, table):
        return _BrickEncodeBatched.apply(x, table, meta, bidx)
    return _fwd_cuda(x, table, meta, bidx=bidx)


def brick_nablas_batched(g_up: torch.Tensor, x: torch.Tensor,
                         table: torch.Tensor, meta: BrickMeta,
                         bidx: torch.Tensor) -> torch.Tensor:
    """Per-block nablas J_enc(x)ᵀ·g_up [N,3] (the forest). CPU tensor →
    plain version (autograd to any order); CUDA tensor → the `brick_dydx`
    kernel with its block row offset (counted as `brick_dydx_b`), with
    B9's forest form as its backward when a gradient is needed
    (`brick_bwd2_b`)."""
    _check_batched(x, table, meta, bidx, "brick_nablas_batched")
    if g_up.shape != (x.shape[0], N_FEAT * meta.n_levels) or \
            g_up.dtype != torch.float32 or g_up.device != x.device:
        raise ValueError(f"brick_nablas_batched: g_up must be [N, "
                         f"{N_FEAT * meta.n_levels}] float32 on {x.device},"
                         f" got {tuple(g_up.shape)} {g_up.dtype}")
    if x.device.type == "cpu":
        return brick_nablas_xla_batched(g_up, x, table, meta, bidx)
    if wants_grad(g_up, x, table):
        return _BrickNablasBatched.apply(g_up, x, table, meta, bidx)
    return _dydx_cuda(g_up, x, table, meta, bidx=bidx)
