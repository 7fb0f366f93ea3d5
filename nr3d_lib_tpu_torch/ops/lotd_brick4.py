"""bf16-packed brick LoTD encoding — 4 feats/vertex at one row fetch.

Port of nr3d_lib_tpu/ops/lotd_brick4.py: forward (B1), its backward (B2),
nablas (B3) and the nablas' backward (B4).

Layouts
  * unpacked (user/param space): f32 [rows, 256], lane u = vertex·4 + f.
  * packed (kernel space): f32 [rows, 128], lane p = vertex·2 + f2 holding
    bits bf16(f=2·f2) | bf16(f=2·f2+1) << 16.

Values are quantized to bf16 by the packed path; `brick4_encode_xla` (the
plain version) quantizes the same way, so both compute one function. The
table gradient is straight-through: full-precision cotangents, as in JAX.

Routes: `brick4_encode` and `brick4_nablas` take the plain PyTorch version
(and torch autograd) for a CPU tensor, and the CUDA kernels of
`csrc/brick4.cu` for a CUDA tensor. On CUDA a gradient goes through two
`torch.autograd.Function`s whose backwards are kernels too:
`_Brick4Encode` (B1 forward, B2 backward; B1 saves the packed corner words
for B2's dL/dx when x requires grad) and `_Brick4Nablas` (B3 forward, B4
backward). Neither backward is itself differentiable. The plain versions
of the backwards, `brick4_encode_bwd_xla` and `brick4_nablas_bwd_xla`,
are for tests and for holding the kernels against.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops.lotd_brick import (
    BRICK_W, LANES, BrickMeta, _corner_bits, _encode_plain,
    _level_rows_and_lanes, _nablas_plain, _vjp, aligned, c_meta,
    check_cuda_args, make_brick_meta, meta_struct, ptr,
    vertex_grid_to_brick_rows, wants_grad)

__all__ = ["make_brick4_meta", "brick4_encode", "brick4_encode_xla",
           "brick4_corner_words_xla", "brick4_encode_bwd_xla",
           "brick4_nablas", "brick4_nablas_xla", "brick4_nablas_bwd_xla",
           "pack_table4", "dense_brick4_index", "materialize_dense_brick4"]

N_FEAT4 = 4
MAX_LEVELS = 4


def make_brick4_meta(lod_res, lod_types, hashmap_rows: int = 4096
                     ) -> BrickMeta:
    """Same brick geometry as the F=2 path (4³ vertices / 3³ cells / same
    hashing — rows just carry 4 feats); ≤4 levels (32 lanes each)."""
    meta = make_brick_meta(lod_res, lod_types, hashmap_rows)
    if meta.n_levels > MAX_LEVELS:
        raise ValueError("brick4 packs 32 lanes/level: max 4 levels")
    return meta


# ---------------------------------------------------------------- packing
def pack_table4(t: torch.Tensor) -> torch.Tensor:
    """unpacked f32 [rows, 256] → packed f32 [rows, 128] (bf16 pairs,
    round-to-nearest-even like JAX's cast)."""
    r = t.shape[0]
    quad = t.detach().reshape(r, 64, 2, 2)             # [r, vert, f2, half]
    bits = quad.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    u32 = bits[..., 0] | (bits[..., 1] << 16)          # [r, 64, 2]
    i32 = torch.where(u32 >= 2 ** 31, u32 - 2 ** 32, u32).to(torch.int32)
    return i32.view(torch.float32).reshape(r, LANES)


def _quantize4(t: torch.Tensor) -> torch.Tensor:
    """The packed path's value semantics: params quantized to bf16,
    straight-through for gradients."""
    q = t.to(torch.bfloat16).to(torch.float32)
    return t + (q - t).detach()


def dense_brick4_index(level) -> np.ndarray:
    """For a dense level: index into the vertex params [res³·4] of every
    unpacked (row, lane) slot → [rows, 256] int64."""
    lanes2 = vertex_grid_to_brick_rows(level)          # [rows,128], F=2 lanes
    flat = lanes2[:, 0::2] // 2                        # [rows, 64] vertex ids
    idx = flat[:, :, None] * 4 + np.arange(4)[None, None, :]
    return idx.reshape(-1, 256).astype(np.int64)


def materialize_dense_brick4(vertex_params: torch.Tensor, level
                             ) -> torch.Tensor:
    """Canonical vertex params [res³·4] → unpacked brick rows [rows, 256].
    Shared boundary vertices stay tied (exact Dense semantics)."""
    return vertex_params[torch.as_tensor(dense_brick4_index(level),
                                         device=vertex_params.device)]


# ---------------------------------------------------------- plain versions
def brick4_encode_xla(x: torch.Tensor, table: torch.Tensor,
                      meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B1 (CPU route; the card's reference).

    x [N,3] in [0,1]; table UNPACKED [rows, 256]. Returns [N, 4L], column
    l·4+f. Values are bf16-quantized to match the packed kernel exactly;
    differentiable in x and table."""
    return _encode_plain(x, _quantize4(table).reshape(-1), meta, N_FEAT4)


def brick4_corner_words_xla(x: torch.Tensor, table: torch.Tensor,
                            meta: BrickMeta) -> torch.Tensor:
    """Plain version of B1's want_g output: the packed words of each
    (point, level)'s 8 corners → [N, L, 8, 2] int32 (a copy)."""
    words = pack_table4(table).view(torch.int32).reshape(-1, 2)  # per vertex
    bits = _corner_bits(x.device)
    corner_v = (bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W + bits[:, 2]
    out = []
    for level in meta.levels:
        row, lane0, _ = _level_rows_and_lanes(x, level)
        out.append(words[row[:, None] * 64 + lane0[:, None] // 2 + corner_v])
    return torch.stack(out, 1)


def brick4_nablas_xla(g_up: torch.Tensor, x: torch.Tensor,
                      table: torch.Tensor, meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B3: J_enc(x)ᵀ·g_up [N,3] on the
    bf16-quantized values."""
    return _nablas_plain(g_up, x, _quantize4(table).reshape(-1), meta,
                         N_FEAT4)


def brick4_encode_bwd_xla(x: torch.Tensor, table: torch.Tensor,
                          g: torch.Tensor, meta: BrickMeta,
                          need_dx: bool = True):
    """Plain PyTorch version of B2: the vjp of `brick4_encode_xla` →
    (dL/dx [N,3] or None, dL/dtable [rows,256])."""
    return _vjp(lambda xx, tt: brick4_encode_xla(xx, tt, meta), (x, table),
                (need_dx, True), g)


def brick4_nablas_bwd_xla(g_up: torch.Tensor, x: torch.Tensor,
                          table: torch.Tensor, gg: torch.Tensor,
                          meta: BrickMeta):
    """Plain PyTorch version of B4: the vjp of `brick4_nablas_xla` →
    (dL/dg_up [N,4L], dL/dx [N,3], dL/dtable [rows,256])."""
    return _vjp(lambda a, b, c: brick4_nablas_xla(a, b, c, meta),
                (g_up, x, table), (True, True, True), gg)


# ------------------------------------------------------------ CUDA route
_Meta = meta_struct(MAX_LEVELS)


def _lib():
    vp, n = _build.VP, ctypes.c_longlong
    return _build.load("brick4", {
        "brick4_fwd": [vp, vp, _Meta, vp, vp, n, vp],
        "brick4_bwd": [vp, vp, vp, vp, _Meta, vp, vp, n, vp],
        "brick4_dydx": [vp, vp, vp, _Meta, vp, n, vp],
        "brick4_bwd2": [vp, vp, vp, vp, _Meta, vp, vp, vp, n, vp]})


def _fwd_cuda(x: torch.Tensor, packed: torch.Tensor, meta: BrickMeta,
              want_g: bool = False):
    """B1 → y [N,4L]; with `want_g` → (y, words [N,L,8,2] int32), the
    packed corner words that B2 reads back for dL/dx. Counted as
    `brick4_fwd` or `brick4_fwd_g`."""
    x = aligned(x)
    n, L = x.shape[0], meta.n_levels
    y = torch.empty((n, N_FEAT4 * L), device=x.device, dtype=torch.float32)
    words = torch.empty((n, L, 8, 2), device=x.device,
                        dtype=torch.int32) if want_g else None
    err = _lib().brick4_fwd(x.data_ptr(), packed.data_ptr(),
                            c_meta(meta, _Meta), y.data_ptr(), ptr(words), n,
                            _build.stream_ptr(x.device))
    name = "brick4_fwd_g" if want_g else "brick4_fwd"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return (y, words) if want_g else y


def _bwd_cuda(x: torch.Tensor, g: torch.Tensor, meta: BrickMeta, *,
              need_dx: bool, words: Optional[torch.Tensor] = None,
              packed: Optional[torch.Tensor] = None):
    """B2 → (dL/dx [N,3] or None, dL/dtable [rows,256]). dL/dx reads the
    corner values from `words` (the want_g forward's) or else from the
    packed table."""
    if need_dx and words is None and packed is None:
        raise ValueError("brick4_bwd: dL/dx needs the forward's words or "
                         "the packed table")
    x, g = aligned(x), aligned(g)
    dtab = torch.empty((meta.total_rows, 2 * LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().brick4_bwd(x.data_ptr(), g.data_ptr(), ptr(words),
                            ptr(packed), c_meta(meta, _Meta), dtab.data_ptr(),
                            ptr(dx), x.shape[0], _build.stream_ptr(x.device))
    _build.check(err, "brick4_bwd")
    _build.LAUNCHES["brick4_bwd"] += 1
    return dx, dtab


def _dydx_cuda(g_up: torch.Tensor, x: torch.Tensor, packed: torch.Tensor,
               meta: BrickMeta) -> torch.Tensor:
    x = aligned(x)
    g_up = aligned(g_up)
    dx = torch.empty_like(x)
    err = _lib().brick4_dydx(g_up.data_ptr(), x.data_ptr(), packed.data_ptr(),
                             c_meta(meta, _Meta), dx.data_ptr(), x.shape[0],
                             _build.stream_ptr(x.device))
    _build.check(err, "brick4_dydx")
    _build.LAUNCHES["brick4_dydx"] += 1
    return dx


def _bwd2_cuda(g_up: torch.Tensor, x: torch.Tensor, packed: torch.Tensor,
               gg: torch.Tensor, meta: BrickMeta, need_dx: bool = True):
    """B4 → (dL/dg_up [N,4L], dL/dx [N,3] or None, dL/dtable [rows,256])."""
    g_up, x, gg = aligned(g_up), aligned(x), aligned(gg)
    dgup = torch.empty_like(g_up)
    dtab = torch.empty((meta.total_rows, 2 * LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().brick4_bwd2(g_up.data_ptr(), x.data_ptr(), packed.data_ptr(),
                             gg.data_ptr(), c_meta(meta, _Meta),
                             dgup.data_ptr(), dtab.data_ptr(), ptr(dx),
                             x.shape[0],
                             _build.stream_ptr(x.device))
    _build.check(err, "brick4_bwd2")
    _build.LAUNCHES["brick4_bwd2"] += 1
    return dgup, dx, dtab


class _Brick4Encode(torch.autograd.Function):
    """B1 forward, B2 backward. `want_g` (x requires grad) makes B1 save
    the corner words that B2's dL/dx reads; dL/dx is computed only when x
    needs it."""

    @staticmethod
    def forward(ctx, x, table, meta, want_g):
        packed = pack_table4(table)
        ctx.meta = meta
        if want_g:
            y, words = _fwd_cuda(x, packed, meta, want_g=True)
            ctx.save_for_backward(x, words)
        else:
            y = _fwd_cuda(x, packed, meta)
            ctx.save_for_backward(x)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *words = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dx, dtab = _bwd_cuda(x, g, ctx.meta, need_dx=need_dx,
                             words=words[0] if words else None)
        return dx, (dtab if ctx.needs_input_grad[1] else None), None, None


class _Brick4Nablas(torch.autograd.Function):
    """B3 forward, B4 backward."""

    @staticmethod
    def forward(ctx, g_up, x, table, meta):
        packed = pack_table4(table)
        ctx.meta = meta
        ctx.save_for_backward(g_up, x, packed)
        return _dydx_cuda(g_up, x, packed, meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        g_up, x, packed = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgup, dx, dtab = _bwd2_cuda(g_up, x, packed, gg, ctx.meta,
                                    need_dx=need[1])
        return (dgup if need[0] else None, dx,
                dtab if need[2] else None, None)


# ----------------------------------------------------------- the wrappers
def brick4_encode(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta
                  ) -> torch.Tensor:
    """F=4 packed brick encode (B1): [N,3] in [0,1] × unpacked
    [rows,256] → [N, 4L]. CPU tensor → plain version; CUDA tensor → the
    `brick4_fwd` kernel, with B2 as its backward when a gradient is
    needed."""
    if x.device.type == "cpu":
        return brick4_encode_xla(x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick4_encode: unsupported device {x.device}")
    check_cuda_args(x, table, meta, 2 * LANES, "brick4_encode")
    if wants_grad(x, table):
        return _Brick4Encode.apply(x, table, meta, wants_grad(x))
    return _fwd_cuda(x, pack_table4(table), meta)


def brick4_nablas(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                  meta: BrickMeta) -> torch.Tensor:
    """nablas J_enc(x)ᵀ·g_up (B3): g_up [N,4L], x [N,3] → [N,3]. CPU
    tensor → plain version; CUDA tensor → the `brick4_dydx` kernel, with
    B4 as its backward when a gradient is needed."""
    if x.device.type == "cpu":
        return brick4_nablas_xla(g_up, x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick4_nablas: unsupported device {x.device}")
    check_cuda_args(x, table, meta, 2 * LANES, "brick4_nablas",
                    g_up)
    if g_up.shape != (x.shape[0], N_FEAT4 * meta.n_levels) or \
            g_up.dtype != torch.float32:
        raise ValueError(f"brick4_nablas: g_up must be "
                         f"[N, {4 * meta.n_levels}] float32, got "
                         f"{tuple(g_up.shape)} {g_up.dtype}")
    if wants_grad(g_up, x, table):
        return _Brick4Nablas.apply(g_up, x, table, meta)
    return _dydx_cuda(g_up, x, pack_table4(table), meta)
