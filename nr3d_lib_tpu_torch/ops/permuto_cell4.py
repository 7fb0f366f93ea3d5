"""bf16-packed F=4 cell permutohedral encoding: forward (B14), its backward
(B15) and nablas (B16).

Port of nr3d_lib_tpu/ops/permuto_cell4.py. The row layout is the F=2 cell
layout of `ops/permuto_cell.py` with two bf16 features in each lane:
  * unpacked (user/param space): f32 [rows, 256], lane u = 2·lane + half,
    so vertex k's four features sit at u = 2·lane_k … 2·lane_k + 3, where
    lane_k is the F=2 lane of the vertex's first feature;
  * packed (kernel space): f32 [rows, 128], `pack_table4` of
    `ops/lotd_brick4.py`.
Values are quantized to bf16 by the packed path; the plain version
(`permuto_cell4_encode_xla`, the F-feature plain encode of
`ops/permuto_cell.py` on the quantized table) quantizes the same way, so
both compute one function. The table gradient is straight-through, as in
JAX.

Routes: `permuto_cell4_encode`, `permuto_cell4_encode_frozen_x` and
`permuto_cell4_nablas` take the plain PyTorch version (and torch autograd)
for a CPU tensor, and the CUDA kernels of `csrc/permuto_cell4.cu` for a
CUDA tensor. On CUDA, `_Permuto4Encode` runs B14 forward and B15 backward
(dL/dx only when x needs it: written once per point, the same bits
whatever the order of the points); `_Permuto4Nablas` runs B16 forward and, as
its backward, the plain PyTorch vjp of the plain nablas (gathers and
`index_add_`): the JAX package computes that second order in XLA, not in a
Pallas kernel. The barycentric weights are affine in x inside a simplex,
so the nablas' derivative in x is zero.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops.lotd_brick import _vjp, aligned, ptr, wants_grad
from nr3d_lib_tpu_torch.ops.lotd_brick4 import _quantize4, pack_table4
from nr3d_lib_tpu_torch.ops.permuto_cell import (
    LANES, PermutoCellMeta, _Meta, c_meta, check_cuda_args, encode_plain,
    make_permuto_cell_meta, nablas_plain)

__all__ = ["make_permuto_cell4_meta", "permuto_cell4_encode",
           "permuto_cell4_encode_frozen_x", "permuto_cell4_nablas",
           "permuto_cell4_encode_xla", "permuto_cell4_encode_bwd_xla",
           "permuto_cell4_nablas_xla", "permuto_cell4_nablas_bwd_xla"]

N_FEAT4 = 4


def make_permuto_cell4_meta(n_dims: int, res_list, hashmap_rows: int = 4096,
                            auto_dense: bool = True) -> PermutoCellMeta:
    """Same meta as the F=2 cell layout: rows just carry 4 feats/slot."""
    return make_permuto_cell_meta(n_dims, res_list, hashmap_rows, auto_dense)


# ---------------------------------------------------------- plain versions
def permuto_cell4_encode_xla(x: torch.Tensor, table: torch.Tensor,
                             meta: PermutoCellMeta) -> torch.Tensor:
    """Plain PyTorch version of B14 (CPU route; the card's reference).
    x [N, d] in the lattice's [0,1] space; table UNPACKED [rows, 256].
    Returns [N, 4L], column l·4 + f; bf16-quantized values; differentiable
    in x and table."""
    return encode_plain(x, _quantize4(table), meta, N_FEAT4)


def permuto_cell4_nablas_xla(g_up: torch.Tensor, x: torch.Tensor,
                             table: torch.Tensor, meta: PermutoCellMeta
                             ) -> torch.Tensor:
    """Plain PyTorch version of B16: J_enc(x)ᵀ·g_up [N, d] of the
    bf16-quantized table (`nablas_plain` of `ops/permuto_cell.py`)."""
    return nablas_plain(g_up, x, _quantize4(table), meta, N_FEAT4)


def permuto_cell4_encode_bwd_xla(x: torch.Tensor, table: torch.Tensor,
                                 g: torch.Tensor, meta: PermutoCellMeta,
                                 need_dx: bool = True):
    """Plain PyTorch version of B15: the vjp of `permuto_cell4_encode_xla`
    → (dL/dx [N, d] or None, dL/dtable [rows, 256])."""
    return _vjp(lambda xx, tt: permuto_cell4_encode_xla(xx, tt, meta),
                (x, table), (need_dx, True), g)


def permuto_cell4_nablas_bwd_xla(g_up: torch.Tensor, x: torch.Tensor,
                                 table: torch.Tensor, gg: torch.Tensor,
                                 meta: PermutoCellMeta):
    """The vjp of `permuto_cell4_nablas_xla` → (dL/dg_up [N, 4L], dL/dx
    [N, d] (zeros), dL/dtable [rows, 256]): the nablas' backward on both
    routes."""
    return _vjp(lambda a, b, c: permuto_cell4_nablas_xla(a, b, c, meta),
                (g_up, x, table), (True, True, True), gg)


# ------------------------------------------------------------ CUDA route
def _lib():
    vp, n, i = _build.VP, ctypes.c_longlong, ctypes.c_int
    return _build.load("permuto_cell4", {
        "permuto4_fwd": [vp, vp, _Meta, vp, n, vp],
        "permuto4_bwd": [vp, vp, vp, _Meta, vp, vp, n, vp],
        "permuto4_dydx": [vp, vp, vp, _Meta, vp, n, vp],
        # the simplex search's self-checks over all 2^32 inputs
        "pc_check_div": [i, vp, vp], "pc_check_mod": [_Meta, i, vp, vp]})


def _fwd_cuda(x: torch.Tensor, packed: torch.Tensor,
              meta: PermutoCellMeta) -> torch.Tensor:
    """B14 → y [N, 4L]."""
    x = aligned(x)
    y = torch.empty((x.shape[0], N_FEAT4 * meta.n_levels), device=x.device,
                    dtype=torch.float32)
    err = _lib().permuto4_fwd(x.data_ptr(), packed.data_ptr(), c_meta(meta),
                              y.data_ptr(), x.shape[0],
                              _build.stream_ptr(x.device))
    _build.check(err, "permuto4_fwd")
    _build.LAUNCHES["permuto4_fwd"] += 1
    return y


def _bwd_cuda(x: torch.Tensor, g: torch.Tensor, meta: PermutoCellMeta, *,
              need_dx: bool, packed: Optional[torch.Tensor] = None):
    """B15 → (dL/dx [N, d] or None, dL/dtable [rows, 256]); dL/dx reads
    the vertex values from the packed table."""
    if need_dx and packed is None:
        raise ValueError("permuto4_bwd: dL/dx needs the packed table")
    x, g = aligned(x), aligned(g)
    dtab = torch.empty((meta.total_rows, 2 * LANES), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    err = _lib().permuto4_bwd(x.data_ptr(), g.data_ptr(),
                              ptr(packed) if need_dx else None, c_meta(meta),
                              dtab.data_ptr(), ptr(dx), x.shape[0],
                              _build.stream_ptr(x.device))
    _build.check(err, "permuto4_bwd")
    _build.LAUNCHES["permuto4_bwd"] += 1
    return dx, dtab


def _dydx_cuda(g_up: torch.Tensor, x: torch.Tensor, packed: torch.Tensor,
               meta: PermutoCellMeta) -> torch.Tensor:
    """B16 → J_enc(x)ᵀ·g_up [N, d]."""
    g_up, x = aligned(g_up), aligned(x)
    dx = torch.empty_like(x)
    err = _lib().permuto4_dydx(g_up.data_ptr(), x.data_ptr(),
                               packed.data_ptr(), c_meta(meta), dx.data_ptr(),
                               x.shape[0], _build.stream_ptr(x.device))
    _build.check(err, "permuto4_dydx")
    _build.LAUNCHES["permuto4_dydx"] += 1
    return dx


class _Permuto4Encode(torch.autograd.Function):
    """B14 forward, B15 backward; dL/dx only when x needs it."""

    @staticmethod
    def forward(ctx, x, table, meta):
        packed = pack_table4(table)
        ctx.meta = meta
        ctx.save_for_backward(x, packed)
        return _fwd_cuda(x, packed, meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, packed = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        dx, dtab = _bwd_cuda(x, g, ctx.meta, need_dx=need_dx,
                             packed=packed if need_dx else None)
        return dx, (dtab if ctx.needs_input_grad[1] else None), None


class _Permuto4Nablas(torch.autograd.Function):
    """B16 forward; the backward is the plain vjp of the plain nablas."""

    @staticmethod
    def forward(ctx, g_up, x, table, meta):
        ctx.meta = meta
        ctx.save_for_backward(g_up, x, table)
        return _dydx_cuda(g_up, x, pack_table4(table), meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        g_up, x, table = ctx.saved_tensors
        dgup, dx, dtab = permuto_cell4_nablas_bwd_xla(g_up, x, table, gg,
                                                      ctx.meta)
        need = ctx.needs_input_grad
        return (dgup if need[0] else None, dx if need[1] else None,
                dtab if need[2] else None, None)


# ----------------------------------------------------------- the wrappers
def permuto_cell4_encode(x: torch.Tensor, table: torch.Tensor,
                         meta: PermutoCellMeta) -> torch.Tensor:
    """F=4 packed cell permuto encode (B14): [N, d] × unpacked [rows, 256]
    → [N, 4L]. CPU tensor → plain version; CUDA tensor → the
    `permuto4_fwd` kernel, with B15 as its backward when a gradient is
    needed."""
    if x.device.type == "cpu":
        return permuto_cell4_encode_xla(x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"permuto_cell4_encode: unsupported device "
                         f"{x.device}")
    check_cuda_args(x, table, meta, N_FEAT4, "permuto_cell4_encode")
    if wants_grad(x, table):
        return _Permuto4Encode.apply(x, table, meta)
    return _fwd_cuda(x, pack_table4(table), meta)


def permuto_cell4_encode_frozen_x(x: torch.Tensor, table: torch.Tensor,
                                  meta: PermutoCellMeta) -> torch.Tensor:
    """`permuto_cell4_encode` with x taken as a constant: the backward
    (B15) computes dL/dtable only."""
    return permuto_cell4_encode(x.detach(), table, meta)


def permuto_cell4_nablas(g_up: torch.Tensor, x: torch.Tensor,
                         table: torch.Tensor, meta: PermutoCellMeta
                         ) -> torch.Tensor:
    """nablas J_enc(x)ᵀ·g_up (B16): g_up [N, 4L], x [N, d] → [N, d]. CPU
    tensor → plain version; CUDA tensor → the `permuto4_dydx` kernel,
    with the plain vjp as its backward when a gradient is needed."""
    if x.device.type == "cpu":
        return permuto_cell4_nablas_xla(g_up, x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"permuto_cell4_nablas: unsupported device "
                         f"{x.device}")
    check_cuda_args(x, table, meta, N_FEAT4, "permuto_cell4_nablas",
                    g_up)
    if wants_grad(g_up, x, table):
        return _Permuto4Nablas.apply(g_up, x, table, meta)
    return _dydx_cuda(g_up, x, pack_table4(table), meta)
