"""bf16-packed brick LoTD encoding — 4 feats/vertex at one row fetch.

Port of nr3d_lib_tpu/ops/lotd_brick4.py (forward and nablas; the
training-time backward kernels B2/B4 are the next slice of the port).

Layouts
  * unpacked (user/param space): f32 [rows, 256], lane u = vertex·4 + f.
  * packed (kernel space): f32 [rows, 128], lane p = vertex·2 + f2 holding
    bits bf16(f=2·f2) | bf16(f=2·f2+1) << 16.

Values are quantized to bf16 by the packed path; `brick4_encode_xla` (the
plain version) quantizes the same way, so both compute one function.

Routes: `brick4_encode` (B1) and `brick4_nablas` (B3) take the plain
PyTorch version for a CPU tensor and launch the CUDA kernel of
`csrc/brick4.cu` for a CUDA tensor. The kernels are forward-only: a CUDA
call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops.lotd_brick import (BRICK_W, LANES, BrickMeta,
                                               _corner_bits, _corner_weights,
                                               _level_rows_and_lanes,
                                               make_brick_meta,
                                               vertex_grid_to_brick_rows)

__all__ = ["make_brick4_meta", "brick4_encode", "brick4_encode_xla",
           "brick4_nablas", "brick4_nablas_xla", "pack_table4",
           "dense_brick4_index", "materialize_dense_brick4"]

N_FEAT4 = 4
MAX_LEVELS = 4

_TRAINING_SLICE = ("the CUDA brick4 kernels are forward-only; their "
                   "backward (B2/B4) is slice 2 of the port in ROADMAP.md. "
                   "Run under torch.no_grad(), or on the CPU")


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
def _level_corners(x: torch.Tensor, tq_flat: torch.Tensor, level):
    """Corner values [N,8,4] and fractional coords [N,3] of one level."""
    row, lane0, frac = _level_rows_and_lanes(x, level)
    bits = _corner_bits(x.device)
    corner_v = (bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W + bits[:, 2]
    base = (row[:, None] * 64 + lane0[:, None] // 2 + corner_v) * 4  # [N,8]
    idx = base[..., None] + torch.arange(4, device=x.device)         # [N,8,4]
    return tq_flat[idx], frac


def brick4_encode_xla(x: torch.Tensor, table: torch.Tensor,
                      meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B1 (CPU route; the card's reference).

    x [N,3] in [0,1]; table UNPACKED [rows, 256]. Returns [N, 4L], column
    l·4+f. Values are bf16-quantized to match the packed kernel exactly;
    differentiable in x and table."""
    tq = _quantize4(table).reshape(-1)
    outs = []
    for level in meta.levels:
        vals, frac = _level_corners(x, tq, level)
        w = _corner_weights(frac).to(vals.dtype)                     # [N,8]
        outs.append(torch.sum(w[..., None] * vals, 1))               # [N,4]
    return torch.cat(outs, -1)


def brick4_nablas_xla(g_up: torch.Tensor, x: torch.Tensor,
                      table: torch.Tensor, meta: BrickMeta) -> torch.Tensor:
    """Plain PyTorch version of B3: J_enc(x)ᵀ·g_up [N,3], written out
    analytically (the JAX reference takes the vjp of the plain encode):
    dx_a = Σ_l (res_a−2) Σ_corners (g_up·val)·(2·bit_a−1)·Π_{b≠a} s_b."""
    tq = _quantize4(table).reshape(-1)
    cb = _corner_bits(x.device).to(x.dtype)                          # [8,3]
    sign = 2.0 * cb - 1.0
    dx = [0.0, 0.0, 0.0]
    for l, level in enumerate(meta.levels):
        vals, frac = _level_corners(x, tq, level)
        h = torch.sum(vals * g_up[:, None, 4 * l:4 * l + 4], -1)    # [N,8]
        s = frac[:, None, :] * cb + (1.0 - frac[:, None, :]) * (1.0 - cb)
        for a in range(3):
            b, c = [i for i in range(3) if i != a]
            da = torch.sum(h * sign[:, a] * s[..., b] * s[..., c], -1)
            dx[a] = dx[a] + da * float(level.res[a] - 2)
    return torch.stack(dx, -1)


# ------------------------------------------------------------ CUDA route
class _Level(ctypes.Structure):
    _fields_ = [("res", ctypes.c_int * 3), ("bpa", ctypes.c_int * 3),
                ("n_rows", ctypes.c_int), ("row_offset", ctypes.c_int),
                ("is_hash", ctypes.c_int)]


class _Meta(ctypes.Structure):
    _fields_ = [("n_levels", ctypes.c_int), ("lv", _Level * MAX_LEVELS)]


def _c_meta(meta: BrickMeta) -> _Meta:
    m = _Meta()
    m.n_levels = meta.n_levels
    for i, lv in enumerate(meta.levels):
        m.lv[i].res[:] = list(lv.res)
        m.lv[i].bpa[:] = list(lv.bricks_per_axis)
        m.lv[i].n_rows = lv.n_rows
        m.lv[i].row_offset = lv.row_offset
        m.lv[i].is_hash = int(lv.kind == "hash")
    return m


def _lib():
    vp, n = _build.VP, ctypes.c_longlong
    return _build.load("brick4", {
        "brick4_fwd": [vp, vp, _Meta, vp, n, vp],
        "brick4_dydx": [vp, vp, vp, _Meta, vp, n, vp]})


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load float4/uint2)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda_args(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta,
                     what: str, *extra: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, table, *extra)):
        raise NotImplementedError(f"{what}: {_TRAINING_SLICE}")
    if x.dim() != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
        raise ValueError(f"{what}: x must be [N,3] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if table.shape != (meta.total_rows, 2 * LANES) or \
            table.dtype != torch.float32:
        raise ValueError(f"{what}: table must be [{meta.total_rows}, 256] "
                         f"float32, got {tuple(table.shape)} {table.dtype}")
    for t in (table, *extra):
        if t.device != x.device:
            raise ValueError(f"{what}: all inputs must be on {x.device}")


def _fwd_cuda(x: torch.Tensor, packed: torch.Tensor, meta: BrickMeta
              ) -> torch.Tensor:
    x = _aligned(x)
    y = torch.empty((x.shape[0], N_FEAT4 * meta.n_levels), device=x.device,
                    dtype=torch.float32)
    err = _lib().brick4_fwd(x.data_ptr(), packed.data_ptr(), _c_meta(meta),
                            y.data_ptr(), x.shape[0],
                            _build.stream_ptr(x.device))
    _build.check(err, "brick4_fwd")
    _build.LAUNCHES["brick4_fwd"] += 1
    return y


def _dydx_cuda(g_up: torch.Tensor, x: torch.Tensor, packed: torch.Tensor,
               meta: BrickMeta) -> torch.Tensor:
    x = _aligned(x)
    g_up = _aligned(g_up)
    dx = torch.empty_like(x)
    err = _lib().brick4_dydx(g_up.data_ptr(), x.data_ptr(), packed.data_ptr(),
                             _c_meta(meta), dx.data_ptr(), x.shape[0],
                             _build.stream_ptr(x.device))
    _build.check(err, "brick4_dydx")
    _build.LAUNCHES["brick4_dydx"] += 1
    return dx


# ----------------------------------------------------------- the wrappers
def brick4_encode(x: torch.Tensor, table: torch.Tensor, meta: BrickMeta
                  ) -> torch.Tensor:
    """F=4 packed brick encode (B1): [N,3] in [0,1] × unpacked
    [rows,256] → [N, 4L]. CPU tensor → plain version; CUDA tensor → the
    `brick4_fwd` kernel (forward-only)."""
    if x.device.type == "cpu":
        return brick4_encode_xla(x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick4_encode: unsupported device {x.device}")
    _check_cuda_args(x, table, meta, "brick4_encode")
    return _fwd_cuda(x, pack_table4(table), meta)


def brick4_nablas(g_up: torch.Tensor, x: torch.Tensor, table: torch.Tensor,
                  meta: BrickMeta) -> torch.Tensor:
    """nablas J_enc(x)ᵀ·g_up (B3): g_up [N,4L], x [N,3] → [N,3]. CPU
    tensor → plain version; CUDA tensor → the `brick4_dydx` kernel."""
    if x.device.type == "cpu":
        return brick4_nablas_xla(g_up, x, table, meta)
    if x.device.type != "cuda":
        raise ValueError(f"brick4_nablas: unsupported device {x.device}")
    _check_cuda_args(x, table, meta, "brick4_nablas", g_up)
    if g_up.shape != (x.shape[0], N_FEAT4 * meta.n_levels) or \
            g_up.dtype != torch.float32:
        raise ValueError(f"brick4_nablas: g_up must be [N, {4 * meta.n_levels}]"
                         f" float32, got {tuple(g_up.shape)} {g_up.dtype}")
    return _dydx_cuda(g_up, x, pack_table4(table), meta)
