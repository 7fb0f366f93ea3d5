"""Element gather values[row[i], lane[i]] for large random index streams.

Port of nr3d_lib_tpu/ops/gather1d.py. For element lookups from a small 2-D
table (occupancy grids: 64³ → [4096, 64] f32). Not differentiable (lookup
tables only).

Route by the device of `values`: CPU → plain indexing; CUDA → the
`gather1d` kernel of `csrc/gather1d.cu` (B5).
"""

from __future__ import annotations

import ctypes

import torch

from nr3d_lib_tpu_torch.ops import _build

__all__ = ["gather_rows_lanes", "gather_rows_lanes_plain"]


def gather_rows_lanes_plain(values: torch.Tensor, row: torch.Tensor,
                            lane: torch.Tensor) -> torch.Tensor:
    """Plain version: flat take with indices clipped into the table (the
    JAX fallback's `mode="clip"`)."""
    flat = row.to(torch.int64) * values.shape[1] + lane.to(torch.int64)
    flat = flat.clamp(0, values.numel() - 1)
    return values.reshape(-1)[flat]


def _lib():
    vp = _build.VP
    return _build.load("gather1d", {"gather1d": [
        vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]})


def gather_rows_lanes(values: torch.Tensor, row: torch.Tensor,
                      lane: torch.Tensor) -> torch.Tensor:
    """values [R, C] f32; row/lane [...] int → values[row, lane] [...]."""
    shape = row.shape
    row = row.reshape(-1)
    lane = lane.reshape(-1)
    if values.device.type == "cpu":
        return gather_rows_lanes_plain(values, row, lane).reshape(shape)
    if values.device.type != "cuda":
        raise ValueError(f"gather_rows_lanes: unsupported device "
                         f"{values.device}")
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError(f"gather_rows_lanes: values must be [R, C] float32, "
                         f"got {tuple(values.shape)} {values.dtype}")
    if row.shape != lane.shape:
        raise ValueError("gather_rows_lanes: row and lane differ in shape")
    if row.device != values.device or lane.device != values.device:
        raise ValueError(f"gather_rows_lanes: all inputs must be on "
                         f"{values.device}")
    values = values.contiguous()
    row = row.to(torch.int32).contiguous()
    lane = lane.to(torch.int32).contiguous()
    out = torch.empty(row.shape, device=values.device, dtype=torch.float32)
    err = _lib().gather1d(values.data_ptr(), row.data_ptr(), lane.data_ptr(),
                          out.data_ptr(), row.numel(), values.shape[0],
                          values.shape[1], _build.stream_ptr(values.device))
    _build.check(err, "gather1d")
    _build.LAUNCHES["gather1d"] += 1
    return out.reshape(shape)
