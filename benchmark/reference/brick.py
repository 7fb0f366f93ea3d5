"""The F=4 brick LoTD encoding in plain PyTorch.

A frozen copy of the plain formulation that nr3d_lib's brick layout
defines: a 4×4×4-vertex brick is one row of 64 vertices, bricks cover 3³
cells and overlap by one vertex plane, dense levels lay bricks out in C
order, hash levels hash the brick coordinates with the Instant-NGP
XOR-primes. F=4 stores the table in bf16 (round to nearest even) by
design, so the values are rounded to bf16 here too, straight-through for
the gradient. Every operation is a plain gather, product or sum, so
autograd gives the nablas and their second order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

HASH_PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
BRICK_W = 4           # vertices per axis in a brick
BRICK_CELLS = 3       # cells per axis a brick covers
N_FEAT = 4
ROW = 64 * N_FEAT     # unpacked values a row


@dataclass(frozen=True)
class Level:
    res: Tuple[int, int, int]
    kind: str                       # "dense" | "hash"
    n_rows: int
    bricks_per_axis: Tuple[int, int, int]
    row_offset: int


def make_levels(lod_res: Sequence, lod_types: Sequence[str],
                hashmap_rows: int) -> List[Level]:
    """The levels of a brick table; a hash level that fits is dense."""
    levels, offset = [], 0
    for res, kind in zip(lod_res, lod_types):
        res = (int(res),) * 3 if np.isscalar(res) else \
            tuple(int(v) for v in res)
        bpa = tuple(int(math.ceil((r - 1) / BRICK_CELLS)) for r in res)
        kind = kind.lower()
        n_rows = int(np.prod(bpa))
        if kind == "hash":
            if int(hashmap_rows) < n_rows:
                n_rows = int(hashmap_rows)
            else:
                kind = "dense"
        levels.append(Level(res, kind, n_rows, bpa, offset))
        offset += n_rows
    return levels


def level_param_sizes(levels: Sequence[Level]) -> List[int]:
    """Parameters a level holds: a dense level its vertex grid × 4, a hash
    level its rows × 256."""
    return [int(np.prod(lv.res)) * N_FEAT if lv.kind == "dense"
            else lv.n_rows * ROW for lv in levels]


def dense_index(level: Level) -> np.ndarray:
    """For a dense level: the vertex-parameter index of every (row, value)
    slot → [rows, 256]; border vertices are clamped, so shared vertices
    stay tied."""
    bx, by, bz = level.bricks_per_axis
    rx, ry, rz = level.res
    b = np.stack(np.meshgrid(np.arange(bx), np.arange(by), np.arange(bz),
                             indexing="ij"), -1).reshape(-1, 1, 3)
    loc = np.stack(np.meshgrid(*([np.arange(BRICK_W)] * 3), indexing="ij"),
                   -1).reshape(1, -1, 3)
    v = np.minimum(b * BRICK_CELLS + loc, np.asarray([rx - 1, ry - 1, rz - 1]))
    flat = (v[..., 0] * ry + v[..., 1]) * rz + v[..., 2]        # [rows, 64]
    return (flat[..., None] * N_FEAT + np.arange(N_FEAT)).reshape(
        -1, ROW).astype(np.int64)


def build_table(flat_params: torch.Tensor, levels: Sequence[Level]
                ) -> torch.Tensor:
    """The flat parameter vector → the table [rows, 256] of values rounded
    to bf16, straight-through for the gradient."""
    sizes = level_param_sizes(levels)
    offs = np.cumsum([0] + sizes)
    rows = []
    for i, lv in enumerate(levels):
        p = flat_params[int(offs[i]):int(offs[i + 1])]
        if lv.kind == "dense":
            idx = torch.as_tensor(dense_index(lv), device=p.device)
            rows.append(p[idx])
        else:
            rows.append(p.reshape(lv.n_rows, ROW))
    t = torch.cat(rows, 0)
    q = t.to(torch.bfloat16).to(t.dtype)
    return t + (q - t).detach()


def _corner_bits(device) -> torch.Tensor:
    k = torch.arange(8, device=device)
    return torch.stack([(k >> 2) & 1, (k >> 1) & 1, k & 1], -1)


def _level_corners(x01: torch.Tensor, table_flat: torch.Tensor, lv: Level):
    """The 8 corner values [N, 8, 4] of each point's cell at one level and
    its fractional coordinates [N, 3] (x01 in [0, 1], scale res − 2)."""
    brick, local, frac = [], [], []
    for a in range(3):
        v = x01[:, a] * float(lv.res[a] - 2) + 0.5
        cell = torch.floor(v)
        frac.append(v - cell.detach())
        cell = cell.to(torch.int64).clamp(0, lv.res[a] - 2)
        b = cell // BRICK_CELLS
        local.append(cell - b * BRICK_CELLS)
        brick.append(b.clamp(max=lv.bricks_per_axis[a] - 1))
    b0, b1, b2 = brick
    bpa = lv.bricks_per_axis
    if lv.kind == "dense":
        row = (b0 * bpa[1] + b1) * bpa[2] + b2
    else:
        h = (b0 * HASH_PRIMES[0]) & U32
        h = h ^ ((b1 * HASH_PRIMES[1]) & U32)
        h = h ^ ((b2 * HASH_PRIMES[2]) & U32)
        row = h % lv.n_rows
    l0, l1, l2 = local
    vert0 = (l0 * BRICK_W + l1) * BRICK_W + l2
    bits = _corner_bits(x01.device)
    corner = (bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W + bits[:, 2]
    vert = (row + lv.row_offset)[:, None] * 64 + vert0[:, None] + corner
    idx = vert[..., None] * N_FEAT + torch.arange(N_FEAT, device=x01.device)
    return table_flat[idx], torch.stack(frac, -1)


def encode(x: torch.Tensor, table: torch.Tensor, levels: Sequence[Level]
           ) -> torch.Tensor:
    """x [N, 3] in [−1, 1] → features [N, 4L] (column l·4 + f): trilinear
    interpolation of the 8 corners at each level."""
    x01 = x * 0.5 + 0.5
    flat = table.reshape(-1)
    cb = _corner_bits(x.device).to(x.dtype)
    outs = []
    for lv in levels:
        vals, frac = _level_corners(x01, flat, lv)
        w = torch.prod(frac[:, None, :] * cb + (1.0 - frac[:, None, :]) *
                       (1.0 - cb), -1)
        outs.append(torch.sum(w[..., None] * vals.to(w.dtype), 1))
    return torch.cat(outs, -1)
