"""Brick-layout LoTD geometry (the subset the F=4 path needs).

Port of nr3d_lib_tpu/ops/lotd_brick.py: a 4×4×4-vertex brick is packed
into one 128-lane row, so one row fetch per (point, level) holds all eight
interpolation corners. Bricks cover 3×3×3 cells and overlap by one vertex
plane. Dense levels lay bricks out in C order; hash levels hash the brick
coordinates with the NGP XOR-primes.

The brick hash multiplies and XORs in uint32. PyTorch has no full uint32
multiply, so it runs in int64 with `& 0xFFFFFFFF` after each product (the
CUDA kernels use native `uint32_t`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BrickLevel", "BrickMeta", "make_brick_meta",
           "vertex_grid_to_brick_rows", "HASH_PRIMES", "BRICK_W", "LANES"]

# nr3d_lib_tpu/ops/lotd.py HASH_PRIMES (copied: the port imports nothing of
# the JAX package)
HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
               2165219737)
_U32 = 0xFFFFFFFF

BRICK_W = 4           # vertices per axis in a brick
BRICK_CELLS = 3       # cells per axis covered (stride)
LANES = 128
N_FEAT = 2            # features per vertex of the F=2 lane layout


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
