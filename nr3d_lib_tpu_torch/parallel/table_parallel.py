"""Table-parallel brick encoding (port of
nr3d_lib_tpu/parallel/table_parallel.py).

The F=2 brick table's rows are split over a mesh axis. Every (point,
level) lookup touches one table row, so each rank computes the
contributions of the rows it owns (zeros elsewhere) with the plain brick
helpers, as JAX's `_local_contribution` does, and one all-reduce over
the axis sums them. Gradients reach only the owner's rows; the
all-reduce passes the cotangent through unchanged backward (see
`forest_parallel`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nr3d_lib_tpu_torch.ops.lotd_brick import (BRICK_W, N_FEAT, BrickMeta,
                                               _corner_bits, _corner_weights,
                                               _level_rows_and_lanes)
from nr3d_lib_tpu_torch.parallel.forest_parallel import (local_rows,
                                                         sum_over_group)

__all__ = ["pad_table_for_sharding", "brick_encode_table_sharded"]


def pad_table_for_sharding(table: torch.Tensor,
                           n_shards: int) -> torch.Tensor:
    """Pad rows up to a multiple of n_shards (padding rows are never
    addressed: row indices stay < meta.total_rows)."""
    rows = table.shape[0]
    target = -(-rows // n_shards) * n_shards
    if target != rows:
        table = F.pad(table, (0, 0, 0, target - rows))
    return table


def _local_contribution(x: torch.Tensor, tshard: torch.Tensor,
                        meta: BrickMeta, shard_idx: int) -> torch.Tensor:
    """Features from the rows this shard owns ([N, 2L]); rows owned
    elsewhere contribute exact zeros."""
    rows_local = tshard.shape[0]
    base = shard_idx * rows_local
    bits = _corner_bits(x.device)
    corner_off = ((bits[:, 0] * BRICK_W + bits[:, 1]) * BRICK_W
                  + bits[:, 2]) * N_FEAT                              # [8]
    outs = []
    for level in meta.levels:
        row, lane0, frac = _level_rows_and_lanes(x, level)
        local = row - base
        ok = (local >= 0) & (local < rows_local)
        rows = tshard[local.clamp(0, rows_local - 1)]
        rows = torch.where(ok[:, None], rows, 0.0)
        lanes = lane0[:, None] + corner_off[None, :]
        f0 = torch.gather(rows, 1, lanes)
        f1 = torch.gather(rows, 1, lanes + 1)
        w = _corner_weights(frac).to(rows.dtype)
        outs.append(torch.sum(w * f0, -1))
        outs.append(torch.sum(w * f1, -1))
    return torch.stack(outs, -1)


def brick_encode_table_sharded(x: torch.Tensor, table_sharded: torch.Tensor,
                               meta: BrickMeta, mesh,
                               model_axis: str = "model") -> torch.Tensor:
    """F=2 brick encode with the table's rows split over `model_axis`.

    x [N, 3]: this rank's points; table_sharded: the padded full table
    ([rows, 128], see `pad_table_for_sharding`; this rank uses its rows)
    or a `DTensor` sharded `Shard(0)` over `model_axis`. Returns [N, 2L],
    differentiable in both arguments.
    """
    tl = local_rows(table_sharded, mesh, model_axis)
    part = _local_contribution(x, tl, meta,
                               mesh.get_local_rank(model_axis))
    return sum_over_group(part, mesh.get_group(model_axis))
