"""Occupancy-grid state: value grid → binary occupancy (port of
nr3d_lib_tpu/models/accelerations/occgrid.py `OccGridEma`: `occ`,
`init_from_net` and `cell_centers`; the training-time EMA update and
sample collection are slice 2)."""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["OccGridEma", "cell_centers"]


def cell_centers(resolution: Sequence[int], dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Normalized [-1,1]^3 centers of all cells → [prod(res), 3]."""
    lins = [(torch.arange(r, dtype=dtype, device=device) + 0.5) / r * 2.0
            - 1.0 for r in resolution]
    grid = torch.stack(torch.meshgrid(*lins, indexing="ij"), -1)
    return grid.reshape(-1, len(resolution))


class OccGridEma(nn.Module):
    """Value grid thresholded to binary occupancy. State: the buffers
    ``val_grid`` (the values) and ``it`` (update count)."""

    def __init__(self, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 device=None):
        super().__init__()
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.register_buffer("val_grid", torch.ones(
            self.resolution, dtype=torch.float32, device=device))
        self.register_buffer("it", torch.zeros((), dtype=torch.int32,
                                               device=device))

    def occ(self) -> torch.Tensor:
        return self.val_grid > self.occ_thre

    def init_from_net(self, query_fn: Callable[[torch.Tensor], torch.Tensor],
                      chunk: int = 2 ** 16) -> None:
        """Initialize the values from a field query at the cell centers.
        Updates the buffer in place."""
        centers = cell_centers(self.resolution, self.val_grid.dtype,
                               self.val_grid.device)
        vals = torch.cat([query_fn(centers[s:s + chunk]).reshape(-1)
                          for s in range(0, centers.shape[0], chunk)])
        self.val_grid.copy_(vals.reshape(self.resolution))
