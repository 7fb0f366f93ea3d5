"""Occupancy-grid state (port of nr3d_lib_tpu/models/accelerations/
occgrid.py): `OccGridEma`, the EMA-decayed value grid thresholded to a
binary occupancy, and `OccGridGetter`, a binary grid re-queried whole at
every update; `cell_centers`, `sample_cells_uniform`.

The periodic update is split in two so that a test can feed the JAX
package's cells and points to the second half: `sample_update_cells` draws
the cells and points to re-query (torch cannot reproduce `jax.random`),
and `apply_update` decays the grid and scatter-maxes the fresh values in.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.ops.occgrid_march import occgrid_query
from nr3d_lib_tpu_torch.profile import count_sync

__all__ = ["OccGridEma", "OccGridGetter", "cell_centers",
           "sample_cells_uniform"]


def cell_centers(resolution: Sequence[int], dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Normalized [-1,1]^3 centers of all cells → [prod(res), 3]."""
    lins = [(torch.arange(r, dtype=dtype, device=device) + 0.5) / r * 2.0
            - 1.0 for r in resolution]
    grid = torch.stack(torch.meshgrid(*lins, indexing="ij"), -1)
    return grid.reshape(-1, len(resolution))


def _cell_points(idx: torch.Tensor, resolution: Sequence[int],
                 generator: torch.Generator) -> torch.Tensor:
    """A uniform point inside each cell idx [n,3] → x [n,3] in [-1,1]."""
    count_sync()        # the resolution's copy to the card waits for it
    res = torch.as_tensor(resolution, dtype=torch.float32, device=idx.device)
    u = torch.rand(idx.shape, generator=generator, device=idx.device)
    return (idx.to(torch.float32) + u) / res * 2.0 - 1.0


def sample_cells_uniform(generator: torch.Generator,
                         resolution: Sequence[int], n: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n uniformly random cells + a uniform point inside each → (cell_idx
    [n,3] int64, x [n,3]), on the generator's device."""
    dev = generator.device
    idx = torch.stack([torch.randint(0, r, (n,), generator=generator,
                                     device=dev) for r in resolution], -1)
    return idx, _cell_points(idx, resolution, generator)


class OccGridEma(nn.Module):
    """EMA-decayed value grid thresholded to binary occupancy. State: the
    buffers ``val_grid`` (the values) and ``it`` (update count)."""

    def __init__(self, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 ema_decay: float = 0.95, device=None):
        super().__init__()
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.ema_decay = float(ema_decay)
        self.register_buffer("val_grid", torch.ones(
            self.resolution, dtype=torch.float32, device=device))
        self.register_buffer("it", torch.zeros((), dtype=torch.int32,
                                               device=device))

    def occ(self) -> torch.Tensor:
        return self.val_grid > self.occ_thre

    def occupancy_ratio(self) -> torch.Tensor:
        """The occupied share of the cells, a 0-d float32 tensor."""
        return self.occ().to(torch.float32).mean()

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """Occupancy at normalized positions x ∈ [-1,1]^3 (B5 on a CUDA
        grid); out-of-range positions are unoccupied."""
        return occgrid_query(self.occ(), x)

    def init_from_net(self, query_fn: Callable[[torch.Tensor], torch.Tensor],
                      chunk: int = 2 ** 16) -> None:
        """Initialize the values from a field query at the cell centers.
        Updates the buffer in place."""
        centers = cell_centers(self.resolution, self.val_grid.dtype,
                               self.val_grid.device)
        vals = _chunked_query(query_fn, centers, chunk)
        self.val_grid.copy_(vals.reshape(self.resolution))

    @torch.no_grad()
    def collect_samples(self, x: torch.Tensor, vals: torch.Tensor) -> None:
        """Scatter-max |vals| of training-time queries at normalized
        positions x [..., 3] into their cells; positions outside the grid
        contribute nothing (−inf). The max does not depend on the order
        of the points. In place."""
        res = self.resolution
        x = x.reshape(-1, 3)
        idx = torch.stack([torch.floor((x[:, a] + 1.0) * 0.5 * float(res[a]))
                           .to(torch.int64) for a in range(3)], -1)
        hi = torch.as_tensor(res, device=idx.device)
        inb = ((idx >= 0) & (idx < hi)).all(-1)
        idx = torch.minimum(idx.clamp(min=0), hi - 1)
        vals = torch.where(inb, torch.abs(vals.reshape(-1)).to(
            self.val_grid.dtype), float("-inf"))
        flat = (idx[:, 0] * res[1] + idx[:, 1]) * res[2] + idx[:, 2]
        self.val_grid.view(-1).scatter_reduce_(0, flat, vals, reduce="amax")

    def sample_update_cells(self, generator: torch.Generator,
                            n_samples: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The cells to re-query: n uniform cells, then n cells drawn with
        replacement from the occupied ones (uniform over all cells when none
        is occupied), a uniform point inside each → (idx [2n,3], x [2n,3]).
        n defaults to a quarter of the cells."""
        n = n_samples or max(int(np.prod(self.resolution)) // 4, 1)
        idx_u, x_u = sample_cells_uniform(generator, self.resolution, n)
        occ_flat = self.occ().reshape(-1).to(torch.float32)
        weights = torch.where(occ_flat.any(), occ_flat,
                              torch.ones_like(occ_flat))
        flat = torch.multinomial(weights.to(generator.device), n,
                                 replacement=True, generator=generator)
        r1, r2 = self.resolution[1], self.resolution[2]
        idx_o = torch.stack([flat // (r1 * r2), (flat // r2) % r1, flat % r2],
                            -1)
        x_o = _cell_points(idx_o, self.resolution, generator)
        dev = self.val_grid.device
        return (torch.cat([idx_u, idx_o], 0).to(dev),
                torch.cat([x_u, x_o], 0).to(dev))

    def apply_update(self, idx: torch.Tensor, x: torch.Tensor,
                     query_fn: Callable[[torch.Tensor], torch.Tensor]
                     ) -> None:
        """Decay every value by `ema_decay`, then scatter-max |query_fn(x)|
        into the cells idx [n,3]; count the update. In place."""
        fresh = torch.abs(query_fn(x)).reshape(-1).to(self.val_grid.dtype)
        r1, r2 = self.resolution[1], self.resolution[2]
        flat = (idx[:, 0] * r1 + idx[:, 1]) * r2 + idx[:, 2]
        grid = (self.val_grid * self.ema_decay).reshape(-1)
        grid.scatter_reduce_(0, flat.to(torch.int64), fresh, reduce="amax")
        self.val_grid.copy_(grid.reshape(self.resolution))
        self.it.add_(1)

    def step_update(self, query_fn: Callable[[torch.Tensor], torch.Tensor],
                    generator: torch.Generator,
                    n_samples: Optional[int] = None) -> None:
        """The periodic EMA update: decay everything, then re-query random
        and occupied cells so that live cells never decay away."""
        self.apply_update(*self.sample_update_cells(generator, n_samples),
                          query_fn)

    def try_shrink(self) -> torch.Tensor:
        """The tight normalized box [2, 3] (min, max) of the occupied
        cells. With no cell occupied, each axis reads (1, −1)."""
        occ = self.occ()
        out = []
        for d in range(3):
            axes = tuple(i for i in range(3) if i != d)
            any_d = occ.any(dim=axes[1]).any(dim=axes[0])
            r = self.resolution[d]
            idxs = torch.arange(r, device=occ.device)
            lo = torch.where(any_d, idxs, r).amin()
            hi = torch.where(any_d, idxs, -1).amax() + 1
            out.append(torch.stack([lo, hi]).to(torch.float32) / r * 2 - 1)
        return torch.stack(out).T


class OccGridGetter(nn.Module):
    """A binary occupancy grid without EMA: each update re-queries every
    cell centre and thresholds |value|. State: the bool buffer
    ``occ_grid`` (all occupied at construction)."""

    def __init__(self, resolution=(64, 64, 64), occ_thre: float = 0.01,
                 device=None):
        super().__init__()
        if np.isscalar(resolution):
            resolution = (int(resolution),) * 3
        self.resolution = tuple(int(r) for r in resolution)
        self.occ_thre = float(occ_thre)
        self.register_buffer("occ_grid", torch.ones(
            self.resolution, dtype=torch.bool, device=device))

    def occ(self) -> torch.Tensor:
        return self.occ_grid

    @torch.no_grad()
    def update(self, query_fn: Callable[[torch.Tensor], torch.Tensor],
               chunk: int = 2 ** 16) -> None:
        """Re-query every cell centre in chunks of `chunk` points; a cell
        is occupied where |value| > occ_thre. In place."""
        centers = cell_centers(self.resolution, torch.float32,
                               self.occ_grid.device)
        vals = _chunked_query(query_fn, centers, chunk)
        self.occ_grid.copy_(torch.abs(vals).reshape(self.resolution)
                            > self.occ_thre)


def _chunked_query(query_fn, pts: torch.Tensor, chunk: int) -> torch.Tensor:
    """query_fn over pts [n, 3] in chunks of at most `chunk` → [n]."""
    return torch.cat([query_fn(pts[s:s + chunk]).reshape(-1)
                      for s in range(0, pts.shape[0], chunk)])
