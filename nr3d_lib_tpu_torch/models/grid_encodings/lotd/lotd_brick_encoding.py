"""LoTDBrickEncoding — module wrapper over the brick-layout encoding.

Port of nr3d_lib_tpu/models/grid_encodings/lotd/lotd_brick_encoding.py for
`n_feats=4` (the bf16-packed `ops/lotd_brick4.py`). Same [-1,1] input
convention and feature layout.

Parameters:
  * dense levels: canonical vertex grids (C0-tied, exactly reference Dense);
  * hash levels: brick rows directly.
Stored as one flattened vector, `flattened_params`, in the JAX package's
layout, so the state bridge copies it as it is.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
from nr3d_lib_tpu_torch.ops.lotd_brick import LANES

__all__ = ["LoTDBrickEncoding"]


class LoTDBrickEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *, lod_res: Sequence,
                 lod_types: Sequence[str], hashmap_rows: int = 4096,
                 n_feats: int = 4, param_init_std: float = 1e-4,
                 seed: int = 42, device=None):
        super().__init__()
        if input_ch != 3:
            raise ValueError("brick backend is 3D")
        if n_feats != 4:
            raise NotImplementedError(
                "only the F=4 brick path is ported; F=2 waits in ROADMAP.md")
        self.n_feats = n_feats
        self.meta = B4.make_brick4_meta(lod_res, lod_types, hashmap_rows)
        self.in_features = 3
        self.out_features = 4 * self.meta.n_levels
        row_width = 2 * LANES

        # canonical parameter layout: [dense vertex grids..., hash rows...]
        sizes: List[int] = []
        for lv in self.meta.levels:
            if lv.kind == "dense":
                sizes.append(int(np.prod(lv.res)) * n_feats)
            else:
                sizes.append(lv.n_rows * row_width)
        self._param_offsets = tuple(int(v) for v in np.cumsum([0] + sizes))
        # dense-level gather indices, kept on the device (not state)
        for i, lv in enumerate(self.meta.levels):
            if lv.kind == "dense":
                self.register_buffer(
                    f"_dense_idx{i}", torch.as_tensor(
                        B4.dense_brick4_index(lv), device=device),
                    persistent=False)
        gen = torch.Generator().manual_seed(seed)
        init = torch.rand(self._param_offsets[-1], generator=gen)
        self.flattened_params = nn.Parameter(
            ((init * 2.0 - 1.0) * param_init_std).to(device))

    @property
    def n_params(self) -> int:
        return self._param_offsets[-1]

    def level_params(self, i: int) -> torch.Tensor:
        o = self._param_offsets
        return self.flattened_params[o[i]:o[i + 1]]

    def _build_table(self) -> torch.Tensor:
        """Materialize the unpacked [total_rows, 256] brick table (dense
        boundary vertices stay tied)."""
        rows = []
        for i, lv in enumerate(self.meta.levels):
            p = self.level_params(i)
            if lv.kind == "dense":
                rows.append(p[getattr(self, f"_dense_idx{i}")])
            else:
                rows.append(p.reshape(lv.n_rows, 2 * LANES))
        return torch.cat(rows, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x in [-1,1] → [N, 4L] (kernel space is [0,1])."""
        return B4.brick4_encode(x * 0.5 + 0.5, self._build_table(), self.meta)

    def nablas_path(self, x: torch.Tensor, g_up: torch.Tensor
                    ) -> torch.Tensor:
        """J_enc(x)ᵀ·g_up in the module's [-1,1] input convention; the 0.5
        folds the [-1,1]→[0,1] input rescale into the chain rule."""
        return 0.5 * B4.brick4_nablas(g_up, x * 0.5 + 0.5,
                                      self._build_table(), self.meta)
