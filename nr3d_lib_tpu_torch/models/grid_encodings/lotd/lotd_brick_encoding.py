"""LoTDBrickEncoding — module wrapper over the brick-layout encoding.

Port of nr3d_lib_tpu/models/grid_encodings/lotd/lotd_brick_encoding.py:
`n_feats=2` (the default, `ops/lotd_brick.py`, an f32 [rows, 128] table)
and `n_feats=4` (the bf16-packed `ops/lotd_brick4.py`, an unpacked f32
[rows, 256] table). Same [-1,1] input convention and feature layout.

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

from nr3d_lib_tpu_torch.ops import lotd_brick as B
from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

__all__ = ["LoTDBrickEncoding"]


class LoTDBrickEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *, lod_res: Sequence,
                 lod_types: Sequence[str], hashmap_rows: int = 4096,
                 n_feats: int = 2, param_init_std: float = 1e-4,
                 seed: int = 42, device=None):
        super().__init__()
        if input_ch != 3:
            raise ValueError("brick backend is 3D")
        if n_feats not in (2, 4):
            raise ValueError(f"brick backend takes n_feats 2 or 4, got "
                             f"{n_feats}")
        self.n_feats = n_feats
        if n_feats == 4:
            self.meta = B4.make_brick4_meta(lod_res, lod_types, hashmap_rows)
        else:
            self.meta = B.make_brick_meta(lod_res, lod_types, hashmap_rows)
        self.in_features = 3
        self.out_features = n_feats * self.meta.n_levels
        self._row_width = B.LANES * (n_feats // 2)

        # canonical parameter layout: [dense vertex grids..., hash rows...]
        sizes: List[int] = []
        for lv in self.meta.levels:
            if lv.kind == "dense":
                sizes.append(int(np.prod(lv.res)) * n_feats)
            else:
                sizes.append(lv.n_rows * self._row_width)
        self._param_offsets = tuple(int(v) for v in np.cumsum([0] + sizes))
        # dense-level gather indices, kept on the device (not state)
        for i, lv in enumerate(self.meta.levels):
            if lv.kind == "dense":
                idx = B4.dense_brick4_index(lv) if n_feats == 4 else \
                    B.vertex_grid_to_brick_rows(lv).astype(np.int64)
                self.register_buffer(
                    f"_dense_idx{i}", torch.as_tensor(idx, device=device),
                    persistent=False)
        gen = torch.Generator().manual_seed(seed)
        init = torch.rand(self._param_offsets[-1], generator=gen)
        self.flattened_params = nn.Parameter(
            ((init * 2.0 - 1.0) * param_init_std).to(device))

    def set_anneal_iter(self, it: int) -> None:
        """No anneal window on the brick backend (the JAX package patches
        the same no-op onto it)."""

    @property
    def n_params(self) -> int:
        return self._param_offsets[-1]

    def level_params(self, i: int) -> torch.Tensor:
        o = self._param_offsets
        return self.flattened_params[o[i]:o[i + 1]]

    def _build_table(self) -> torch.Tensor:
        """Materialize the [total_rows, 128·(n_feats//2)] brick table (F=4:
        unpacked); dense boundary vertices stay tied."""
        rows = []
        for i, lv in enumerate(self.meta.levels):
            p = self.level_params(i)
            if lv.kind == "dense":
                rows.append(p[getattr(self, f"_dense_idx{i}")])
            else:
                rows.append(p.reshape(lv.n_rows, self._row_width))
        return torch.cat(rows, 0)

    def forward(self, x: torch.Tensor, ho: bool = False,
                frozen_x: bool = False) -> torch.Tensor:
        """x in [-1,1] → [N, n_feats·L] (kernel space is [0,1]).
        `frozen_x=True`: positions carry no gradient (plain radiance-field
        training), so the backward computes dL/dtable only."""
        if ho:
            raise NotImplementedError(
                "the higher-order brick encode (ho=True) is not ported yet "
                "(ROADMAP.md A8b); the nablas path is differentiable twice")
        x01 = x * 0.5 + 0.5
        table = self._build_table()
        if self.n_feats == 4:
            return B4.brick4_encode(x01.detach() if frozen_x else x01, table,
                                    self.meta)
        if frozen_x:
            return B.brick_encode_frozen_x(x01, table, self.meta)
        return B.brick_encode(x01, table, self.meta)

    def nablas_path(self, x: torch.Tensor, g_up: torch.Tensor
                    ) -> torch.Tensor:
        """J_enc(x)ᵀ·g_up in the module's [-1,1] input convention; the 0.5
        folds the [-1,1]→[0,1] input rescale into the chain rule."""
        nablas = B4.brick4_nablas if self.n_feats == 4 else B.brick_nablas
        return 0.5 * nablas(g_up, x * 0.5 + 0.5, self._build_table(),
                            self.meta)
