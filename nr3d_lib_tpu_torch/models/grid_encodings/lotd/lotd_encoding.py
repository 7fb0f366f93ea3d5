"""LoTDEncoding — the module over the classic LoTD encoding (port of
nr3d_lib_tpu/models/grid_encodings/lotd/lotd_encoding.py).

It owns the flat parameter vector `flattened_params` [n_params] in the
JAX package's layout (so the state bridge copies it as it is), maps
inputs in [-1,1] to the encoding's [0,1], and applies the progressive
`max_level` mask and the anneal window of its `MultiresAnnealer`.
`param_dtype` is the parameters' dtype; the forward casts them to
`compute_dtype` (float32 by default; with bfloat16 the features come out
in bfloat16, as in JAX). A dtype is a `torch.dtype` or its name.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.models.annealers import MultiresAnnealer
from nr3d_lib_tpu_torch.models.blocks import as_dtype
from nr3d_lib_tpu_torch.ops import lotd as _lotd

__all__ = ["LoTDEncoding"]


class LoTDEncoding(nn.Module):
    def __init__(self, input_ch: int = 3, *,
                 lotd_cfg: Optional[dict] = None,
                 lotd_auto_compute_cfg: Optional[dict] = None,
                 anneal_cfg: Optional[dict] = None,
                 param_init_cfg: Optional[dict] = None,
                 compute_dtype=torch.float32, param_dtype=torch.float32,
                 seed: int = 42, aabb=None, device=None):
        super().__init__()
        if lotd_auto_compute_cfg is not None:
            from nr3d_lib_tpu_torch.models.grid_encodings.lotd.lotd_cfg \
                import get_lotd_cfg

            stretch = (np.asarray(aabb[1]) - np.asarray(aabb[0])) \
                if aabb is not None else np.ones(input_ch) * 2.0
            lotd_cfg = get_lotd_cfg(input_ch=input_ch, stretch=stretch,
                                    **lotd_auto_compute_cfg)
        if lotd_cfg is None:
            raise ValueError("need lotd_cfg or lotd_auto_compute_cfg")
        lotd_cfg = dict(lotd_cfg)
        self.meta = _lotd.generate_meta(
            input_ch, lotd_cfg["lod_res"], lotd_cfg.get("lod_n_feats", 2),
            lotd_cfg.get("lod_types", "Dense"),
            hashmap_size=lotd_cfg.get("hashmap_size"),
            use_smooth_step=lotd_cfg.get("use_smooth_step", False))
        self.in_features = input_ch
        self.out_features = self.meta.out_features
        self.compute_dtype = as_dtype(compute_dtype)

        # small random init, uniform in ±bound or normal with std
        cfg = dict(param_init_cfg or {})
        method = cfg.get("method", "uniform")
        scale = float(cfg.get("bound", cfg.get("std", 1e-4)))
        gen = torch.Generator().manual_seed(seed)
        if method == "normal":
            p0 = scale * torch.randn(self.meta.n_params, generator=gen)
        else:
            p0 = (torch.rand(self.meta.n_params, generator=gen) * 2.0
                  - 1.0) * scale
        self.flattened_params = nn.Parameter(p0.to(
            device=device, dtype=as_dtype(param_dtype)))

        self.annealer = MultiresAnnealer(self.meta.n_levels, **anneal_cfg) \
            if anneal_cfg else None
        self.max_level: Optional[int] = None     # host-side override
        self.level_weights: Optional[torch.Tensor] = None  # [L] window

    # ----------------------------------------------------------- lifecycle
    def set_anneal_iter(self, it: int) -> None:
        """max_level and the window at iteration `it`, from the annealer."""
        if self.annealer is not None:
            self.max_level, w = self.annealer(it)
            self.level_weights = None if w is None else torch.as_tensor(
                w, device=self.flattened_params.device)

    # ------------------------------------------------------------- forward
    def _params(self) -> torch.Tensor:
        return self.flattened_params.to(self.compute_dtype)

    def forward(self, x: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        """x in [-1,1] → [N, out_features]."""
        ml = max_level if max_level is not None else self.max_level
        return _lotd.lotd_encode(x * 0.5 + 0.5, self._params(),
                                 self.meta, max_level=ml,
                                 level_weights=self.level_weights)

    def forward_dydx(self, x: torch.Tensor, max_level: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features, dy/dx in the [-1,1] input frame: × 0.5 for the
        x·0.5 + 0.5 map)."""
        ml = max_level if max_level is not None else self.max_level
        y, dydx = _lotd.lotd_fwd_dydx(x * 0.5 + 0.5, self._params(),
                                      self.meta, max_level=ml,
                                      level_weights=self.level_weights)
        return y, dydx * 0.5

    def backward_dydx(self, dL_dy: torch.Tensor, dy_dx: torch.Tensor,
                      x: Optional[torch.Tensor] = None) -> torch.Tensor:
        """nablas in the [-1,1] frame (dy_dx from `forward_dydx`)."""
        return _lotd.lotd_bwd_dydx(dL_dy, dy_dx)

    # ------------------------------------------------------- level access
    def get_level_param(self, level: int) -> torch.Tensor:
        return self.flattened_params[_lotd.level_param_slice(self.meta,
                                                             level)]

    @torch.no_grad()
    def set_level_param(self, level: int, value: torch.Tensor) -> None:
        sl = _lotd.level_param_slice(self.meta, level)
        self.flattened_params[sl] = value.reshape(-1).to(
            self.flattened_params)
