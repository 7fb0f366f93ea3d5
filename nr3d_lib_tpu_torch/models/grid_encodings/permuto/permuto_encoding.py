"""PermutoParams — a permutohedral table with its meta and encode — and
the PermutoEncoding module (port of nr3d_lib_tpu/models/grid_encodings/
permuto/permuto_encoding.py `PermutoParams`, the shared backbone of the
permuto-based fields, and `PermutoEncoding`).

`PermutoParams` backends:
  * `backend="xla"` (the default, as in JAX): the classic lattice,
    `ops/permuto.py`, a flat [n_params] table of 2^log2_hashmap_size rows
    a level, d+1 gathers a (point, level), plain PyTorch on any device
    (the JAX package computes it in XLA, with no Pallas kernel), any
    order of derivative by autograd;
  * `backend="cell"`, the cell layout, with `n_feats=2`: an f32 [rows,
    128] table, 2L outputs, `ops/permuto_cell.py` (CUDA kernels B10–B13);
    `n_feats=4`: the bf16-packed layout, an unpacked f32 [rows, 256]
    table, 4L outputs, `ops/permuto_cell4.py` (CUDA kernels B14–B16).
Inputs are in the lattice's [0,1] space.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.annealers import MultiresAnnealer
from nr3d_lib_tpu_torch.ops import permuto as P
from nr3d_lib_tpu_torch.ops import permuto_cell as PC
from nr3d_lib_tpu_torch.ops import permuto_cell4 as PC4

__all__ = ["PermutoParams", "PermutoEncoding"]

# n_feats → (plain encode, encode, frozen-x encode, nablas)
_OPS = {2: (PC.permuto_cell_encode_xla, PC.permuto_cell_encode,
            PC.permuto_cell_encode_frozen_x, PC.permuto_cell_nablas),
        4: (PC4.permuto_cell4_encode_xla, PC4.permuto_cell4_encode,
            PC4.permuto_cell4_encode_frozen_x, PC4.permuto_cell4_nablas)}


def _uniform_init(shape, param_init_std: float, seed: int, device):
    """U(−std, std) from a seeded generator (the values do not match JAX's
    random bits; tests carry tables across by the state bridge)."""
    gen = torch.Generator().manual_seed(seed)
    init = torch.rand(shape, generator=gen)
    return nn.Parameter(((init * 2.0 - 1.0) * param_init_std).to(device))


class PermutoParams(nn.Module):
    def __init__(self, n_dims: int, res_list: Sequence, *,
                 n_feats: int = 2, log2_hashmap_size: int = 18,
                 backend: str = "xla", hashmap_rows: int = 4096,
                 auto_dense: bool = True, param_init_std: float = 1e-4,
                 seed: int = 0, device=None):
        super().__init__()
        if backend not in ("xla", "cell"):
            raise ValueError(f"unknown permuto backend {backend!r}")
        self.backend, self.n_feats = backend, n_feats
        if backend == "xla":
            self.meta = P.make_permuto_meta(n_dims, res_list, n_feats,
                                            log2_hashmap_size)
            self.out_features = self.meta.out_features
            self.flattened_params = _uniform_init(
                (self.meta.n_params,), param_init_std, seed, device)
            return
        if n_feats not in _OPS:
            raise ValueError(f"the cell backend packs 2 or 4 features per "
                             f"vertex, got n_feats={n_feats}")
        self.meta = PC.make_permuto_cell_meta(n_dims, res_list, hashmap_rows,
                                              auto_dense)
        self.out_features = n_feats * self.meta.n_levels
        self.flattened_params = _uniform_init(
            (self.meta.total_rows, PC.LANES * n_feats // 2), param_init_std,
            seed, device)

    def forward(self, x: torch.Tensor, frozen_x: bool = False,
                ho: bool = False, **kw) -> torch.Tensor:
        """x [..., d] → [..., F·L]: the brick encoding's entry point, x
        first; `encode` is the JAX package's name for it. The classic
        lattice (`xla`) is plain PyTorch on any device and differentiable
        to any order; `kw` (`level_weights`, `max_level`) reach
        `ops.permuto.permuto_encode`, and `frozen_x`/`ho` change nothing
        there, as in JAX. The cell backend: on a CUDA tensor the forward
        kernel (B10 or B14), with the backward kernel (B11/B12 or B15) as
        its backward (`frozen_x`: dL/dtable only). `ho=True` asks for the
        any-order plain formulation, which the JAX package routes to XLA:
        plain PyTorch on the tensor's own device, as the brick encoding's
        `ho`."""
        p = self.flattened_params
        batch = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        if self.backend == "xla":
            y = P.permuto_encode(flat, p, self.meta, **kw)
            return y.reshape(*batch, y.shape[-1])
        plain, enc, enc_frozen, _ = _OPS[self.n_feats]
        if ho:
            y = plain(flat, p, self.meta)
        elif frozen_x:
            y = enc_frozen(flat, p, self.meta)
        else:
            y = enc(flat, p, self.meta)
        return y.reshape(*batch, y.shape[-1])

    encode = forward

    def nablas_path(self, x: torch.Tensor, g_up: torch.Tensor
                    ) -> torch.Tensor:
        """J_enc(x)ᵀ·g_up in the lattice's [0,1] space (B13 or B16 on
        CUDA; its backward is the plain vjp), x first as the brick
        encoding's entry point. Cell backends only, as in JAX: the
        classic lattice differentiates `forward` instead."""
        if self.backend != "cell":
            raise ValueError("PermutoParams.nablas is the cell backends' "
                             "nablas kernel; differentiate encode() on the "
                             "classic lattice")
        batch = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1])
        nab = _OPS[self.n_feats][3](g_up.reshape(-1, g_up.shape[-1]), flat,
                                    self.flattened_params, self.meta)
        return nab.reshape(*batch, nab.shape[-1])

    def nablas(self, g_up: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """`nablas_path` in the JAX package's argument order."""
        return self.nablas_path(inp, g_up)


class PermutoEncoding(nn.Module):
    """A classic-lattice encoding over inputs in [−1,1]^D (mapped to the
    lattice's [0,1] space), with its own flat table, an optional
    coarse-to-fine anneal (`anneal_cfg`, `MultiresAnnealer`: a hard
    `max_level` or a cosine window of level weights) and the
    forward-mode Jacobian (`forward_dydx`)."""

    def __init__(self, input_ch: int = 3, *, coarsest_res: float = 16.0,
                 finest_res: float = 2048.0, n_levels: int = 16,
                 n_feats: int = 2, log2_hashmap_size: int = 18,
                 res_list: Optional[Sequence] = None,
                 anneal_cfg: Optional[dict] = None,
                 param_init_std: float = 1e-4, seed: int = 42,
                 device=None):
        super().__init__()
        if res_list is None:
            growth = (finest_res / coarsest_res) ** (1.0 / max(n_levels - 1,
                                                               1))
            res_list = [coarsest_res * growth ** l for l in range(n_levels)]
        self.meta = P.make_permuto_meta(input_ch, res_list, n_feats,
                                        log2_hashmap_size)
        self.in_features = input_ch
        self.out_features = self.meta.out_features
        self.flattened_params = _uniform_init(
            (self.meta.n_params,), param_init_std, seed, device)
        self.annealer = MultiresAnnealer(self.meta.n_levels, **anneal_cfg) \
            if anneal_cfg else None
        self.max_level: Optional[int] = None
        self.level_weights: Optional[torch.Tensor] = None

    def set_anneal_iter(self, it: int) -> None:
        if self.annealer is not None:
            self.max_level, w = self.annealer(it)
            self.level_weights = None if w is None else torch.as_tensor(
                w, device=self.flattened_params.device)

    def forward(self, x: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        ml = max_level if max_level is not None else self.max_level
        return P.permuto_encode(x * 0.5 + 0.5, self.flattened_params,
                                self.meta, level_weights=self.level_weights,
                                max_level=ml)

    def forward_dydx(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y, dy/dx [N, F, D]) in the module's [−1,1] input convention
        (the 0.5 of x·0.5 + 0.5 folded in)."""
        y, dydx = P.permuto_enc_fwd_dydx(
            x * 0.5 + 0.5, self.flattened_params, self.meta,
            level_weights=self.level_weights, max_level=self.max_level)
        return y, dydx * 0.5

    def backward_dydx(self, dL_dy: torch.Tensor, dy_dx: torch.Tensor,
                      x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return P.permuto_enc_bwd_dydx(dL_dy, dy_dx)
