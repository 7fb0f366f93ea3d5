"""PermutoParams — a permutohedral table with its meta and encode (port of
nr3d_lib_tpu/models/grid_encodings/permuto/permuto_encoding.py
`PermutoParams`, the shared backbone of the permuto-based fields).

Ported: `backend="cell"`, the cell layout, with
  * `n_feats=2` (the default, as in JAX): an f32 [rows, 128] table, 2L
    outputs, `ops/permuto_cell.py` (CUDA kernels B10–B13);
  * `n_feats=4`: the bf16-packed layout, an unpacked f32 [rows, 256]
    table, 4L outputs, `ops/permuto_cell4.py` (CUDA kernels B14–B16).
The classic lattice (`backend="xla"`, `ops/permuto.py`) raises until it is
ported (ROADMAP.md A10c). Inputs are in the lattice's [0,1] space.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nr3d_lib_tpu_torch.ops import permuto_cell as PC
from nr3d_lib_tpu_torch.ops import permuto_cell4 as PC4

__all__ = ["PermutoParams"]

# n_feats → (plain encode, encode, frozen-x encode, nablas)
_OPS = {2: (PC.permuto_cell_encode_xla, PC.permuto_cell_encode,
            PC.permuto_cell_encode_frozen_x, PC.permuto_cell_nablas),
        4: (PC4.permuto_cell4_encode_xla, PC4.permuto_cell4_encode,
            PC4.permuto_cell4_encode_frozen_x, PC4.permuto_cell4_nablas)}


class PermutoParams(nn.Module):
    def __init__(self, n_dims: int, res_list: Sequence, *,
                 n_feats: int = 2, backend: str = "xla",
                 hashmap_rows: int = 4096,
                 auto_dense: bool = True, param_init_std: float = 1e-4,
                 seed: int = 0, device=None):
        super().__init__()
        if backend != "cell":
            raise NotImplementedError(
                f"permuto backend {backend!r} (the classic lattice) is not "
                f"ported yet: only 'cell' is (ROADMAP.md A10c)")
        if n_feats not in _OPS:
            raise ValueError(f"the cell backend packs 2 or 4 features per "
                             f"vertex, got n_feats={n_feats}")
        self.backend, self.n_feats = backend, n_feats
        self.meta = PC.make_permuto_cell_meta(n_dims, res_list, hashmap_rows,
                                              auto_dense)
        self.out_features = n_feats * self.meta.n_levels
        gen = torch.Generator().manual_seed(seed)
        init = torch.rand((self.meta.total_rows, PC.LANES * n_feats // 2),
                          generator=gen)
        self.flattened_params = nn.Parameter(
            ((init * 2.0 - 1.0) * param_init_std).to(device))

    def encode(self, inp: torch.Tensor, frozen_x: bool = False,
               ho: bool = False) -> torch.Tensor:
        """inp [..., d] → [..., F·L]: on a CUDA tensor the forward kernel
        (B10 or B14), with the backward kernel (B11/B12 or B15) as its
        backward (`frozen_x`: dL/dtable only). `ho=True` asks for the
        any-order plain formulation, which the JAX package routes to XLA;
        it exists for CPU tensors only (the CUDA route differentiates the
        nablas through `nablas`)."""
        plain, enc, enc_frozen, _ = _OPS[self.n_feats]
        p = self.flattened_params
        batch = inp.shape[:-1]
        flat = inp.reshape(-1, inp.shape[-1])
        if ho:
            if flat.device.type != "cpu":
                raise NotImplementedError(
                    "encode(ho=True) is the plain formulation: on CUDA, "
                    "differentiate the nablas through PermutoParams.nablas")
            y = plain(flat, p, self.meta)
        elif frozen_x:
            y = enc_frozen(flat, p, self.meta)
        else:
            y = enc(flat, p, self.meta)
        return y.reshape(*batch, y.shape[-1])

    def nablas(self, g_up: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """J_enc(inp)ᵀ·g_up in the lattice's [0,1] space (B13 or B16 on
        CUDA; its backward is the plain vjp)."""
        batch = inp.shape[:-1]
        flat = inp.reshape(-1, inp.shape[-1])
        nab = _OPS[self.n_feats][3](g_up.reshape(-1, g_up.shape[-1]), flat,
                                    self.flattened_params, self.meta)
        return nab.reshape(*batch, nab.shape[-1])
