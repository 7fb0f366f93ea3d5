"""PermutoParams — a permutohedral table with its meta and encode (port of
nr3d_lib_tpu/models/grid_encodings/permuto/permuto_encoding.py
`PermutoParams`, the shared backbone of the permuto-based fields).

Ported: `backend="cell"` with `n_feats=4`, the bf16-packed cell layout
(`ops/permuto_cell4.py`, an unpacked f32 [rows, 256] table, CUDA kernels
B14–B16). The F=2 cell layout and the classic lattice (`backend="xla"`)
raise until they are ported (ROADMAP.md A10b, A9). Inputs are in the
lattice's [0,1] space.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from nr3d_lib_tpu_torch.ops import permuto_cell4 as PC4

__all__ = ["PermutoParams"]


class PermutoParams(nn.Module):
    def __init__(self, n_dims: int, res_list: Sequence, *,
                 n_feats: int = 2, backend: str = "xla",
                 hashmap_rows: int = 4096,
                 auto_dense: bool = True, param_init_std: float = 1e-4,
                 seed: int = 0, device=None):
        super().__init__()
        if backend != "cell":
            raise NotImplementedError(
                f"permuto backend {backend!r} is not ported yet: only "
                f"'cell' with n_feats=4 is (ROADMAP.md A10b, A9)")
        if n_feats != 4:
            raise NotImplementedError(
                f"the F={n_feats} cell permuto is not ported yet: only "
                f"n_feats=4 is (ROADMAP.md A10b)")
        self.backend, self.n_feats = backend, n_feats
        self.meta = PC4.make_permuto_cell4_meta(n_dims, res_list,
                                                hashmap_rows, auto_dense)
        self.out_features = 4 * self.meta.n_levels
        gen = torch.Generator().manual_seed(seed)
        init = torch.rand((self.meta.total_rows, 256), generator=gen)
        self.flattened_params = nn.Parameter(
            ((init * 2.0 - 1.0) * param_init_std).to(device))

    def encode(self, inp: torch.Tensor, frozen_x: bool = False,
               ho: bool = False) -> torch.Tensor:
        """inp [..., d] → [..., 4L]: B14 on a CUDA tensor, with B15 as its
        backward (`frozen_x`: dL/dtable only). `ho=True` asks for the
        any-order plain formulation, which the JAX package routes to XLA;
        it exists for CPU tensors only (the CUDA route differentiates the
        nablas through `nablas`)."""
        p = self.flattened_params
        batch = inp.shape[:-1]
        flat = inp.reshape(-1, inp.shape[-1])
        if ho:
            if flat.device.type != "cpu":
                raise NotImplementedError(
                    "encode(ho=True) is the plain formulation: on CUDA, "
                    "differentiate the nablas through PermutoParams.nablas")
            y = PC4.permuto_cell4_encode_xla(flat, p, self.meta)
        elif frozen_x:
            y = PC4.permuto_cell4_encode_frozen_x(flat, p, self.meta)
        else:
            y = PC4.permuto_cell4_encode(flat, p, self.meta)
        return y.reshape(*batch, y.shape[-1])

    def nablas(self, g_up: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        """J_enc(inp)ᵀ·g_up in the lattice's [0,1] space (B16 on CUDA; its
        backward is the plain vjp)."""
        batch = inp.shape[:-1]
        flat = inp.reshape(-1, inp.shape[-1])
        nab = PC4.permuto_cell4_nablas(g_up.reshape(-1, g_up.shape[-1]),
                                       flat, self.flattened_params,
                                       self.meta)
        return nab.reshape(*batch, nab.shape[-1])
