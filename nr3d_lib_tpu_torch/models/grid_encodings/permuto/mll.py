"""MLL, the multi-level-lattice network (port of nr3d_lib_tpu/models/
grid_encodings/permuto/mll.py `PermutohedralLatticeLayer`, `MLL`,
`MLLNet`).

D classic-lattice encodings in a chain: layer l encodes layer l−1's
output (a feature vector, not a position, so the lattice takes any input
dimension), each non-final layer has an optional per-layer linear decoder
and, with `use_residual`, a residual `h = zero·decoded + pad(layer_input)`
whose scalar `zero` is learned and starts at 0. `MLLNet` adds the output
head and `forward_with_nablas`, one autograd pass through the whole stack.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP, get_nonlinearity
from nr3d_lib_tpu_torch.models.grid_encodings.permuto.permuto_encoding import (
    PermutoEncoding)

__all__ = ["PermutohedralLatticeLayer", "MLL", "MLLNet"]


def _per_layer(v, d: int, default=None):
    if v is None:
        v = default
    if isinstance(v, (int, float)):
        return [v] * d
    v = list(v)
    if len(v) != d:
        raise ValueError(f"expected {d} per-layer values, got {len(v)}")
    return v


class PermutohedralLatticeLayer(nn.Module):
    """One multi-level lattice + optional decoder + optional residual.

    decoder_out_features: None → the encoding's width; −1 → no decoder.
    residual_in_features > 0 turns on the learned-zero residual (it must
    not exceed out_features)."""

    def __init__(self, in_features: int, *,
                 decoder_out_features: Optional[int] = None,
                 residual_in_features: int = -1,
                 n_levels: int = 16, n_feats: int = 2,
                 pos_scale: float = 1.0,
                 coarsest_res: float = 10.0, finest_res: float = 1000.0,
                 log2_hashmap_size: int = 18,
                 anneal_cfg: Optional[dict] = None,
                 param_init_std: float = 1e-4, seed: int = 0, device=None):
        super().__init__()
        self.encoding = PermutoEncoding(
            in_features, coarsest_res=coarsest_res, finest_res=finest_res,
            n_levels=n_levels, n_feats=n_feats,
            log2_hashmap_size=log2_hashmap_size, anneal_cfg=anneal_cfg,
            param_init_std=param_init_std, seed=seed, device=device)
        self.in_features = in_features
        self.pos_scale = float(pos_scale)
        self.residual_in_features = int(residual_in_features)
        if decoder_out_features is None:
            decoder_out_features = self.encoding.out_features
        if decoder_out_features > 0:
            self.decoder = MLP(self.encoding.out_features,
                               decoder_out_features, D=0, W=16,
                               seed=seed + 1, device=device)
            self.out_features = decoder_out_features
        else:
            self.decoder = None
            self.out_features = self.encoding.out_features
        if self.residual_in_features > 0:
            if self.residual_in_features > self.out_features:
                raise ValueError(
                    f"out_features={self.out_features} must be >= "
                    f"residual_in_features={self.residual_in_features}")
            self.pad_size = self.out_features - self.residual_in_features
            self.zero = nn.Parameter(torch.zeros((), device=device))

    def set_anneal_iter(self, it: int) -> None:
        self.encoding.set_anneal_iter(it)

    def _decode(self, h: torch.Tensor,
                residual_input: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if self.decoder is not None:
            h = self.decoder(h)
        if self.residual_in_features > 0:
            if residual_input is None or \
                    residual_input.shape[-1] != self.residual_in_features:
                raise ValueError("the residual needs the layer's input")
            h = self.zero * h + F.pad(residual_input, (0, self.pad_size))
        return h

    def forward(self, x: torch.Tensor,
                residual_input: Optional[torch.Tensor] = None,
                max_level: Optional[int] = None) -> torch.Tensor:
        # the encoding maps [-1,1] to the lattice's [0,1]; feature inputs
        # pass through pos_scale first
        h = self.encoding(x * self.pos_scale, max_level=max_level)
        return self._decode(h, residual_input)

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        p = self.encoding.flattened_params.detach()
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        return {pre + "params.mean": float(p.mean()),
                pre + "params.std": float(p.std(unbiased=False)),
                pre + "params.absmax": float(p.abs().max())}


class MLL(nn.Module):
    """Chained lattice layers: layer l encodes layer l−1's output; the
    last layer has no decoder and no residual."""

    def __init__(self, in_features: int, *, D: int = 2,
                 use_residual: bool = True,
                 lattice_pos_scale: Union[float, Sequence[float]] = 1.0,
                 lattice_n_levels: Union[int, Sequence[int]] = 16,
                 lattice_n_feats: Union[int, Sequence[int]] = 2,
                 lattice_cfg: Optional[dict] = None,
                 decoder_out_feats: Union[None, int, Sequence[int]] = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.in_features = in_features
        self.use_residual = bool(use_residual)
        self.D = int(D)
        n_levels = _per_layer(lattice_n_levels, D)
        n_feats = _per_layer(lattice_n_feats, D)
        pos_scale = _per_layer(lattice_pos_scale, D)
        if isinstance(decoder_out_feats, int):
            decoder_out_feats = [decoder_out_feats] * (D - 1)
        elif decoder_out_feats is not None:
            decoder_out_feats = list(decoder_out_feats)
            if len(decoder_out_feats) != D - 1:
                raise ValueError("decoder_out_feats needs D − 1 values")

        layers: List[PermutohedralLatticeLayer] = []
        last_out = in_features
        for l in range(D):
            in_dim = in_features if l == 0 else last_out
            if l == D - 1:
                dec_out, res_in = -1, -1   # the last layer: neither
            else:
                dec_out = (None if decoder_out_feats is None
                           else decoder_out_feats[l])
                res_in = in_dim if self.use_residual else -1
            layer = PermutohedralLatticeLayer(
                in_dim, decoder_out_features=dec_out,
                residual_in_features=res_in, n_levels=n_levels[l],
                n_feats=n_feats[l], pos_scale=pos_scale[l],
                **(lattice_cfg or {}), seed=seed + 101 * l, device=device)
            last_out = layer.out_features
            layers.append(layer)
        self.lattice_layers = nn.ModuleList(layers)
        self.last_encoded_features = last_out
        self.out_features = last_out

    def set_anneal_iter(self, it: int) -> None:
        for layer in self.lattice_layers:
            layer.set_anneal_iter(it)

    def forward(self, x: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        h = x
        for layer in self.lattice_layers:
            # for l > 0 the "position" is the previous layer's output, and
            # the residual input is the same tensor
            h = layer(h, h if layer.residual_in_features > 0 else None,
                      max_level=max_level)
        return h

    def get_weight_reg(self, norm_type: float = 2.0) -> torch.Tensor:
        norms = [torch.linalg.vector_norm(p.reshape(-1), ord=norm_type)
                 for layer in self.lattice_layers if layer.decoder is not None
                 for p in layer.decoder.parameters()]
        return torch.stack(norms) if norms else torch.zeros((0,))

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        out = {}
        for l, layer in enumerate(self.lattice_layers):
            out.update(layer.stat_param(pre + f"lattice_layers.{l}"))
        return out


class MLLNet(MLL):
    """MLL + output head."""

    def __init__(self, in_features: int, out_features: int, *, D: int = 2,
                 use_residual: bool = False,
                 lattice_n_levels: Union[int, Sequence[int]] = 16,
                 lattice_n_feats: Union[int, Sequence[int]] = 2,
                 decoder_out_feats: Union[None, int, Sequence[int]] = None,
                 lattice_cfg: Optional[dict] = None,
                 output_activation: Optional[str] = None, seed: int = 0,
                 device=None):
        super().__init__(in_features, D=D, use_residual=use_residual,
                         lattice_n_levels=lattice_n_levels,
                         lattice_n_feats=lattice_n_feats,
                         decoder_out_feats=decoder_out_feats,
                         lattice_cfg=lattice_cfg, seed=seed, device=device)
        self.out_features = out_features
        self.to_output = MLP(self.last_encoded_features, out_features, D=0,
                             W=16, seed=seed + 999, device=device)
        self.output_activation = get_nonlinearity(output_activation) \
            or (lambda x: x)

    def forward(self, x: torch.Tensor, max_level: Optional[int] = None,
                return_h: bool = False):
        h = MLL.forward(self, x, max_level=max_level)
        out = self.output_activation(self.to_output(h))
        return {"output": out, "h": h} if return_h else {"output": out}

    def forward_with_nablas(self, x: torch.Tensor,
                            max_level: Optional[int] = None,
                            max_pos_dims: Optional[int] = None,
                            max_out_dims: Optional[int] = None) -> Dict:
        """output, h, and d(Σ output[..., :max_out_dims])/dx[...,
        :max_pos_dims] by one autograd pass through the stack; the nablas
        stay differentiable when gradients are on."""
        graph = torch.is_grad_enabled()
        with torch.enable_grad():
            xr = x if (graph and x.requires_grad) else \
                x.detach().requires_grad_(True)
            r = self.forward(xr, max_level=max_level, return_h=True)
            out, h = r["output"], r["h"]
            ones = torch.ones_like(out)
            if max_out_dims is not None:
                ones = ones * (torch.arange(out.shape[-1], device=out.device)
                               < max_out_dims).to(out.dtype)
            (nab,) = torch.autograd.grad(out, xr, ones, create_graph=graph)
        if not graph:
            out, h = out.detach(), h.detach()
        if max_pos_dims is not None:
            nab = nab[..., :max_pos_dims]
        return {"output": out, "h": h, "nablas": nab}

    def stat_param(self, prefix: str = "") -> Dict[str, float]:
        out = MLL.stat_param(self, prefix)
        pre = prefix + ("." if prefix and not prefix.endswith(".") else "")
        # the last of the head's parameters in path order, as in JAX
        for _, p in sorted(self.to_output.named_parameters()):
            out[pre + "to_output.absmax"] = float(p.detach().abs().max())
        return out
