"""Direction embedders (port of nr3d_lib_tpu/models/embedders.py: the
spherical-harmonics basis and the spherical branch of `get_embedder`)."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sh_encode", "SHEncoder", "get_embedder"]


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis of unit directions, NGP component
    order. degree ∈ [1,4] → 1/4/9/16 dims."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, 0.28209479177387814)]  # l=0
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (x2 - y2)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, -1)


class SHEncoder:
    def __init__(self, degree: int = 4, input_dim: int = 3):
        if input_dim != 3:
            raise ValueError("spherical harmonics take 3-D directions")
        self.degree = degree
        self.in_features = 3
        self.out_features = degree ** 2

    def __call__(self, dirs: torch.Tensor) -> torch.Tensor:
        return sh_encode(dirs, self.degree)


def get_embedder(embed_cfg: Optional[dict] = None, input_dim: int = 3):
    """Embedder factory → (fn, out_features)."""
    cfg = dict(embed_cfg or {})
    etype = cfg.pop("type", "identity").lower()
    if etype in ("spherical", "sh", "spherical_harmonics"):
        enc = SHEncoder(degree=cfg.get("degree", 4), input_dim=input_dim)
        return enc, enc.out_features
    raise NotImplementedError(f"embedder {etype!r} is not ported yet")
