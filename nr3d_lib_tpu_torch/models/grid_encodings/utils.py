"""Grid-encoding commons (port of nr3d_lib_tpu/models/grid_encodings/
utils.py): trilinear voxel interpolation, a 1D line sample and the
per-level select/reduce decoder factory. Plain PyTorch, differentiable in
the grid and the positions.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from nr3d_lib_tpu_torch.models.blocks import MLP

__all__ = ["trilinear_interp", "gridsample1d", "get_multires_decoder"]


def trilinear_interp(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """grid [rx,ry,rz,F]; x [...,3] in [-1,1] → [...,F] (align_corners:
    −1 and 1 are the first and last vertices)."""
    rx, ry, rz, _ = grid.shape
    res = torch.tensor([rx, ry, rz], dtype=x.dtype, device=x.device)
    u = (x + 1.0) * 0.5 * (res - 1)
    hi = torch.tensor([rx - 2, ry - 2, rz - 2], device=x.device)
    c0 = torch.minimum(torch.clamp(torch.floor(u).to(torch.int64), min=0),
                       hi)
    w = u - c0
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wt = ((w[..., 0] if dx else 1 - w[..., 0])
                      * (w[..., 1] if dy else 1 - w[..., 1])
                      * (w[..., 2] if dz else 1 - w[..., 2]))
                out = out + wt[..., None] * grid[c0[..., 0] + dx,
                                                 c0[..., 1] + dy,
                                                 c0[..., 2] + dz]
    return out


def gridsample1d(line: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """line [n,F]; t [...] in [-1,1] → [...,F], linear between the n
    vertices (align_corners)."""
    n = line.shape[0]
    u = (t + 1.0) * 0.5 * (n - 1)
    c0 = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
    w = (u - c0)[..., None]
    return line[c0] * (1 - w) + line[c0 + 1] * w


def get_multires_decoder(level_n_feats: Sequence[int], out_features: int, *,
                         select_n_levels: Optional[int] = None,
                         reduce: str = "concat", D: int = 1, W: int = 64,
                         seed: int = 0, device=None, **mlp_kw
                         ) -> Tuple[Callable, MLP]:
    """Per-level select/reduce decoder factory → (decode_fn, mlp).
    reduce: 'concat' feeds the first `select_n_levels` levels' features
    to the MLP; 'sum' adds them (the levels must share widths)."""
    n_levels = len(level_n_feats)
    sel = n_levels if select_n_levels is None else min(select_n_levels,
                                                       n_levels)
    offsets = [0]
    for f in level_n_feats:
        offsets.append(offsets[-1] + f)

    if reduce == "concat":
        in_dim = offsets[sel]

        def pre(h):
            return h[..., :offsets[sel]]
    elif reduce == "sum":
        f0 = level_n_feats[0]
        if any(f != f0 for f in level_n_feats[:sel]):
            raise ValueError("reduce='sum' needs levels of one width")
        in_dim = f0

        def pre(h):
            return sum(h[..., offsets[i]:offsets[i + 1]] for i in range(sel))
    else:
        raise ValueError(reduce)

    mlp = MLP(in_dim, out_features, D=D, W=W, seed=seed, device=device,
              **mlp_kw)

    def decode(h):
        return mlp(pre(h))

    return decode, mlp
