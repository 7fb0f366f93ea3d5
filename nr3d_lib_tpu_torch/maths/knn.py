"""K nearest neighbours and the chamfer distance (port of
nr3d_lib_tpu/maths/knn.py `knn_points`, `knn_gather`, `chamfer_distance`,
`dist_to_nn3_mean`).

Plain PyTorch on the inputs' device, as the JAX package computes them in
XLA: a chunk's squared distances by the `x·yᵀ` expansion pick
`k + margin` candidates, and exact coordinate differences rank them. Both
clouds are shifted by a shared centroid first, which keeps the
expansion's f32 cancellation small; the returned distances come from the
unshifted points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["knn_points", "knn_gather", "chamfer_distance", "dist_to_nn3_mean"]


def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[N,D]×[M,D] → [N,M] squared distances by the expansion."""
    xx = torch.sum(x * x, -1, keepdim=True)
    yy = torch.sum(y * y, -1, keepdim=True)
    return torch.clamp(xx - 2 * (x @ y.T) + yy.T, min=0.0)


def knn_points(x: torch.Tensor, y: torch.Tensor, k: int = 1,
               chunk: int = 8192, candidate_margin: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each x, the k nearest in y → (sq_dists [N,k], idx [N,k]),
    nearest first. Batched ([B,N,D]) or flat ([N,D])."""
    if x.ndim == 3:
        outs = [knn_points(a, b, k, chunk, candidate_margin)
                for a, b in zip(x, y)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    m = y.shape[0]
    c = (torch.mean(x, dim=0) + torch.mean(y, dim=0)) * 0.5
    xs, ys = x - c, y - c
    kc = min(k + (candidate_margin if candidate_margin is not None
                  else max(4, k)), m)
    outs_d, outs_i = [], []
    for s in range(0, x.shape[0], chunk):
        xc = x[s:s + chunk]
        _, cand = torch.topk(_sq_dists(xs[s:s + chunk], ys), kc, dim=-1,
                             largest=False)
        d_exact = torch.sum((xc[:, None, :] - y[cand]) ** 2, -1)
        top, sel = torch.topk(d_exact, k, dim=-1, largest=False)
        outs_d.append(top)
        outs_i.append(torch.gather(cand, -1, sel))
    return torch.cat(outs_d), torch.cat(outs_i)


def knn_gather(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbour features: y [M,D], idx [N,K] → [N,K,D] (batched too)."""
    if y.ndim == 3:
        return torch.stack([knn_gather(a, b) for a, b in zip(y, idx)])
    return y[idx]


def chamfer_distance(x: torch.Tensor, y: torch.Tensor, *,
                     squared: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional chamfer: (mean over x of the distance to y, mean over
    y of the distance to x); squared distances unless `squared=False`."""
    dx = knn_points(x, y, 1)[0][..., 0]
    dy = knn_points(y, x, 1)[0][..., 0]
    if not squared:
        dx = torch.sqrt(torch.clamp(dx, min=1e-12))
        dy = torch.sqrt(torch.clamp(dy, min=1e-12))
    return torch.mean(dx), torch.mean(dy)


def dist_to_nn3_mean(pts: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest other points,
    the 3D Gaussian splatting scale initializer: [N,3] → [N]. The nearest
    of the 4 found is the point itself. `chunk` rows a distance block
    ([chunk, N] floats): 8192 is the JAX version's; at N = 500,000 that
    block is 16.4 GB, so a caller with large clouds passes fewer rows."""
    d, _ = knn_points(pts, pts, 4, chunk=chunk)
    return torch.mean(d[:, 1:4], dim=-1)
