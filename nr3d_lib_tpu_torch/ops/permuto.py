"""The classic permutohedral-lattice hash encoding, plain PyTorch (port of
nr3d_lib_tpu/ops/permuto.py; the JAX package computes it in XLA, with no
Pallas kernel, and so does the port on any device).

A point of d dimensions is elevated onto the sum-zero hyperplane of
R^{d+1}, rounded to the nearest remainder-0 lattice point, and the ranks
of the differential pick which of that cell's (d+1)! simplices holds it.
Each of the simplex's d+1 vertices is hashed to a row of the level's
table (d+1 gathers a point and level) and weighted by its barycentric
coordinate. The search is shared with the cell layouts
(`ops/permuto_cell.py` imports `_simplex_parts` from here, as the JAX
package does).

Every function is differentiable to any order by autograd (the
barycentric weights are the only differentiable path from x); the
forward-mode Jacobian `permuto_enc_fwd_dydx` goes through `torch.func.jvp`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nr3d_lib_tpu_torch.ops.lotd_brick import HASH_PRIMES

__all__ = ["PermutoEncMeta", "make_permuto_meta", "permuto_encode",
           "permuto_enc_fwd_dydx", "permuto_enc_bwd_dydx",
           "hyperplane_scales", "f32_scalars"]

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class PermutoEncMeta:
    """Static metadata: per-level per-axis scales, features and hashmap
    sizes; the flat parameter vector holds the levels' [size, feats]
    tables one after the other."""

    n_dims: int
    level_scales: Tuple[Tuple[float, ...], ...]   # [L][D] per-axis scales
    level_n_feats: Tuple[int, ...]
    hashmap_sizes: Tuple[int, ...]

    @cached_property
    def n_levels(self) -> int:
        return len(self.level_scales)

    @cached_property
    def level_n_params(self) -> Tuple[int, ...]:
        return tuple(s * f for s, f in zip(self.hashmap_sizes,
                                           self.level_n_feats))

    @cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        out = [0]
        for p in self.level_n_params:
            out.append(out[-1] + p)
        return tuple(out)

    @cached_property
    def n_params(self) -> int:
        return self.level_offsets[-1]

    @cached_property
    def out_features(self) -> int:
        return int(sum(self.level_n_feats))


def make_permuto_meta(n_dims: int,
                      res_list: Sequence[Union[float, Sequence[float]]],
                      n_feats: Union[int, Sequence[int]] = 2,
                      log2_hashmap_size: int = 18) -> PermutoEncMeta:
    """res_list: each level's lattice scale (≈ resolution), a scalar or one
    per dimension."""
    n_levels = len(res_list)
    if isinstance(n_feats, int):
        n_feats = [n_feats] * n_levels
    scales = tuple(
        tuple([float(s)] * n_dims) if np.isscalar(s)
        else tuple(float(v) for v in s) for s in res_list)
    hsize = 2 ** log2_hashmap_size
    return PermutoEncMeta(n_dims, scales, tuple(int(f) for f in n_feats),
                          tuple([hsize] * n_levels))


# ---------------------------------------------------------- lattice math
def hyperplane_scales(d: int) -> np.ndarray:
    """sf [d] float32: the elevation's per-axis factors, an f32 array of
    1/√((i+1)(i+2)) times the f32 of (d+1)·√(2/3), as JAX computes them."""
    inv_std = np.float32((d + 1) * math.sqrt(2.0 / 3.0))
    base = np.asarray([1.0 / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
                      np.float32)
    return (base * inv_std).astype(np.float32)


def f32_scalars(values) -> List[float]:
    """Python floats holding float32 values: a tensor times one of them
    rounds once in float32, as a product with a float32 tensor does, and
    needs no host-to-device copy (which would synchronize the stream)."""
    return [float(v) for v in np.asarray(values, np.float32)]


def _simplex_parts(x: torch.Tensor, d: int):
    """x [N, d] (already scaled) → (rem0 [N,d+1] float, rank [N,d+1]
    int64, bary [N,d+1]): the enclosing simplex's remainder-0 base point,
    the rank permutation picking which of the cell's (d+1)! simplices
    holds x, and the barycentric weights of its d+1 vertices.
    Differentiable in x through the barycentric weights."""
    n = x.shape[0]
    dp1 = d + 1
    cf = [x[:, a] * s for a, s in enumerate(f32_scalars(
        hyperplane_scales(d)))]
    # elevated[i] = Σ_{j≥i} cf_j − i·cf_{i−1}, the sums taken from the last
    rev = [None] * d
    rev[d - 1] = cf[d - 1]
    for i in range(d - 2, -1, -1):
        rev[i] = rev[i + 1] + cf[i]
    zero = torch.zeros(n, dtype=x.dtype, device=x.device)
    elev = torch.stack([rev[0]] + [(rev[i] if i < d else zero)
                                   - i * cf[i - 1]
                                   for i in range(1, dp1)], -1)

    # nearest remainder-0 point: round each coordinate to a multiple of d+1
    e = elev.detach()
    v = e / dp1
    up = torch.ceil(v) * dp1
    down = torch.floor(v) * dp1
    rem0 = torch.where(up - e < e - down, up, down)
    sum_ = torch.round(rem0.sum(-1) / dp1).to(torch.int64)          # [N]

    # rank the differential; ties break by index
    diff = e - rem0
    ii = torch.arange(dp1, device=x.device)
    gt = diff[:, :, None] < diff[:, None, :]
    tie = (diff[:, :, None] == diff[:, None, :]) & (ii[:, None] > ii[None, :])
    rank = (gt | tie).sum(-1) + sum_[:, None]

    # fix points whose remainder sum is not 0
    low, high = rank < 0, rank > d
    rank = torch.where(low, rank + dp1, torch.where(high, rank - dp1, rank))
    rem0 = rem0 + low.to(x.dtype) * dp1 - high.to(x.dtype) * dp1

    # barycentric weights: bary_k = vdiff[rank = d−k] − vdiff[rank = d+1−k],
    # bary_0 = vdiff[rank = d] + 1 − vdiff[rank = 0] (one-hot sums, as JAX)
    vdiff = (elev - rem0) / dp1                                      # [N,d+1]
    j = torch.arange(dp1 + 1, device=x.device)
    oh = ((d - rank)[..., None] == j).to(x.dtype) - \
        ((dp1 - rank)[..., None] == j).to(x.dtype)            # [N,d+1,d+2]
    bary_full = torch.sum(oh * vdiff[..., None], 1)                 # [N, d+2]
    b0 = bary_full[:, 0] + 1.0 + bary_full[:, dp1]
    bary = torch.cat([b0[:, None], bary_full[:, 1:dp1]], -1)
    return rem0, rank, bary


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a · prime) mod 2^32 for int64 a ∈ [0, 2^32), without overflowing
    int64 (split into 16-bit halves)."""
    lo = (a & 0xFFFF) * prime
    hi = (((a >> 16) * prime) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _simplex(x: torch.Tensor, d: int):
    """x [N, d] (already scaled) → (keys [N, d+1, d] int64, bary [N, d+1]):
    the first d coordinates of the d+1 enclosing lattice vertices, and
    their barycentric weights. Vertex k is rem0 + k, less d+1 where the
    coordinate's rank is ≥ d+1−k."""
    rem0, rank, bary = _simplex_parts(x, d)
    dp1 = d + 1
    ks = torch.arange(dp1, device=x.device)[None, :, None]          # [1,d+1,1]
    cond = rank[:, None, :] >= (dp1 - ks)                         # [N,d+1,d+1]
    keys = rem0.to(torch.int64)[:, None, :] + ks - cond.to(torch.int64) * dp1
    return keys[:, :, :d], bary


def _hash_keys(keys: torch.Tensor, hashmap_size: int) -> torch.Tensor:
    """keys [..., d] lattice coordinates → hash indices [...] int64: the
    coordinates as uint32 (two's complement), times the primes with
    wraparound, xor'ed, mod the hashmap size."""
    u = keys & _U32
    h = _mul_u32(u[..., 0], HASH_PRIMES[0])
    for i in range(1, keys.shape[-1]):
        h = h ^ _mul_u32(u[..., i], HASH_PRIMES[i % 7])
    return h % hashmap_size


def permuto_encode(x: torch.Tensor, params: torch.Tensor,
                   meta: PermutoEncMeta,
                   level_weights: Optional[torch.Tensor] = None,
                   max_level: Optional[int] = None) -> torch.Tensor:
    """x [N, D] in the lattice's [0,1]-ish space; params [n_params] flat →
    [N, Σ n_feats]. `max_level` zeroes the levels above it, and
    `level_weights` [L] scales each level (the anneal window)."""
    d = meta.n_dims
    if x.shape[-1] != d:
        raise ValueError(f"permuto_encode: x has {x.shape[-1]} dims, the "
                         f"meta {d}")
    outs = []
    for l in range(meta.n_levels):
        scaled = torch.stack([x[:, a] * s for a, s in enumerate(
            f32_scalars(meta.level_scales[l]))], -1)
        keys, bary = _simplex(scaled, d)                 # [N,d+1,d],[N,d+1]
        idx = _hash_keys(keys, meta.hashmap_sizes[l])    # [N, d+1]
        nf, off = meta.level_n_feats[l], meta.level_offsets[l]
        table = params[off:off + meta.level_n_params[l]].reshape(
            meta.hashmap_sizes[l], nf)
        feats = table[idx]                               # [N, d+1, nf]
        y = torch.sum(bary[..., None].to(feats.dtype) * feats, 1)
        if max_level is not None:
            y = y * float(l <= max_level)
        if level_weights is not None:
            y = y * level_weights[l].to(y.dtype)
        outs.append(y)
    return torch.cat(outs, -1)


def permuto_enc_fwd_dydx(x: torch.Tensor, params: torch.Tensor,
                         meta: PermutoEncMeta, **kw
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [N, F], dy/dx [N, F, D]) by one forward-mode product per input
    dimension; `kw` as `permuto_encode`."""
    def f(xx):
        return permuto_encode(xx, params, meta, **kw)

    y = f(x)
    tangents = []
    for dim in range(meta.n_dims):
        seed = torch.zeros_like(x)
        seed[..., dim] = 1.0
        _, dy = torch.func.jvp(f, (x,), (seed,))
        tangents.append(dy)
    return y, torch.stack(tangents, -1)


def permuto_enc_bwd_dydx(dL_dy: torch.Tensor, dy_dx: torch.Tensor
                         ) -> torch.Tensor:
    """nablas dL/dx = Σ_f dL/dy_f · dy_f/dx; its backward is autograd's."""
    return torch.einsum("...f,...fd->...d", dL_dy, dy_dx)
