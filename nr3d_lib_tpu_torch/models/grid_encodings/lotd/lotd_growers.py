"""LoTD grower family: hypernetworks z → per-instance flattened LoTD params
(port of nr3d_lib_tpu/models/grid_encodings/lotd/lotd_growers.py).

`LoDMeta` defines the flattened layout of every decomposition type, so
each grower works for any meta (Flatten, SharedMod) or derives its
per-entry coordinates from the meta's layout (FMM). Growers produce
params [B, n_params] for `lotd_encode(..., bidx=)`.

Module and parameter names mirror the JAX package's (`mlp`, `trunk/i`,
`heads/i`, `pseudo/<level>`, `shared`, `const`, `blocks/i`, `base`,
`growers/i`; `w` [in, out] applied as `h @ w`), so the state bridge maps
them without a transpose. Initial values follow the JAX schemes from an
explicit `torch.Generator`; they do not match JAX's random bits.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP, get_nonlinearity
from nr3d_lib_tpu_torch.ops.lotd import LoDMeta, LoDType

__all__ = ["LoTDFlattenGrower", "LoTDFMMGrower", "LoTDConvGrower",
           "LoTDSharedModGrower", "LoTDMixedGrower", "get_lotd_grower",
           "resize_trilinear"]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def _identity(x):
    return x


@functools.lru_cache(maxsize=256)
def _level_entry_coords(meta: LoDMeta, level: int) -> Optional[np.ndarray]:
    """Pseudo-coordinate in [-1,1]^D of every grid entry of one level, in
    the flattened-entry order `lotd_encode` indexes; dropped axes (planes,
    lines) sit at 0. A hashed level has no spatial layout → None."""
    t = meta.level_types[level]
    res = meta.level_res[level]
    d = len(res)

    def lin(r):
        return np.linspace(-1.0, 1.0, r, dtype=np.float32) if r > 1 \
            else np.zeros((r,), np.float32)

    def grid(dims):
        axes = np.meshgrid(*[lin(res[j]) for j in dims], indexing="ij")
        flat = np.stack([a.reshape(-1) for a in axes], -1)
        out = np.zeros((flat.shape[0], d), np.float32)
        for k, j in enumerate(dims):
            out[:, j] = flat[:, k]
        return out

    if t == LoDType.Dense or (t == LoDType.Hash and
                              int(np.prod(res)) <= meta.level_sizes[level]):
        return grid(list(range(d)))
    if t == LoDType.Hash:
        return None
    if t in (LoDType.CP, LoDType.CPfast):
        return np.concatenate([grid([a]) for a in range(d)], 0)
    if t in (LoDType.NPlaneSum, LoDType.NPlaneMul):
        return np.concatenate(
            [grid([j for j in range(d) if j != a]) for a in range(d)], 0)
    if t == LoDType.VectorMatrix:
        lines = np.concatenate([grid([a]) for a in range(d)], 0)
        planes = np.concatenate(
            [grid([j for j in range(d) if j != a]) for a in range(d)], 0)
        return np.concatenate([lines, planes], 0)
    if t == LoDType.VecZMatXoY:
        return np.concatenate([grid([2]), grid([0, 1])], 0)
    raise ValueError(t)


class LoTDFlattenGrower(nn.Module):
    """One MLP emitting every level's parameters at once."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, D: int = 2,
                 W: int = 256, out_scale: float = 1e-2, seed: int = 0,
                 device=None, **_):
        super().__init__()
        self.meta = meta
        self.out_scale = out_scale
        self.mlp = MLP(z_dim, meta.n_params, D=D, W=W, seed=seed,
                       device=device)

    def forward(self, z: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        p = self.mlp(z) * self.out_scale
        if max_level is not None and max_level < self.meta.n_levels - 1:
            keep = torch.zeros(self.meta.n_params, dtype=p.dtype,
                               device=p.device)
            keep[:self.meta.level_offsets[max_level + 1]] = 1.0
            p = p * keep
        return p


class _FiLMLayer(nn.Module):
    """A linear layer whose output is feature-wise modulated by z."""

    def __init__(self, in_f: int, out_f: int, z_dim: int, *,
                 activation: str = "relu", seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(_uniform(gen, (in_f, out_f),
                                       1.0 / np.sqrt(in_f)).to(device))
        self.b = nn.Parameter(torch.zeros(out_f, device=device))
        self.wz = nn.Parameter(_uniform(gen, (z_dim, 2 * out_f),
                                        1.0 / np.sqrt(z_dim)).to(device))
        self.bz = nn.Parameter(torch.zeros(2 * out_f, device=device))
        self.act = get_nonlinearity(activation) or _identity

    def forward(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """h [B, S, in_f], z [B, z_dim] → [B, S, out_f]."""
        gb = z @ self.wz + self.bz
        gamma, beta = torch.chunk(gb, 2, -1)
        y = h @ self.w + self.b
        y = y * (1.0 + gamma[:, None, :]) + beta[:, None, :]
        return self.act(y)


class LoTDFMMGrower(nn.Module):
    """Feature-wise-modulated coordinate network: a shared MLP over each
    level's pseudo-coordinate grid, FiLM-modulated by z, with a per-level
    head, plus an optional learnable shared table added to every instance
    (`use_shared_encoding`). A hashed level gets a learnable pseudo-input
    table instead of coordinates."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, D: int = 2,
                 W: int = 64, out_scale: float = 1e-2,
                 use_shared_encoding: bool = True, activation: str = "relu",
                 seed: int = 0, device=None, **_):
        super().__init__()
        self.meta = meta
        self.out_scale = out_scale
        d = meta.n_dims
        self.trunk = nn.ModuleList([
            _FiLMLayer(d, W, z_dim, activation=activation, seed=seed,
                       device=device),
            *[_FiLMLayer(W, W, z_dim, activation=activation,
                         seed=seed + 1 + i, device=device)
              for i in range(D - 1)]])
        self.heads = nn.ModuleList([
            _FiLMLayer(W, meta.level_n_feats[l], z_dim, activation="none",
                       seed=seed + 100 + l, device=device)
            for l in range(meta.n_levels)])
        pseudo = {}
        for l in range(meta.n_levels):
            if _level_entry_coords(meta, l) is None:
                gen = torch.Generator().manual_seed(seed + 200 + l)
                pseudo[str(l)] = nn.Parameter((torch.randn(
                    (meta.level_sizes[l], d), generator=gen) * 0.5
                ).to(device))
        self.pseudo = nn.ParameterDict(pseudo)
        self.shared = nn.Parameter(torch.zeros(meta.n_params, device=device)) \
            if use_shared_encoding else None

    def forward(self, z: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        outs: List[torch.Tensor] = []
        B = z.shape[0]
        for l in range(self.meta.n_levels):
            if max_level is not None and l > max_level:
                outs.append(torch.zeros((B, self.meta.level_n_params[l]),
                                        dtype=z.dtype, device=z.device))
                continue
            c = _level_entry_coords(self.meta, l)
            x = torch.as_tensor(c, device=z.device) if c is not None \
                else self.pseudo[str(l)]
            h = x[None].expand((B,) + tuple(x.shape))
            for layer in self.trunk:
                h = layer(h, z)
            h = self.heads[l](h, z)                       # [B, size, F]
            outs.append(h.reshape(B, -1) * self.out_scale)
        p = torch.cat(outs, -1)
        if self.shared is not None:
            p = p + self.shared
        return p


class _ModConv(nn.Module):
    """A pointwise (1×1×1) channel map with z modulation of its input
    channels; `w` is [in, out] and applied as `h @ w`."""

    def __init__(self, in_c: int, out_c: int, z_dim: int, *,
                 activation: str = "lrelu", seed: int = 0, device=None):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.w = nn.Parameter(_uniform(gen, (in_c, out_c),
                                       1.0 / np.sqrt(in_c)).to(device))
        self.b = nn.Parameter(torch.zeros(out_c, device=device))
        self.wz = nn.Parameter(_uniform(gen, (z_dim, in_c),
                                        1.0 / np.sqrt(z_dim)).to(device))
        self.act = get_nonlinearity(
            "relu" if activation == "lrelu" else activation) or _identity

    def forward(self, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """h [B, X, Y, Z, C]: style-modulate the input channels, then mix."""
        style = 1.0 + z @ self.wz                         # [B, in_c]
        y = (h * style[:, None, None, None, :]) @ self.w + self.b
        return self.act(y)


@functools.lru_cache(maxsize=64)
def _resize_weights(m: int, n: int) -> np.ndarray:
    """[m, n] weights of a linear (triangle-kernel) resize of an axis of m
    samples to n, built as `jax.image.scale_and_translate` builds them:
    half-pixel centres, the kernel widened by m/n when downsampling (the
    antialias), columns normalized to sum 1, and zero where a sample lies
    outside the input. Computed in float64."""
    inv_scale = m / n
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float64)[:, None]) \
        / kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_trilinear(h: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.image.resize(h, shape, "trilinear")` (antialiased): each axis
    whose size changes is contracted with its `_resize_weights` matrix,
    one axis after another."""
    for d, n in enumerate(shape):
        m = h.shape[d]
        if m == n:
            continue
        w = torch.as_tensor(_resize_weights(m, int(n)), dtype=h.dtype,
                            device=h.device)
        h = torch.movedim(torch.movedim(h, d, -1) @ w, -1, d)
    return h


class LoTDConvGrower(nn.Module):
    """Progressive-growing generator: a learnable 4³ constant, then per
    level a ×2 trilinear upsample (after the first) and a modulated
    channel map; a per-level head emits that level's features, resized to
    the level's resolution. Dense(ly stored) 3D metas only."""

    def __init__(self, z_dim: int, meta: LoDMeta, *, base_channels: int = 32,
                 out_scale: float = 1e-1, seed: int = 0, device=None, **_):
        super().__init__()
        if not (meta.n_dims == 3 and all(
                t == LoDType.Dense or (t == LoDType.Hash and
                                       int(np.prod(r)) <= s)
                for t, r, s in zip(meta.level_types, meta.level_res,
                                   meta.level_sizes))):
            raise ValueError("LoTDConvGrower needs dense(ly stored) 3D "
                             "levels")
        self.meta = meta
        self.out_scale = out_scale
        C = base_channels
        gen = torch.Generator().manual_seed(seed)
        self.const = nn.Parameter(
            (torch.randn((4, 4, 4, C), generator=gen) * 0.1).to(device))
        self.blocks = nn.ModuleList([
            _ModConv(C, C, z_dim, seed=seed + 1 + l, device=device)
            for l in range(meta.n_levels)])
        self.heads = nn.ModuleList([
            _ModConv(C, meta.level_n_feats[l], z_dim, activation="none",
                     seed=seed + 100 + l, device=device)
            for l in range(meta.n_levels)])

    def forward(self, z: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        B = z.shape[0]
        h = self.const[None].expand((B,) + tuple(self.const.shape))
        outs: List[torch.Tensor] = []
        for l in range(self.meta.n_levels):
            if l > 0:  # grow ×2 then refine
                _, X, Y, Z, C = h.shape
                h = resize_trilinear(h, (B, 2 * X, 2 * Y, 2 * Z, C))
            h = self.blocks[l](h, z)
            if max_level is not None and l > max_level:
                outs.append(torch.zeros((B, self.meta.level_n_params[l]),
                                        dtype=z.dtype, device=z.device))
                continue
            f = self.heads[l](h, z)                       # [B, x, y, z, F]
            res = self.meta.level_res[l]
            f = resize_trilinear(f, (B,) + tuple(res) + (f.shape[-1],))
            outs.append(f.reshape(B, -1) * self.out_scale)
        return torch.cat(outs, -1)


class LoTDSharedModGrower(nn.Module):
    """One shared learnable LoTD table, scaled and shifted per (level,
    feature) by z: O(z_dim·ΣF) grown parameters instead of O(n_params)."""

    def __init__(self, z_dim: int, meta: LoDMeta, *,
                 init_scale: float = 1e-2, seed: int = 0, device=None, **_):
        super().__init__()
        self.meta = meta
        gen = torch.Generator().manual_seed(seed)
        self.base = nn.Parameter(
            _uniform(gen, (meta.n_params,), init_scale).to(device))
        F = meta.out_features
        self.wz = nn.Parameter(_uniform(gen, (z_dim, 2 * F),
                                        1.0 / np.sqrt(z_dim)).to(device))
        self.bz = nn.Parameter(torch.zeros(2 * F, device=device))

    def forward(self, z: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        gb = z @ self.wz + self.bz
        gamma, beta = torch.chunk(gb, 2, -1)              # [B, ΣF]
        outs = []
        for l in range(self.meta.n_levels):
            sl = slice(self.meta.level_offsets[l],
                       self.meta.level_offsets[l + 1])
            fs = slice(self.meta.out_feat_offsets[l],
                       self.meta.out_feat_offsets[l + 1])
            if max_level is not None and l > max_level:
                outs.append(torch.zeros(
                    (z.shape[0], self.meta.level_n_params[l]),
                    dtype=z.dtype, device=z.device))
                continue
            base = self.base[sl].reshape(self.meta.level_sizes[l],
                                         self.meta.level_n_feats[l])
            p = base[None] * (1.0 + gamma[:, None, fs]) + beta[:, None, fs]
            outs.append(p.reshape(z.shape[0], -1))
        return torch.cat(outs, -1)


class LoTDMixedGrower(nn.Module):
    """Different growers over consecutive level ranges: each sub-grower
    sees the sub-meta of its levels, and their outputs are concatenated
    in level order."""

    def __init__(self, z_dim: int, meta: LoDMeta, *,
                 splits: Sequence[Tuple[int, str, dict]], seed: int = 0,
                 device=None, **_):
        """splits: (n_levels, grower_type, kwargs) covering the meta's
        levels in order."""
        super().__init__()
        if sum(s[0] for s in splits) != meta.n_levels:
            raise ValueError("the splits must cover the meta's levels")
        self.meta = meta
        self.growers = nn.ModuleList([])
        self._n_levels = [s[0] for s in splits]
        start = 0
        for i, (n, gtype, kw) in enumerate(splits):
            sub = LoDMeta(meta.n_dims, meta.level_res[start:start + n],
                          meta.level_n_feats[start:start + n],
                          meta.level_types[start:start + n],
                          meta.hashmap_sizes[start:start + n],
                          meta.interpolation)
            self.growers.append(get_lotd_grower(
                gtype, z_dim, sub, seed=seed + 17 * i, device=device, **kw))
            start += n

    def forward(self, z: torch.Tensor, max_level: Optional[int] = None
                ) -> torch.Tensor:
        outs, start = [], 0
        for n, g in zip(self._n_levels, self.growers):
            ml = None if max_level is None else max_level - start
            outs.append(g(z, max_level=None if ml is None else max(ml, -1)))
            start += n
        return torch.cat(outs, -1)


_GROWERS = {
    "flatten": LoTDFlattenGrower, "dense": LoTDFlattenGrower,
    "fmm": LoTDFMMGrower,
    "conv": LoTDConvGrower,
    "shared_mod": LoTDSharedModGrower, "concat": LoTDSharedModGrower,
    "mixed": LoTDMixedGrower,
}


def get_lotd_grower(type: str, z_dim: int, meta: LoDMeta, **kwargs):
    """The grower registry."""
    t = type.lower()
    if t not in _GROWERS:
        raise ValueError(f"Unknown grower type {type!r}; "
                         f"have {sorted(_GROWERS)}")
    return _GROWERS[t](z_dim, meta, **kwargs)
