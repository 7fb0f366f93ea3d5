"""The classic LoTD grid encoding, plain PyTorch (port of
nr3d_lib_tpu/ops/lotd.py; the JAX package computes it in XLA, with no
Pallas kernel, and so does the port on any device).

Eight per-level decomposition types over multi-level grids with per-axis
("cuboid") resolutions:

  Dense / Hash          : 2^D-corner multilinear gather-interpolate
  VectorMatrix (VM)     : Σ_axis  lerp(line_axis) · bilerp(plane_⊥axis)
  VecZMatXoY            : lerp(line_z) · bilerp(plane_xy)
  CP, CPfast            : Π_axis  lerp(line_axis)
  NPlaneSum             : Σ_axis  bilerp(plane_⊥axis)
  NPlaneMul             : multilinear interp of per-corner Π_axis plane_⊥axis

The loops, the parameter layout and the order of every sum follow the
JAX function, so that the forward agrees with it to the last bits
wherever the arithmetic allows. Where JAX computes in int32 and uint32,
the port computes in int64: a hash multiplies 32-bit halves
(`_mul_u32`), and a gather clamps the flat row over the whole [B·size,
F] level table, as `jnp.take(..., mode="clip")` does (an out-of-domain
point of instance b can read a row of instance b+1).

Every function is differentiable to any order by autograd (`floor` cuts
the gradient, so dt/dx flows through the fractional part only);
`lotd_fwd_dydx` takes one forward-mode product per input dimension
(`torch.func.jvp`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from nr3d_lib_tpu_torch.ops.lotd_brick import HASH_PRIMES
from nr3d_lib_tpu_torch.ops.permuto import _U32, _mul_u32

__all__ = ["LoDType", "LoDMeta", "generate_meta", "lotd_encode",
           "lotd_fwd_dydx", "lotd_bwd_dydx", "level_param_slice",
           "HASH_PRIMES", "str_to_lod_type"]


class LoDType(enum.IntEnum):
    Dense = 0
    VectorMatrix = 1
    VecZMatXoY = 2
    CP = 3
    CPfast = 4
    NPlaneMul = 5
    NPlaneSum = 6
    Hash = 7


_TYPE_ALIASES = {
    "dense": LoDType.Dense,
    "vectormatrix": LoDType.VectorMatrix, "vm": LoDType.VectorMatrix,
    "veczmatxoy": LoDType.VecZMatXoY,
    "cp": LoDType.CP, "cpfast": LoDType.CPfast,
    "nplanemul": LoDType.NPlaneMul,
    "nplane": LoDType.NPlaneSum, "nplanesum": LoDType.NPlaneSum,
    "hash": LoDType.Hash,
}


def str_to_lod_type(s: Union[str, LoDType]) -> LoDType:
    if isinstance(s, LoDType):
        return s
    return _TYPE_ALIASES[s.lower()]


def _level_size(lod_type: LoDType, res: Tuple[int, ...],
                hashmap_size: int) -> int:
    """Number of grid entries (not counting feature width) of one level."""
    d = len(res)
    if lod_type == LoDType.Dense:
        return int(np.prod(res))
    if lod_type in (LoDType.NPlaneMul, LoDType.NPlaneSum):
        assert d >= 2, "NPlane needs >=2 input dims"
        return int(sum(np.prod([res[j] for j in range(d) if j != a])
                       for a in range(d)))
    if lod_type == LoDType.VectorMatrix:
        assert d == 3, "VectorMatrix needs 3D input"
        return int(sum(np.prod([res[j] for j in range(d) if j != a]) + res[a]
                       for a in range(d)))
    if lod_type == LoDType.VecZMatXoY:
        assert d == 3, "VecZMatXoY needs 3D input"
        return res[0] * res[1] + res[2]
    if lod_type in (LoDType.CP, LoDType.CPfast):
        return int(sum(res))
    if lod_type == LoDType.Hash:
        assert hashmap_size > 0, "Hash level needs hashmap_size"
        return min(hashmap_size, int(np.prod(res)))
    raise ValueError(lod_type)


@dataclass(frozen=True)
class LoDMeta:
    """Static level metadata (hashable)."""

    n_dims: int
    level_res: Tuple[Tuple[int, ...], ...]      # [L][D] per-axis resolutions
    level_n_feats: Tuple[int, ...]              # [L]
    level_types: Tuple[LoDType, ...]            # [L]
    hashmap_sizes: Tuple[int, ...]              # [L] (0 for non-hash levels)
    interpolation: str = "linear"               # 'linear' | 'smoothstep'

    @cached_property
    def n_levels(self) -> int:
        return len(self.level_res)

    @cached_property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(_level_size(t, r, h) for t, r, h in
                     zip(self.level_types, self.level_res,
                         self.hashmap_sizes))

    @cached_property
    def level_n_params(self) -> Tuple[int, ...]:
        return tuple(s * f for s, f in zip(self.level_sizes,
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

    @cached_property
    def out_feat_offsets(self) -> Tuple[int, ...]:
        out = [0]
        for f in self.level_n_feats:
            out.append(out[-1] + f)
        return tuple(out)


def generate_meta(n_input_dim: int,
                  lod_res: Sequence[Union[int, Sequence[int]]],
                  lod_n_feats: Union[int, Sequence[int]],
                  lod_types: Union[str, Sequence[str]],
                  hashmap_size: Optional[int] = None,
                  use_smooth_step: bool = False) -> LoDMeta:
    """A LoDMeta from per-level resolutions (an int, or one per axis),
    feature widths and types."""
    n_levels = len(lod_res)
    if isinstance(lod_n_feats, int):
        lod_n_feats = [lod_n_feats] * n_levels
    if isinstance(lod_types, (str, LoDType)):
        lod_types = [lod_types] * n_levels
    res = tuple(tuple([int(r)] * n_input_dim) if np.isscalar(r)
                else tuple(int(v) for v in r) for r in lod_res)
    for rr in res:
        assert len(rr) == n_input_dim
        assert all(v >= 3 for v in rr), "grid resolutions must be >= 3"
    types = tuple(str_to_lod_type(t) for t in lod_types)
    hsizes = tuple(int(hashmap_size or 0) if t == LoDType.Hash else 0
                   for t in types)
    return LoDMeta(n_input_dim, res, tuple(int(f) for f in lod_n_feats),
                   types, hsizes,
                   "smoothstep" if use_smooth_step else "linear")


def level_param_slice(meta: LoDMeta, level: int) -> slice:
    """The flat-parameter slice of one level."""
    return slice(meta.level_offsets[level], meta.level_offsets[level + 1])


# ===================================================================== core
@lru_cache(maxsize=1024)
def _const(values: Tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once per device: a tensor built from
    host values on every call would copy them to the card and wait for
    its stream each time."""
    return torch.tensor(values, dtype=dtype, device=device)


def _pos_fract(x: torch.Tensor, res: Tuple[int, ...], interpolation: str):
    """x [N,D] in [0,1] → (cell [N,D] int64, t [N,D] weights):
    v = x·(res−2) + 0.5 per axis, cell = floor(v)."""
    scale = _const(tuple(float(r - 2) for r in res), x.dtype, x.device)
    v = x * scale + 0.5
    cell = torch.floor(v)
    frac = v - cell.detach()
    if interpolation == "smoothstep":
        t = frac * frac * (3.0 - 2.0 * frac)
    else:
        t = frac
    return cell.to(torch.int64), t


def _gather_rows(table: torch.Tensor, rows: torch.Tensor,
                 bidx: Optional[torch.Tensor], size: int) -> torch.Tensor:
    """table [B·size, F]; rows [N, ...] local indices; bidx [N] or None.
    The flat row is clamped to the table, as `jnp.take(mode="clip")`."""
    if bidx is not None:
        rows = rows + (bidx.to(rows.dtype) * size).reshape(
            (-1,) + (1,) * (rows.dim() - 1))
    return table[torch.clamp(rows, 0, table.shape[0] - 1)]


def _dense_index(cell: torch.Tensor, res: Tuple[int, ...],
                 dims: Sequence[int]) -> torch.Tensor:
    """C-order flat index over the listed dims (first listed = slowest)."""
    idx = cell[..., dims[0]]
    for d in dims[1:]:
        idx = idx * res[d] + cell[..., d]
    return idx


def _hash_index(cell: torch.Tensor, size: int) -> torch.Tensor:
    """The cell's coordinates as uint32 (a negative one wraps to 2^32 −
    |c|), times the primes mod 2^32, xor'ed, mod `size`."""
    u = cell & _U32
    h = _mul_u32(u[..., 0], HASH_PRIMES[0])
    for d in range(1, cell.shape[-1]):
        h = h ^ _mul_u32(u[..., d], HASH_PRIMES[d])
    return h % size


def _corner_offsets(d: int) -> np.ndarray:
    """[2^D, D] binary corner offsets (the first axis slowest)."""
    return np.stack(np.meshgrid(*([np.arange(2)] * d), indexing="ij"),
                    -1).reshape(-1, d)


def _corner_weight(t: torch.Tensor, corner: np.ndarray) -> torch.Tensor:
    """Multilinear weight of one corner. t [N,D] → [N]."""
    w = torch.ones_like(t[..., 0])
    for d, o in enumerate(corner):
        w = w * (t[..., d] if o else (1.0 - t[..., d]))
    return w


def _offset(cell: torch.Tensor, corner) -> torch.Tensor:
    return cell + _const(tuple(int(v) for v in corner), cell.dtype,
                         cell.device)


def _line_interp(table, cell, t, axis: int, line_off: int, bidx, size: int):
    """1D lerp on the line of `axis` stored at entry offset line_off."""
    c = cell[..., axis] + line_off
    f0 = _gather_rows(table, c, bidx, size)
    f1 = _gather_rows(table, c + 1, bidx, size)
    ta = t[..., axis:axis + 1]
    return f0 * (1.0 - ta) + f1 * ta


def _plane_interp(table, cell, t, dims: Sequence[int], res: Tuple[int, ...],
                  plane_off: int, bidx, size: int):
    """Bilinear (or (D−1)-linear) interpolation on the plane over `dims`."""
    n_d = len(dims)
    out = 0.0
    for corner in _corner_offsets(n_d):
        shifted = _offset(cell[..., list(dims)], corner)
        idx = shifted[..., 0]
        for k in range(1, n_d):
            idx = idx * res[dims[k]] + shifted[..., k]
        w = torch.ones_like(t[..., 0])
        for k, o in enumerate(corner):
            td = t[..., dims[k]]
            w = w * (td if o else (1.0 - td))
        out = out + w[..., None] * _gather_rows(table, idx + plane_off, bidx,
                                                size)
    return out


def _encode_level(x: torch.Tensor, table: torch.Tensor, lod_type: LoDType,
                  res: Tuple[int, ...], size: int, interpolation: str,
                  bidx: Optional[torch.Tensor]) -> torch.Tensor:
    """Encode one level. table [B·size, F] → [N, F]."""
    d = len(res)
    cell, t = _pos_fract(x, res, interpolation)

    if lod_type in (LoDType.Dense, LoDType.Hash):
        # a Hash level whose whole grid fits the table indexes densely
        use_hash = lod_type == LoDType.Hash and int(np.prod(res)) > size
        out = 0.0
        for corner in _corner_offsets(d):
            cc = _offset(cell, corner)
            if use_hash:
                idx = _hash_index(cc, size)
            else:
                idx = _dense_index(cc, res, list(range(d)))
            w = _corner_weight(t, corner)
            out = out + w[..., None] * _gather_rows(table, idx, bidx, size)
        return out

    if lod_type in (LoDType.CP, LoDType.CPfast):
        # layout: lines concatenated in axis order [res0 | res1 | ...]
        out = 1.0
        off = 0
        for a in range(d):
            out = out * _line_interp(table, cell, t, a, off, bidx, size)
            off += res[a]
        return out

    if lod_type == LoDType.NPlaneSum:
        # layout: planes concatenated, plane a skips axis a
        out = 0.0
        off = 0
        for a in range(d):
            dims = [j for j in range(d) if j != a]
            out = out + _plane_interp(table, cell, t, dims, res, off, bidx,
                                      size)
            off += int(np.prod([res[j] for j in dims]))
        return out

    if lod_type == LoDType.NPlaneMul:
        # the planes share coordinates: interpolate the per-corner product
        plane_offs = []
        off = 0
        for a in range(d):
            plane_offs.append(off)
            off += int(np.prod([res[j] for j in range(d) if j != a]))
        out = 0.0
        for corner in _corner_offsets(d):
            cc = _offset(cell, corner)
            prod = 1.0
            for a in range(d):
                dims = [j for j in range(d) if j != a]
                idx = cc[..., dims[0]]
                for k in dims[1:]:
                    idx = idx * res[k] + cc[..., k]
                prod = prod * _gather_rows(table, idx + plane_offs[a], bidx,
                                           size)
            w = _corner_weight(t, corner)
            out = out + w[..., None] * prod
        return out

    if lod_type == LoDType.VectorMatrix:
        # layout: [line0 | line1 | line2 | plane⊥0 | plane⊥1 | plane⊥2]
        line_offs, off = [], 0
        for a in range(d):
            line_offs.append(off)
            off += res[a]
        out = 0.0
        for a in range(d):
            dims = [j for j in range(d) if j != a]
            line = _line_interp(table, cell, t, a, line_offs[a], bidx, size)
            plane = _plane_interp(table, cell, t, dims, res, off, bidx, size)
            out = out + line * plane
            off += int(np.prod([res[j] for j in dims]))
        return out

    if lod_type == LoDType.VecZMatXoY:
        # layout: [line_z (res2) | plane_xy]
        line = _line_interp(table, cell, t, 2, 0, bidx, size)
        plane = _plane_interp(table, cell, t, (0, 1), res, res[2], bidx, size)
        return line * plane

    raise ValueError(lod_type)


def lotd_encode(x: torch.Tensor, params: torch.Tensor, meta: LoDMeta,
                bidx: Optional[torch.Tensor] = None,
                max_level: Optional[Union[int, torch.Tensor]] = None,
                level_weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Multi-level LoTD encoding.

    x [N, D] in [0, 1]; params [n_params] flat, or [B, n_params] batched
    (then `bidx` [N] is required, and bidx < 0 gives zero features);
    levels above `max_level` (an int or a 0-d tensor) give zeros;
    `level_weights` [L] scales each level. Returns [N, Σ level_n_feats].
    """
    assert x.shape[-1] == meta.n_dims
    batched = params.dim() == 2
    if batched:
        assert bidx is not None, "2D params require bidx"
    valid = None
    if bidx is not None:
        valid = bidx >= 0
        bidx = torch.clamp(bidx, min=0)
    xc = x.to(params.dtype)

    outs = []
    for l in range(meta.n_levels):
        size = meta.level_sizes[l]
        nf = meta.level_n_feats[l]
        off = meta.level_offsets[l]
        if batched:
            table = params[:, off:off + size * nf].reshape(
                params.shape[0] * size, nf)
        else:
            table = params[off:off + size * nf].reshape(size, nf)
        y = _encode_level(xc, table, meta.level_types[l], meta.level_res[l],
                          size, meta.interpolation,
                          bidx if batched else None)
        if max_level is not None:
            if isinstance(max_level, torch.Tensor):
                y = y * (l <= max_level).to(y.dtype)
            else:
                y = y * float(l <= max_level)
        if level_weights is not None:
            y = y * level_weights[l].to(y.dtype)
        outs.append(y)
    out = torch.cat(outs, -1)
    if valid is not None:
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
    return out


def lotd_fwd_dydx(x: torch.Tensor, params: torch.Tensor, meta: LoDMeta,
                  **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y [N, F], dy/dx [N, F, D]) by one forward-mode product per input
    dimension; `kw` as `lotd_encode`."""
    def f(xx):
        return lotd_encode(xx, params, meta, **kw)

    y = f(x)
    tangents = []
    for dim in range(meta.n_dims):
        seed = torch.zeros_like(x)
        seed[..., dim] = 1.0
        _, dy = torch.func.jvp(f, (x,), (seed,))
        tangents.append(dy)
    return y, torch.stack(tangents, -1)


def lotd_bwd_dydx(dL_dy: torch.Tensor, dy_dx: torch.Tensor,
                  x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nablas dL/dx = Σ_f dL/dy_f · dy_f/dx; its backward is autograd's."""
    return torch.einsum("...f,...fd->...d", dL_dy, dy_dx)
