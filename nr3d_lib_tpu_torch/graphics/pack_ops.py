"""Pack operators over ragged per-ray sample buffers (port of
nr3d_lib_tpu/graphics/pack_ops.py `budget_indices`, `dense_to_budgeted`,
`mark_pack_boundaries`, `segmented_scan`, `packed_cumprod`, `packed_sum`,
`packed_alpha_to_vw`, `compactify` and `dense_to_packed`).

Two layouts. Row-local budgets: each row of an [R, S] slab keeps its first
B true entries, in order; slots past a row's count are 0 with valid=False.
Computed with a cumsum (the rank of each true entry) and one scatter,
instead of the JAX package's [R,B,S] one-hot contraction, which exists
only for the TPU.

Packed buffers: a flat buffer of static capacity N, `ridx[i]` the pack
(ray) of sample i, packs contiguous and ascending; padding slots carry
`ridx == n_packs` (one sentinel segment that reductions drop), so they
contribute nothing. The scans and sums accumulate in float64 and round
back to the input's dtype, as `graphics._scan` does, so that the CUDA and
the CPU route (which combine in other orders) agree.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["budget_indices", "dense_to_budgeted", "mark_pack_boundaries",
           "segmented_scan", "packed_cumprod", "packed_sum",
           "packed_alpha_to_vw", "compactify", "dense_to_packed"]


def _budget_slots(mask: torch.Tensor, budget: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target slot of every entry ([R,S] int64; `budget` = dropped) and
    valid [R,B]."""
    rank = torch.cumsum(mask.to(torch.int64), -1)                # [R,S]
    slot = torch.where(mask & (rank <= budget), rank - 1,
                       torch.full_like(rank, budget))
    target = torch.arange(1, budget + 1, device=mask.device)
    valid = rank[:, -1:] >= target[None, :]
    return slot, valid


def _scatter(a: torch.Tensor, slot: torch.Tensor, budget: int
             ) -> torch.Tensor:
    """[R,S,...] → [R,B,...]: entry k of row r lands in slot[r,k]; the
    spare column B collects the dropped entries and is cut off."""
    r = a.shape[0]
    idx = slot.reshape(slot.shape + (1,) * (a.dim() - 2)).expand_as(a)
    out = torch.zeros((r, budget + 1) + tuple(a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    return out.scatter(1, idx, a)[:, :budget]


def budget_indices(mask: torch.Tensor, budget: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """mask [R, S] → (idx [R, B] int32, valid [R, B] bool): for each row,
    the positions of its first `budget` True entries; idx is 0 where valid
    is False."""
    slot, valid = _budget_slots(mask, budget)
    k = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)
    return _scatter(k.expand_as(slot), slot, budget), valid


def dense_to_budgeted(arrays: Sequence[torch.Tensor], mask: torch.Tensor,
                      budget: int
                      ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Budget-compact several [R, S, ...] arrays row-locally → [R, B, ...]
    (+ valid [R, B]). Slots past a row's count are 0 with valid=False."""
    slot, valid = _budget_slots(mask, budget)
    return tuple(_scatter(a, slot, budget) for a in arrays), valid


# ------------------------------------------------------------ packed buffers
def mark_pack_boundaries(ridx: torch.Tensor) -> torch.Tensor:
    """True at the first sample of each pack."""
    return torch.cat([torch.ones_like(ridx[:1], dtype=torch.bool),
                      ridx[1:] != ridx[:-1]])


def _bshape(flag: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (ref.dim() - flag.dim()))


def segmented_scan(vals: torch.Tensor, is_start: torch.Tensor,
                   op: Callable = torch.add, reverse: bool = False
                   ) -> torch.Tensor:
    """Inclusive segmented scan over dim 0 with an associative `op`: the
    combine ((fa, va) ⊕ (fb, vb)) = (fa | fb, vb if fb else op(va, vb)),
    applied in log2(N) doubling steps (Hillis–Steele; the JAX version's
    `associative_scan` takes another tree). Floating values are combined
    in float64 and returned in their dtype."""
    flags = is_start
    if reverse:
        vals = vals.flip(0)
        flags = torch.cat([torch.ones_like(is_start[:1]),
                           is_start.flip(0)[:-1]])
    out_dtype = vals.dtype
    v = vals.to(torch.float64) if vals.is_floating_point() else vals
    f = flags
    n, k = v.shape[0], 1
    while k < n:
        # element i combines the running value of element i − k before it
        v = torch.cat([v[:k], torch.where(_bshape(f[k:], v[k:]), v[k:],
                                          op(v[:-k], v[k:]))])
        f = torch.cat([f[:k], f[k:] | f[:-k]])
        k *= 2
    v = v.to(out_dtype)
    return v.flip(0) if reverse else v


def packed_cumprod(feats: torch.Tensor, ridx: torch.Tensor,
                   exclusive: bool = False) -> torch.Tensor:
    """Per-pack cumulative product along dim 0."""
    start = mark_pack_boundaries(ridx)
    if exclusive:
        shifted = torch.cat([torch.ones_like(feats[:1]), feats[:-1]])
        feats = torch.where(_bshape(start, feats), torch.ones_like(feats),
                            shifted)
    return segmented_scan(feats, start, op=torch.mul)


def packed_sum(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int
               ) -> torch.Tensor:
    """Per-pack sum [n_packs, ...]; padding (ridx == n_packs) is dropped."""
    acc = torch.zeros((n_packs + 1,) + tuple(feats.shape[1:]),
                      dtype=torch.float64, device=feats.device)
    acc = acc.index_add(0, ridx.to(torch.int64), feats.to(torch.float64))
    return acc[:n_packs].to(feats.dtype)


def packed_alpha_to_vw(alpha: torch.Tensor, ridx: torch.Tensor
                       ) -> torch.Tensor:
    """Visibility weights vw_i = α_i · Π_{j<i in pack} (1 − α_j)."""
    trans = packed_cumprod(torch.clamp(1.0 - alpha, 0.0, 1.0), ridx,
                           exclusive=True)
    return alpha * trans


def compactify(keep: torch.Tensor, arrays: Sequence[torch.Tensor],
               ridx: torch.Tensor, n_packs: int,
               capacity: Optional[int] = None
               ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Order-preserving compaction of packed buffers: the samples where
    `keep` holds (and that are not padding) move to the front, in order;
    the rest of the `capacity` slots are 0 with ridx == n_packs. Kept
    samples past the capacity are dropped."""
    if capacity is None:
        capacity = keep.shape[0]
    keep = keep & (ridx < n_packs)
    pos = torch.cumsum(keep.to(torch.int64), 0) - 1
    tgt = torch.where(keep & (pos < capacity), pos,
                      torch.full_like(pos, capacity))

    def scatter(a, fill):
        out = torch.full((capacity + 1,) + tuple(a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        idx = _bshape(tgt, a).expand_as(a)
        return out.scatter(0, idx, a)[:capacity]

    return tuple(scatter(a, 0) for a in arrays), scatter(ridx, n_packs)


def dense_to_packed(dense: torch.Tensor, mask: torch.Tensor,
                    capacity: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense [R, S, ...] (+ mask [R, S]) → packed flat buffer [capacity,
    ...] (+ ridx int32), compacted in row-major order."""
    r_count, s_count = mask.shape
    flat = dense.reshape((r_count * s_count,) + tuple(dense.shape[2:]))
    ridx = torch.arange(r_count, dtype=torch.int32,
                        device=mask.device).repeat_interleave(s_count)
    (out,), new_ridx = compactify(mask.reshape(-1), [flat], ridx, r_count,
                                  capacity=capacity)
    return out, new_ridx
