"""Pack operators over ragged per-ray sample buffers (port of
nr3d_lib_tpu/graphics/pack_ops.py, every name of its `__all__`).

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
the CPU route (which combine in other orders) agree; `packed_cumsum` is a
float64 global cumsum less each pack's offset (JAX's trick in float32,
which loses the low bits of a pack's sums to the buffer's total).

Sorts are lexicographic and stable, as `lax.sort(..., num_keys=k,
is_stable=True)`: a stable `argsort` by the minor key, then by each more
major key in turn (`stable=True` always: CUDA's default sort is not
stable). `packed_max`/`packed_min` give an empty pack the dtype's lowest
or highest value, as `jax.ops.segment_max`/`segment_min` do.

The perturbed step samplers take a `draw` (`graphics.raysample.Draw`) in
place of JAX's key. Where JAX's version is known to be wrong (ROADMAP.md
§C), the port does the right thing and says so in the docstring:
`interleave_sample_step_wrt_depth_clamped` and its packed-segments form
return, when perturbed, the forward differences of the jittered t (JAX
returns the step from before the jitter), and `intersect1d_unique` keeps
the padding sentinels out of its membership masks.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from nr3d_lib_tpu_torch.device import resolve_device

__all__ = [
    "get_pack_infos_from_boundary", "get_pack_infos_from_first",
    "get_pack_infos_from_n", "get_pack_infos_from_batch",
    "mark_pack_boundaries", "budget_indices", "dense_to_budgeted",
    "counts_from_ridx", "ridx_from_counts", "offsets_from_counts",
    "interleave_arange_simple", "interleave_linstep",
    "packed_add", "packed_sub", "packed_mul", "packed_div", "packed_gt",
    "packed_geq", "packed_lt", "packed_leq", "packed_eq", "packed_neq",
    "packed_sum", "packed_mean", "packed_max", "packed_min",
    "packed_cumsum", "packed_cumprod", "packed_diff", "packed_backward_diff",
    "packed_sort", "packed_searchsorted", "packed_invert_cdf",
    "packed_alpha_to_vw", "packed_tau_to_vw",
    "packed_volume_render_compression",
    "compactify", "packed_to_dense", "dense_to_packed",
    "merge_two_packs_sorted_aligned", "try_merge_two_packs_sorted_aligned",
    "merge_two_batch", "packed_matmul", "segmented_scan",
    "packed_sort_inplace", "packed_searchsorted_packed_vals",
    "interleave_arange", "interleave_linspace",
    "interleave_sample_step_wrt_depth_clamped",
    "interleave_sample_step_wrt_depth_in_packed_segments",
    "merge_two_packs_sorted", "merge_two_packs_sorted_a_includes_b",
    "merge_two_batch_a_includes_b", "expand_pack_boundary",
    "octree_mark_consecutive_segments", "intersect1d_unique",
]


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


# =============================================================== pack_infos
def _segment_ids(ridx: torch.Tensor, n_packs: int) -> torch.Tensor:
    """ridx as int64 segment ids in [0, n_packs]: ids outside are sent to
    the dropped padding segment n_packs, as `jax.ops.segment_*` drops
    them."""
    r = ridx.to(torch.int64)
    return torch.where((r < 0) | (r > n_packs), torch.full_like(r, n_packs),
                       r)


def counts_from_ridx(ridx: torch.Tensor, n_packs: int) -> torch.Tensor:
    """Samples per pack [n_packs] (padding dropped), in ridx's dtype."""
    acc = torch.zeros(n_packs + 1, dtype=torch.int64, device=ridx.device)
    acc = acc.index_add(0, _segment_ids(ridx, n_packs),
                        torch.ones_like(ridx, dtype=torch.int64))
    return acc[:n_packs].to(ridx.dtype)


def offsets_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum: the first index of each pack."""
    return (torch.cumsum(counts, 0) - counts).to(counts.dtype)


def get_pack_infos_from_n(counts: torch.Tensor) -> torch.Tensor:
    """[n_packs, 2] (first, count) from per-pack counts."""
    return torch.stack([offsets_from_counts(counts), counts], -1)


def get_pack_infos_from_first(first: torch.Tensor,
                              total: Union[int, torch.Tensor]
                              ) -> torch.Tensor:
    """[n_packs, 2] (first, count) from the packs' first indices and the
    buffer's total."""
    tot = torch.as_tensor(total, dtype=first.dtype,
                          device=first.device).reshape(1)
    nxt = torch.cat([first[1:], tot])
    return torch.stack([first, nxt - first], -1)


def get_pack_infos_from_boundary(boundary: torch.Tensor) -> torch.Tensor:
    """boundary [N] bool (marks at pack starts) → pack_infos [N, 2]: the
    marked indices in order, then N (count 0) in the unused rows."""
    n = boundary.shape[0]
    pos = torch.cumsum(boundary.to(torch.int64), 0) - 1
    tgt = torch.where(boundary, pos, torch.full_like(pos, n))
    first = torch.full((n + 1,), n, dtype=torch.int64, device=boundary.device)
    first = first.scatter(0, tgt, torch.arange(n, device=boundary.device))
    return get_pack_infos_from_first(first[:n], n)


def get_pack_infos_from_batch(n_batches: int, n_per_batch: int,
                              dtype=torch.int32, device=None
                              ) -> torch.Tensor:
    """[n_batches, 2] (first, count) of equal packs."""
    first = torch.arange(n_batches, dtype=dtype,
                         device=resolve_device(device)) * n_per_batch
    return torch.stack([first, torch.full_like(first, n_per_batch)], -1)


def ridx_from_counts(counts: torch.Tensor, capacity: int,
                     n_packs: Optional[int] = None) -> torch.Tensor:
    """Per-pack counts → a flat ridx [capacity] int32: pack i occupies
    [first_i, first_i + count_i), the rest is padding (n_packs)."""
    if n_packs is None:
        n_packs = counts.shape[0]
    first = offsets_from_counts(counts).to(torch.int64)
    pos = torch.arange(capacity, device=counts.device)
    ridx = torch.searchsorted(first, pos, right=True) - 1
    total = first[-1] + counts[-1] if counts.shape[0] > 0 else 0
    return torch.where(pos < total, ridx,
                       torch.full_like(ridx, n_packs)).to(torch.int32)


# ============================================================== interleave
def interleave_arange_simple(counts: torch.Tensor, capacity: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed [0, count_i) aranges → (vals int32, ridx int32)."""
    n_packs = counts.shape[0]
    ridx = ridx_from_counts(counts, capacity, n_packs)
    first = offsets_from_counts(counts).to(torch.int64)
    first_pad = torch.cat([first, first.new_zeros(1)])
    r = torch.clamp(ridx.to(torch.int64), max=n_packs)
    pos = torch.arange(capacity, device=counts.device) - first_pad[r]
    pos = torch.where(ridx < n_packs, pos, torch.zeros_like(pos))
    return pos.to(torch.int32), ridx


def interleave_linstep(start: torch.Tensor, counts: torch.Tensor,
                       step: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed start_i + k·step_i sequences → (vals, ridx)."""
    k, ridx = interleave_arange_simple(counts, capacity)
    n_packs = counts.shape[0]
    sp = torch.cat([start, start.new_zeros(1)])
    st = torch.cat([step, step.new_zeros(1)])
    i = torch.clamp(ridx.to(torch.int64), max=n_packs)
    return sp[i] + k.to(start.dtype) * st[i], ridx


def interleave_arange(start: torch.Tensor, stop: torch.Tensor, step,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed [start_i, stop_i) aranges with a per-pack (or shared) step:
    count_i = ceil((stop_i − start_i) / step_i), at least 0."""
    step = torch.as_tensor(step, dtype=start.dtype,
                           device=start.device).expand(start.shape)
    counts = torch.ceil((stop - start) / step).to(torch.int32)
    counts = torch.clamp(counts, min=0)
    return interleave_linstep(start, counts, step, capacity)


def interleave_linspace(start: torch.Tensor, stop: torch.Tensor, num_steps,
                        capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed linspace(start_i, stop_i, n_i): step (stop − start) /
    max(n − 1, 1); `num_steps` an int or a per-pack tensor."""
    if not isinstance(num_steps, torch.Tensor) or num_steps.dim() == 0:
        num_steps = torch.full(start.shape, int(num_steps),
                               dtype=torch.int32, device=start.device)
    denom = torch.clamp(num_steps - 1, min=1).to(start.dtype)
    return interleave_linstep(start, num_steps.to(torch.int32),
                              (stop - start) / denom, capacity)


# ===================================================== broadcast arithmetic
def _broadcast_pack(pack_vals: torch.Tensor, ridx: torch.Tensor,
                    n_packs: int) -> torch.Tensor:
    """Per-pack values gathered to the samples; padding gathers zeros."""
    padded = torch.cat([pack_vals, pack_vals.new_zeros(
        (1,) + tuple(pack_vals.shape[1:]))])
    return padded[torch.clamp(ridx.to(torch.int64), max=n_packs)]


def _packed_binop(op: Callable, doc: str):
    def fn(feats: torch.Tensor, pack_vals: torch.Tensor, ridx: torch.Tensor,
           n_packs: Optional[int] = None) -> torch.Tensor:
        if n_packs is None:
            n_packs = pack_vals.shape[0]
        other = _broadcast_pack(pack_vals, ridx, n_packs)
        if feats.dim() > other.dim():
            other = other.reshape(other.shape +
                                  (1,) * (feats.dim() - other.dim()))
        return op(feats, other)

    fn.__doc__ = f"feats {doc} its pack's value (padding: 0)."
    return fn


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a / torch.where(b == 0, torch.ones_like(b), b)


packed_add = _packed_binop(torch.add, "+")
packed_sub = _packed_binop(torch.sub, "−")
packed_mul = _packed_binop(torch.mul, "×")
packed_div = _packed_binop(_safe_div, "÷ (÷ 1 where it is 0)")
packed_gt = _packed_binop(torch.gt, ">")
packed_geq = _packed_binop(torch.ge, "≥")
packed_lt = _packed_binop(torch.lt, "<")
packed_leq = _packed_binop(torch.le, "≤")
packed_eq = _packed_binop(torch.eq, "==")
packed_neq = _packed_binop(torch.ne, "!=")


# ================================================================ reductions
def packed_mean(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int
                ) -> torch.Tensor:
    """Per-pack mean [n_packs, ...]; an empty pack's is 0 (its count is
    clamped to 1)."""
    s = packed_sum(feats, ridx, n_packs)
    n = counts_from_ridx(ridx, n_packs).to(s.dtype)
    n = torch.clamp(n, min=1).reshape((n_packs,) + (1,) * (feats.dim() - 1))
    return s / n


def _packed_extreme(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int,
                    reduce: str) -> torch.Tensor:
    if feats.is_floating_point():
        init = float("-inf") if reduce == "amax" else float("inf")
    elif feats.dtype == torch.bool:
        init = reduce != "amax"
    else:
        info = torch.iinfo(feats.dtype)
        init = info.min if reduce == "amax" else info.max
    out = torch.full((n_packs + 1,) + tuple(feats.shape[1:]), init,
                     dtype=feats.dtype, device=feats.device)
    idx = _bshape(_segment_ids(ridx, n_packs), feats).expand_as(feats)
    return out.scatter_reduce(0, idx, feats, reduce,
                              include_self=True)[:n_packs]


def packed_max(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int
               ) -> torch.Tensor:
    """Per-pack maximum; an empty pack gets the dtype's lowest value (−inf
    for floats), as `jax.ops.segment_max`."""
    return _packed_extreme(feats, ridx, n_packs, "amax")


def packed_min(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int
               ) -> torch.Tensor:
    """Per-pack minimum; an empty pack gets the dtype's highest value."""
    return _packed_extreme(feats, ridx, n_packs, "amin")


# ======================================================== cumulative / diff
def _pack_start_index(ridx: torch.Tensor) -> torch.Tensor:
    """For every sample, the index of its pack's first sample."""
    start = mark_pack_boundaries(ridx)
    i = torch.arange(ridx.shape[0], device=ridx.device)
    return torch.cummax(torch.where(start, i, torch.zeros_like(i)),
                        0).values


def packed_cumsum(feats: torch.Tensor, ridx: torch.Tensor,
                  exclusive: bool = False) -> torch.Tensor:
    """Per-pack cumulative sum along dim 0 (exclusive: the sum before each
    sample). Floats accumulate in float64 and round back."""
    if feats.shape[0] == 0:
        return feats.clone()
    acc = torch.float64 if feats.is_floating_point() else torch.int64
    v = feats.to(acc)
    csum = torch.cumsum(v, 0)
    excl = csum - v
    offset = excl[_pack_start_index(ridx)]
    return ((excl if exclusive else csum) - offset).to(feats.dtype)


def packed_diff(feats: torch.Tensor, ridx: torch.Tensor,
                pad_value: float = 0.0,
                pack_last_fill: Optional[torch.Tensor] = None,
                n_packs: Optional[int] = None) -> torch.Tensor:
    """out[i] = feats[i+1] − feats[i] within a pack; a pack's last sample
    gets `pad_value`, or `pack_last_fill[pack] − feats[i]`."""
    nxt = torch.cat([feats[1:], feats[-1:]])
    same = torch.cat([ridx[1:] == ridx[:-1],
                      torch.zeros_like(ridx[:1], dtype=torch.bool)])
    diff = nxt - feats
    if pack_last_fill is not None:
        if n_packs is None:
            n_packs = pack_last_fill.shape[0]
        fill = _broadcast_pack(pack_last_fill, ridx, n_packs) - feats
    else:
        fill = torch.full_like(feats, pad_value)
    return torch.where(_bshape(same, diff), diff, fill)


def packed_backward_diff(feats: torch.Tensor, ridx: torch.Tensor,
                         pad_value: float = 0.0,
                         pack_first_fill: Optional[torch.Tensor] = None,
                         n_packs: Optional[int] = None) -> torch.Tensor:
    """out[i] = feats[i] − feats[i−1] within a pack; a pack's first sample
    gets `pad_value`, or `feats[i] − pack_first_fill[pack]`."""
    prev = torch.cat([feats[:1], feats[:-1]])
    start = mark_pack_boundaries(ridx)
    diff = feats - prev
    if pack_first_fill is not None:
        if n_packs is None:
            n_packs = pack_first_fill.shape[0]
        fill = feats - _broadcast_pack(pack_first_fill, ridx, n_packs)
    else:
        fill = torch.full_like(feats, pad_value)
    return torch.where(_bshape(start, diff), fill, diff)


# ============================================================ sort / search
def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts by keys[0], then keys[1], …, stably
    (`lax.sort(keys, num_keys=len(keys), is_stable=True)`)."""
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def packed_sort(key: torch.Tensor, ridx: torch.Tensor,
                *payload: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sort each pack by key, stably; padding (ridx == n_packs) stays at
    the end → (key, ridx, *payload) sorted."""
    perm = _lexsort(ridx, key)
    return (key[perm], ridx[perm]) + tuple(p[perm] for p in payload)


packed_sort_inplace = packed_sort


def packed_searchsorted(bins: torch.Tensor, bins_ridx: torch.Tensor,
                        vals: torch.Tensor, vals_ridx: torch.Tensor,
                        n_packs: int, side: str = "right") -> torch.Tensor:
    """For each val, its insertion index into its own pack's sorted bins,
    as an absolute index into the flat `bins` buffer (int32): the number
    of bins that sort before it by (ridx, value), bins with an equal value
    counted for side "right" and not for "left". One stable merge sort of
    bins and vals, as the JAX version."""
    nb, nv = bins.shape[0], vals.shape[0]
    dev = bins.device
    is_val = torch.cat([torch.zeros(nb, dtype=torch.int64, device=dev),
                        torch.ones(nv, dtype=torch.int64, device=dev)])
    tag = is_val if side == "right" else 1 - is_val
    perm = _lexsort(torch.cat([bins_ridx, vals_ridx]).to(torch.int64),
                    torch.cat([bins, vals]), tag)
    s_isval = is_val[perm]
    bins_before = torch.cumsum(1 - s_isval, 0)
    out = torch.zeros(nv + 1, dtype=torch.int64, device=dev)
    tgt = torch.where(s_isval == 1, perm - nb, torch.full_like(perm, nv))
    out = out.scatter(0, tgt, torch.where(s_isval == 1, bins_before,
                                          torch.zeros_like(bins_before)))
    return out[:nv].to(torch.int32)


packed_searchsorted_packed_vals = packed_searchsorted


def packed_invert_cdf(bins: torch.Tensor, cdfs: torch.Tensor,
                      bins_ridx: torch.Tensor, u: torch.Tensor,
                      u_ridx: torch.Tensor, n_packs: int,
                      eps: float = 1e-8) -> torch.Tensor:
    """Inverse-CDF samples: for each u in its pack, t with CDF(t) = u by
    linear interpolation of the pack's (bins, cdfs)."""
    hi = packed_searchsorted(cdfs, bins_ridx, u, u_ridx, n_packs,
                             side="right").to(torch.int64)
    hi = torch.clamp(hi, 1, bins.shape[0] - 1)
    lo = hi - 1
    c0, c1, b0, b1 = cdfs[lo], cdfs[hi], bins[lo], bins[hi]
    denom = torch.where(torch.abs(c1 - c0) < eps, torch.ones_like(c0),
                        c1 - c0)
    return b0 + torch.clamp((u - c0) / denom, 0.0, 1.0) * (b1 - b0)


# =========================================================== volume render
def packed_tau_to_vw(tau: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """From optical depth per sample: vw = (1 − e^−τ) · e^−Σ_{j<i} τ_j."""
    alpha = 1.0 - torch.exp(-tau)
    return alpha * torch.exp(-packed_cumsum(tau, ridx, exclusive=True))


def packed_volume_render_compression(alpha: torch.Tensor, ridx: torch.Tensor,
                                     n_packs: int,
                                     early_stop_eps: float = 1e-4
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, vw): keep marks the non-padding samples whose transmittance
    before them is still above `early_stop_eps` (the rest contribute
    nothing and can be compacted away); vw the visibility weights."""
    trans = packed_cumprod(torch.clamp(1.0 - alpha, 0.0, 1.0), ridx,
                           exclusive=True)
    keep = (trans > early_stop_eps) & (ridx < n_packs)
    return keep, alpha * trans


# ================================================================ structural
def packed_to_dense(feats: torch.Tensor, ridx: torch.Tensor, n_packs: int,
                    max_per_pack: int, pad_value: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed buffer → (dense [n_packs, max_per_pack, ...], mask): a pack's
    samples past `max_per_pack` and the padding are dropped."""
    pos = packed_cumsum(torch.ones_like(ridx, dtype=torch.int64), ridx) - 1
    valid = (ridx < n_packs) & (pos < max_per_pack)
    r = torch.where(valid, ridx.to(torch.int64),
                    torch.full_like(pos, n_packs))
    p = torch.where(valid, pos, torch.zeros_like(pos))
    dense = torch.full((n_packs + 1, max_per_pack) + tuple(feats.shape[1:]),
                       pad_value, dtype=feats.dtype, device=feats.device)
    dense = dense.index_put((r, p), feats)
    mask = torch.zeros((n_packs + 1, max_per_pack), dtype=torch.bool,
                       device=feats.device).index_put((r, p), valid)
    return dense[:n_packs], mask[:n_packs]


def merge_two_packs_sorted_aligned(valsA: torch.Tensor, keyA: torch.Tensor,
                                   ridxA: torch.Tensor, valsB: torch.Tensor,
                                   keyB: torch.Tensor, ridxB: torch.Tensor,
                                   n_packs: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor, torch.Tensor]:
    """Merge two sorted packed buffers into one sorted by (ridx, key), A's
    samples before B's on a tie → (vals, key, ridx, from_B int32). The
    ridx design indexes packs globally, so the packs of A and B need not
    be the same set: `merge_two_packs_sorted`, `..._a_includes_b` and
    `try_...` are this same merge."""
    key = torch.cat([keyA, keyB])
    ridx = torch.cat([ridxA, ridxB])
    vals = torch.cat([valsA, valsB])
    is_b = torch.cat([torch.zeros(keyA.shape[0], dtype=torch.int32,
                                  device=key.device),
                      torch.ones(keyB.shape[0], dtype=torch.int32,
                                 device=key.device)])
    perm = _lexsort(ridx, key)
    return vals[perm], key[perm], ridx[perm], is_b[perm]


try_merge_two_packs_sorted_aligned = merge_two_packs_sorted_aligned
merge_two_packs_sorted = merge_two_packs_sorted_aligned
merge_two_packs_sorted_a_includes_b = merge_two_packs_sorted_aligned


def packed_matmul(feats: torch.Tensor, mats: torch.Tensor,
                  ridx: torch.Tensor, n_packs: Optional[int] = None
                  ) -> torch.Tensor:
    """out[i] = mats[ridx[i]] @ feats[i]: feats [N, D], mats [P, O, D] →
    [N, O]; padding rows 0."""
    if n_packs is None:
        n_packs = mats.shape[0]
    m = mats[torch.clamp(ridx.to(torch.int64), max=n_packs - 1)]
    out = torch.einsum("nod,nd->no", m, feats)
    return torch.where((ridx < n_packs)[:, None], out, torch.zeros_like(out))


def merge_two_batch(valsA: torch.Tensor, keyA: torch.Tensor,
                    valsB: torch.Tensor, keyB: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge dense per-row sorted sets [R, Sa] and [R, Sb] (vals [R, S] or
    [R, S, C]) → (vals, key, from_B) sorted along each row, stably."""
    key = torch.cat([keyA, keyB], -1)
    is_b = torch.cat([torch.zeros_like(keyA, dtype=torch.int32),
                      torch.ones_like(keyB, dtype=torch.int32)], -1)
    chans = valsA.dim() > keyA.dim()
    vals = torch.cat([valsA, valsB], -2 if chans else -1)
    order = torch.argsort(key, dim=-1, stable=True)
    idx = order[..., None].expand(vals.shape) if chans else order
    return (torch.gather(vals, order.dim() - 1, idx),
            torch.gather(key, -1, order), torch.gather(is_b, -1, order))


def merge_two_batch_a_includes_b(valsA: torch.Tensor, nidxA: torch.Tensor,
                                 valsB: torch.Tensor, nidxB: torch.Tensor,
                                 n_packs: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    """Merge the rows valsB [Nb, Sb] into the rows of valsA [Na, Sa] with
    the same pack ids (nidx) → the packed merged buffer (vals, key =
    vals, ridx over n_packs, from_B); rows of A without a B row keep their
    own samples."""
    na, sa = valsA.shape
    nb, sb = valsB.shape
    ra = torch.clamp(nidxA, max=n_packs)[:, None].expand(na, sa).reshape(-1)
    rb = torch.clamp(nidxB, max=n_packs)[:, None].expand(nb, sb).reshape(-1)
    a, b = valsA.reshape(-1), valsB.reshape(-1)
    return merge_two_packs_sorted_aligned(a, a, ra.to(torch.int32), b, b,
                                          rb.to(torch.int32), n_packs)


# ======================================================= depth-step samplers
def _depth_clamped_steps(t0: torch.Tensor, n_steps: int, dt_gamma: float,
                         min_step_size: float, max_step_size: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t_{k+1} = t_k + clamp(γ·t_k, min, max) from t0 [R] → (t [R, S],
    dt [R, S])."""
    ts, dts = [], []
    t = t0
    for _ in range(n_steps):
        dt = torch.clamp(t * dt_gamma, min_step_size, max_step_size)
        ts.append(t)
        dts.append(dt)
        t = t + dt
    return torch.stack(ts, -1), torch.stack(dts, -1)


def _jitter(t: torch.Tensor, dt: torch.Tensor, in_range_of, draw
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """t + u·dt with u = draw(t.shape, 0, 1), then dt re-differenced: each
    sample's interval runs to the next jittered sample while that one is
    in range (`in_range_of(t)` [R, S]), and the last in-range sample keeps
    its step, so the intervals partition [t_0, the last t + dt)."""
    t = t + draw(tuple(t.shape), 0.0, 1.0) * dt
    nxt = torch.cat([t[:, 1:] - t[:, :-1], dt[:, -1:]], -1)
    in_next = torch.cat([in_range_of(t)[:, 1:],
                         torch.zeros_like(t[:, :1], dtype=torch.bool)], -1)
    return t, torch.where(in_next, nxt, dt)


def interleave_sample_step_wrt_depth_clamped(
        near: torch.Tensor, far: torch.Tensor, max_steps: int = 512,
        dt_gamma: float = 0.01, min_step_size: float = 0.01,
        max_step_size: float = 1.0, step_size_factor: float = 1.0,
        draw=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth-proportional steps from near toward far: dt = clamp(γ·t, min,
    max)·factor → flat (t [R·S], dt [R·S], ridx [R·S]), ridx == R past
    each ray's far. `draw` jitters each t by U[0,1)·dt; then dt is the
    forward difference of the jittered t within the ray, its last sample
    keeping its step (the JAX version keeps the pre-jitter steps, so its
    intervals overlap and leave gaps: ROADMAP.md §C)."""
    dt_gamma *= step_size_factor
    min_step_size *= step_size_factor
    max_step_size *= step_size_factor
    r = near.shape[0]
    t, dt = _depth_clamped_steps(near, max_steps, dt_gamma, min_step_size,
                                 max_step_size)

    def in_range_of(tt):
        return tt < far[:, None]

    if draw is not None:
        t, dt = _jitter(t, dt, in_range_of, draw)
    ray = torch.arange(r, dtype=torch.int32, device=near.device)[:, None]
    ridx = torch.where(in_range_of(t), ray, torch.full_like(ray, r))
    return t.reshape(-1), dt.reshape(-1), ridx.reshape(-1)


def interleave_sample_step_wrt_depth_in_packed_segments(
        near: torch.Tensor, far: torch.Tensor, entry: torch.Tensor,
        exit_: torch.Tensor, seg_ridx: torch.Tensor, n_rays: int,
        steps_per_segment: int = 32, dt_gamma: float = 0.01,
        min_step_size: float = 0.01, max_step_size: float = 1e10,
        step_size_factor: float = 1.0, draw=None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth-proportional steps inside ray segments (entry/exit_ [M],
    seg_ridx [M] their rays, n_rays for padding) → flat (t, dt, ridx,
    sidx), each [M·steps_per_segment]; padding ridx == n_rays, sidx == M.

    The output is segment-major, as the JAX version's: a ray with several
    segments has its samples in several runs, and padding lies between
    them. Compact it (`compactify`) or sort it (`packed_sort`) before an
    operator that needs contiguous packs. `draw` jitters as in
    `interleave_sample_step_wrt_depth_clamped`, the intervals
    re-differenced within each segment."""
    dt_gamma *= step_size_factor
    min_step_size *= step_size_factor
    max_step_size *= step_size_factor
    m = entry.shape[0]
    t0 = torch.maximum(entry, _broadcast_pack(near, seg_ridx, n_rays))
    t, dt = _depth_clamped_steps(t0, steps_per_segment, dt_gamma,
                                 min_step_size, max_step_size)
    t_hi = torch.minimum(exit_, _broadcast_pack(far, seg_ridx, n_rays))
    live = (seg_ridx < n_rays)[:, None]

    def in_range_of(tt):
        return (tt < t_hi[:, None]) & live

    if draw is not None:
        t, dt = _jitter(t, dt, in_range_of, draw)
    in_range = in_range_of(t)
    ray = torch.clamp(seg_ridx, max=n_rays).to(torch.int32)[:, None]
    ridx = torch.where(in_range, ray, torch.full_like(ray, n_rays))
    seg = torch.arange(m, dtype=torch.int32, device=entry.device)[:, None]
    sidx = torch.where(in_range, seg, torch.full_like(seg, m))
    return t.reshape(-1), dt.reshape(-1), ridx.reshape(-1), sidx.reshape(-1)


# ==================================================================== marks
def expand_pack_boundary(pack_boundary: torch.Tensor, num_samples: int
                         ) -> torch.Tensor:
    """Marks per entry → marks at entry·num_samples of the expanded
    buffer [N·num_samples]."""
    n = pack_boundary.shape[0]
    out = torch.zeros(n * num_samples + 1, dtype=torch.bool,
                      device=pack_boundary.device)
    i = torch.arange(n, device=pack_boundary.device) * num_samples
    idx = torch.where(pack_boundary, i, torch.full_like(i, n * num_samples))
    return out.index_fill(0, idx, True)[:n * num_samples]


def octree_mark_consecutive_segments(pidx: torch.Tensor, ridx: torch.Tensor
                                     ) -> torch.Tensor:
    """True at the first sample of each run of equal (ray, node) pairs."""
    new_node = torch.cat([torch.ones_like(pidx[:1], dtype=torch.bool),
                          pidx[1:] != pidx[:-1]])
    return mark_pack_boundaries(ridx) | new_node


def intersect1d_unique(a: torch.Tensor, b: torch.Tensor, n_max: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a, b: sorted unique ids, padded to a static length with the sentinel
    (the dtype's largest int, or inf). → (in_both_a [len a] bool,
    in_both_b [len b] bool, union [n_max] sorted, sentinel-padded). The
    padding is kept out of both masks (the JAX version marks a's padding
    as in b when both are padded: ROADMAP.md §C)."""
    sentinel = float("inf") if a.is_floating_point() else \
        torch.iinfo(a.dtype).max
    in_b = torch.isin(a, b) & (a != sentinel)
    in_a = torch.isin(b, a) & (b != sentinel)
    cat = torch.cat([a, torch.where(in_a, torch.full_like(b, sentinel), b)])
    return in_b, in_a, torch.sort(cat).values[:n_max]
