"""Row-local budget compaction (port of nr3d_lib_tpu/graphics/pack_ops.py
`budget_indices` and `dense_to_budgeted`).

Semantics: each row keeps its first B true entries, in order; slots past a
row's count are 0 with valid=False. Computed with a cumsum (the rank of
each true entry) and one scatter, instead of the JAX package's [R,B,S]
one-hot contraction, which exists only for the TPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["budget_indices", "dense_to_budgeted"]


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
