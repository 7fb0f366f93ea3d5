"""Chunked execution of per-point functions (port of
nr3d_lib_tpu/ops/chunking.py).

JAX needs these to cap a Pallas kernel's points per call, and has two
forms: a `lax.scan` that compiles the body once and an unrolled loop that
overlaps chunks. A CUDA launch takes any N, so the port's ops do not
chunk; these functions remain for callers that bound their memory by
chunking. In PyTorch both forms are the same Python loop, and both names
are kept.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["scan_chunks", "loop_chunks"]


def loop_chunks(body: Callable, per_point: Sequence[torch.Tensor], n0: int,
                max_chunk: int, sum_init: Sequence[torch.Tensor] = (),
                pad_values: Sequence[float] = ()
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Run `body(*chunks)` over ⌈n0/max_chunk⌉ chunks of `max_chunk` rows.

    per_point: tensors with leading dim n0, split along dim 0; the last
    chunk is padded to `max_chunk` rows with zeros (or `pad_values[i]`,
    e.g. 0.5 to keep padded positions mid-domain). body(*chunk) returns
    (per_point_outs, summed_outs): per-point outputs (leading dim
    max_chunk) are concatenated over the chunks and cut back to n0;
    summed outputs (e.g. dL/dtable) are added to `sum_init`, chunk by
    chunk in order.
    """
    pv = tuple(pad_values) + (0.0,) * (len(per_point) - len(pad_values))
    sums = tuple(sum_init)
    parts = None
    for start in range(0, n0, max_chunk):
        chunk = []
        for a, v in zip(per_point, pv):
            c = a[start:start + max_chunk]
            if c.shape[0] < max_chunk:
                pad = (0, 0) * (a.ndim - 1) + (0, max_chunk - c.shape[0])
                c = F.pad(c, pad, value=v)
            chunk.append(c)
        pp, sm = body(*chunk)
        sums = tuple(c + s for c, s in zip(sums, sm))
        if parts is None:
            parts = [[p] for p in pp]
        else:
            for ps, p in zip(parts, pp):
                ps.append(p)
    outs = tuple(torch.cat(ps, 0)[:n0] for ps in (parts or []))
    return outs, sums


def scan_chunks(body: Callable, per_point: Sequence[torch.Tensor], n0: int,
                max_chunk: int, sum_init: Sequence[torch.Tensor] = (),
                pad_values: Sequence[float] = ()
                ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """`loop_chunks` by JAX's other name (its `lax.scan` form, which JAX's
    backward paths use)."""
    return loop_chunks(body, per_point, n0, max_chunk, sum_init, pad_values)
