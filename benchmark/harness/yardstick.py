"""The yardstick: the H100's published peaks, the least time of a piece
of work, and the work the cells' layers need, counted from their shapes.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores
(the program multiplies float32 with TF32 off, PyTorch's default, and
the benchmark never turns TF32 on). A bound counts each input byte read
once and each output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time of the work: bytes over the bandwidth or operations
    over the float32 peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def brick4_work(kind: str, n: int, levels: int, rows: int,
                need_dx: bool = False) -> Tuple[float, float]:
    """(bytes, float ops) of one call of the F=4 brick encoding's four
    pieces of work at n points, `levels` levels and a table of `rows`
    rows (packed: 128 float32 words a row; its gradient unpacked: 256).

    - "fwd", the encode: x in, features out, the table once; each (point,
      level) 3 axes × 4 index ops + 8 corners × (2 weight products + 4
      products + 4 adds) = 92 ops.
    - "bwd", its backward: x and dL/dy in, dL/dtable out (+ dL/dx in and
      the corner words when x needs its gradient); 92 ops, + 8 × 16.
    - "dydx", the nablas: x and dL/dh in, dL/dx out, the table once; 8
      corners × (7 for g·val + 3 axes × 3) + 12 index + 3 scale = 146.
    - "bwd2", the nablas' backward: g_up, x and dL/dx in, dL/dg_up and
      dL/dtable out, the table once; 234 ops (+ dL/dx: 434)."""
    L = levels
    table = rows * 128 * 4
    dtab = rows * 256 * 4
    if kind == "fwd":
        return n * (12 + 16 * L) + table, n * L * 92
    if kind == "bwd":
        if need_dx:
            return n * (12 + 16 * L + 64 * L + 12) + dtab, n * L * (92 + 128)
        return n * (12 + 16 * L) + dtab, n * L * 92
    if kind == "dydx":
        return n * (12 + 16 * L + 12) + table, n * L * 146
    if kind == "bwd2":
        io = n * (16 * L + 12 + 12 + 16 * L) + table + dtab
        return (io + n * 12, n * L * 434) if need_dx else (io, n * L * 234)
    raise ValueError(f"unknown piece of encoding work {kind!r}")


def mlp_flops_per_row(shapes: Iterable[Sequence[int]]) -> int:
    """2·in·out for every Linear layer of an MLP, per row."""
    return sum(2 * int(a) * int(b) for a, b in shapes)
