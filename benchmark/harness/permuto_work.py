"""The work of the F=4 cell permutohedral lattice, counted from the calls'
rows as `yardstick.brick4_work` counts the brick's, and the arithmetic of
the per-layer metrics that read it (`mfu.dyn`, `permuto_roofline.dyn`).

The calls are the configured encoding's (`counters.Counters`): its
encodes ("fwd", with their backward where the step backpropagates) and
its nablas ("nablas", with their backward, the second order, under the
eikonal loss). The table is `counted.encoding_table`: its levels, rows
and the lattice's input dims."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from harness import yardstick as Y
from harness.readers import Context, untraced_s

N_FEAT = 4


def search_ops(d: int) -> int:
    """Operations that put one point in its simplex at one level: the
    elevation (d products by the scale, d by the factors, d − 1 suffix
    adds, d products and d differences: 5d − 1), the rounding to the
    remainder-0 point (4 a coordinate: divide, ceil, floor, select) and
    its sum (d + 1), the ranking (d(d+1) compares), the barycentric
    weights (2 a coordinate for the remainder, 2 for the signed adds, 2
    for the first weight), the cell index (a product and a xor a
    coordinate, the modulo and the row: 2d + 2) and the vertices' slots
    (d(d+1) compares)."""
    dp1 = d + 1
    return (5 * d - 1) + 4 * dp1 + dp1 + d * dp1 + (4 * dp1 + 2) + \
        (2 * d + 2) + d * dp1


def permuto4_work(kind: str, n: int, d: int, levels: int, rows: int,
                  need_dx: bool = False) -> Tuple[float, float]:
    """(bytes, float ops) of one call of the lattice's four kinds of
    encoding work at n points of d dims, `levels` levels and a table of
    `rows` rows (packed: 128 float32 words a row; its gradient unpacked:
    256). Bytes count each input once and each output once; ops are the
    simplex search a (point, level) and then, at each of its d + 1
    vertices:

    - "fwd", the encode: x in, features out, the table once; a weight
      times each of the F values and its add (2F).
    - "bwd", its backward: x and dL/dy in, dL/dtable out; 2F a vertex
      (the weight times each gradient, the atomic add). With dL/dx: the
      packed table in and dL/dx out, 2F more a vertex and the
      elevation's vjp (6 a coordinate).
    - "dydx", the nablas: dL/dh and x in, dL/dx out, the table once; 2F
      a vertex for the value-gradient product, 2 for its ranked
      difference, and the elevation's vjp.
    - "bwd2", the nablas' backward: dL/dh, x and dL/dx in, dL/d(dL/dh)
      and dL/dtable out, the table once; 4F + 2 a vertex and the
      elevation's vjp."""
    per_level = n * levels
    s, v, vjp = search_ops(d), d + 1, 6 * d
    x, y = 4 * d, 4 * N_FEAT * levels
    table, dtab = rows * 128 * 4, rows * 256 * 4
    if kind == "fwd":
        return n * (x + y) + table, per_level * (s + v * 2 * N_FEAT)
    if kind == "bwd":
        ops = s + v * 2 * N_FEAT
        if need_dx:
            return n * (x + y + x) + table + dtab, \
                per_level * (ops + v * 2 * N_FEAT + vjp)
        return n * (x + y) + dtab, per_level * ops
    if kind == "dydx":
        return n * (y + x + x) + table, \
            per_level * (s + v * (2 * N_FEAT + 2) + vjp)
    if kind == "bwd2":
        return n * (y + x + x + y) + table + dtab, \
            per_level * (s + v * (4 * N_FEAT + 2) + vjp)
    raise ValueError(f"unknown piece of encoding work {kind!r}")


def pieces(call) -> List[str]:
    """The kinds of encoding work a counted call needed."""
    return {"fwd": ["fwd"] + (["bwd"] if call.grad else []),
            "nablas": ["dydx"] + (["bwd2"] if call.grad else [])
            }.get(call.kind, [])


def work(ctx: Context, call, kinds=None) -> List[Tuple[float, float]]:
    """(bytes, ops) of each piece of the call's work, of `kinds` only
    where given."""
    tab = ctx.counted["encoding_table"]
    return [permuto4_work(k, call.rows, tab["dims"], tab["levels"],
                          tab["rows"], call.need_dx)
            for k in pieces(call) if kinds is None or k in kinds]


def flops(ctx: Context) -> float:
    """Operations the stretches' calls needed: every Linear layer's
    2·in·out a row (× 3 with its backward), the decoder's input-gradient
    pass for each nablas row (× 3 under the eikonal loss), and the
    lattice's four kinds of encoding work."""
    model = ctx.run.model
    per_row = {p: Y.mlp_flops_per_row(tuple(w.shape) for w in
                                       model.get_submodule(p).ws)
               for p in ctx.counted["mlps"]}
    nab = per_row.get(ctx.counted.get("nablas_mlp"), 0)
    total = 0.0
    for c in ctx.trace.calls:
        times = 3 if c.grad else 1
        if c.kind == "mlp":
            total += c.rows * per_row[c.module] * times
        elif c.kind == "nablas":
            total += c.rows * nab * times
        total += sum(ops for _, ops in work(ctx, c))
    return total


def mfu(ctx: Context) -> Optional[float]:
    """Percent of the float32 peak over the untraced wall time of the
    stretches' units; None where no call was counted."""
    f, wall = flops(ctx), untraced_s(ctx)
    if f <= 0 or not wall:
        return None
    return 100.0 * f / (wall * Y.F32_OPS_PER_S)


def kernel_roofline(ctx: Context, kernel_re: str, kinds
                    ) -> Optional[float]:
    """Percent: the least time of the counted work of `kinds` over the
    device time of the kernels whose name matches `kernel_re`; None where
    either is missing."""
    pat = re.compile(kernel_re)
    dev_s = ctx.trace.device_s(lambda name: bool(pat.search(name)))
    bound = sum(Y.bound_s(*w) for c in ctx.trace.calls
                for w in work(ctx, c, kinds))
    return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None
