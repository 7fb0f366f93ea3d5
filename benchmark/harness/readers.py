"""The arithmetic the per-layer metric readers share. A reader is
`metrics/<name>.py` with `read(ctx) -> float | None`; it returns None
where its stretch holds nothing to read, and the harness then leaves the
metric out of the line."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

from harness import yardstick as Y


@dataclass
class Context:
    cell: object        # spec.Cell
    trace: object       # trace.Trace over the traced stretches
    run: object         # the TrainCell or RenderCell, its model still live

    @property
    def counted(self) -> dict:
        return self.cell.config["counted"]

    def rays(self) -> int:
        """Rays the stretches rendered or trained."""
        tr = self.cell.traffic
        if tr["kind"] == "train":
            return self.trace.units * tr["rays_per_step"]
        h, w = tr["camera"]["hw"]
        return self.trace.units * h * w


def untraced_s(ctx: Context) -> Optional[float]:
    """The wall seconds the traced stretches' units take untraced: the
    profiler slows the host (a traced training step ~35% longer on the
    H100 even recording the device's activity only), so shares of wall
    time are taken over the run's untraced units' pace."""
    per, n = ctx.trace.untraced_s_per_unit, ctx.trace.units
    return per * n if per and n else None


def device_idle(ctx: Context) -> Optional[float]:
    """Percent of the untraced wall time of the stretches' units in which
    no kernel, memset or copy of theirs ran on the device."""
    wall = untraced_s(ctx)
    if not wall:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / wall)


def events_per_unit(ctx: Context) -> Optional[float]:
    """Device events (kernels, memsets, copies) per step or frame that
    the traced stretches ran."""
    n = ctx.trace.units
    return ctx.trace.n_device_events / n if n else None


def samples_per_ray(ctx: Context) -> Optional[float]:
    """Points the field encoded per ray (every encode call's rows)."""
    rays = ctx.rays()
    pts = sum(c.rows for c in ctx.trace.calls if c.kind == "fwd")
    return pts / rays if rays and pts else None


def encoding_work(ctx: Context, call):
    """(bytes, ops) of each piece of encoding work a call needed: the
    encode and its backward where it ran, the nablas and theirs."""
    tab = ctx.counted["encoding_table"]
    pieces = {"fwd": ["fwd"] + (["bwd"] if call.grad else []),
              "nablas": ["dydx"] + (["bwd2"] if call.grad else [])
              }.get(call.kind, [])
    return [Y.brick4_work(p, call.rows, tab["levels"], tab["rows"],
                          call.need_dx) for p in pieces]


def encoding_bound_s(ctx: Context) -> float:
    """Least time of the encoding work the stretches' calls needed."""
    return sum(Y.bound_s(*w) for c in ctx.trace.calls
               for w in encoding_work(ctx, c))


def encode_roofline(ctx: Context, kernel_re: str) -> Optional[float]:
    """Percent: the encoding work's least time over the device time of
    the kernels whose name matches `kernel_re`."""
    pat = re.compile(kernel_re)
    dev_s = ctx.trace.device_s(lambda n: bool(pat.search(n)))
    bound = encoding_bound_s(ctx)
    return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None


def flops(ctx: Context) -> float:
    """Float operations the stretches' calls needed: 2·in·out a row for
    every Linear layer a call passes (× 3 where its backward runs: the
    input and weight gradients); for each nablas call the configured
    decoder's input-gradient pass (× 3 where the eikonal loss
    differentiates it again); and the encoding's own operations."""
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
        total += sum(ops for _, ops in encoding_work(ctx, c))
    return total


def mfu(ctx: Context) -> Optional[float]:
    """Percent of the float32 peak over the untraced wall time of the
    stretches' units."""
    f, wall = flops(ctx), untraced_s(ctx)
    if f <= 0 or not wall:
        return None
    return 100.0 * f / (wall * Y.F32_OPS_PER_S)
