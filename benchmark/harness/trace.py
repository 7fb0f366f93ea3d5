"""Traced stretches of the window: torch.profiler over a steady run of
units, read in memory (no trace file is written).

The profiler records the device's activity only (kernels, memsets,
copies): recording every host operation as well slowed a training step
by half and left the traced program another than the measured one. A
profiler session at times loses the device events of its first
kernels, so each session first launches PRIMERS device sleeps
(`spin_kernel`, left out of every count), waits for them and idles
LEAD_S on the host before the stretch and after it. The traced window
is the stretch's host interval, from its first launch to the end of a
device synchronisation after its last; every device event of the
session but the primers lies in it."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PRIMERS = 8
LEAD_S = 0.05


@dataclass
class Stretch:
    window_s: float
    busy_s: float
    n_device_events: int
    device_s: Dict[str, float]          # device time by operation name
    units: int                          # steps or frames the stretch ran
    gaps: List[Tuple[str, float]]       # (what the gap waited for, seconds)
    calls: list = field(default_factory=list)


def _is_primer(name: str) -> bool:
    return "spin_kernel" in name


def run_stretch(body: Callable[[], None], units: int,
                counters=None) -> Stretch:
    """Trace `body`, which runs `units` steps or frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    if counters is not None:
        counters.take()
        counters.active = True
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMERS):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        time.sleep(LEAD_S)
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        time.sleep(LEAD_S)
    calls = []
    if counters is not None:
        counters.active = False
        calls = counters.take()

    dev = [(e.time_range.start, e.time_range.end, e.name)
           for e in prof.events() if e.device_type == DeviceType.CUDA and
           not getattr(e, "is_user_annotation", False) and
           not _is_primer(e.name)]
    if not dev:
        raise RuntimeError("the trace holds no device event of the stretch")
    device_s: Dict[str, float] = {}
    for s, t, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (t - s) * 1e-6
    busy, gaps = _union_and_gaps(dev)
    busy_s = busy * 1e-6
    inner = [(f"before {name}", (g1 - g0) * 1e-6) for g0, g1, name in gaps]
    edges = window_s - busy_s - sum(g for _, g in inner)
    return Stretch(window_s, busy_s, len(dev), device_s, units,
                   inner + [("the stretch's edges", max(edges, 0.0))],
                   calls)


def _union_and_gaps(dev):
    """The union length of the device intervals [(start, end, name)] (µs)
    and the idle gaps between them [(start, end, the next op's name)]."""
    busy, gaps, cur = 0.0, [], None
    for s, t, name in sorted(dev):
        if cur is not None and s > cur:
            gaps.append((cur, s, name))
        if cur is None or t > cur:
            busy += t - (s if cur is None else max(s, cur))
            cur = t
    return busy, gaps


class Trace:
    """The stretches of one traced run, summed, and the wall seconds a
    unit took in the same run's untraced stretches of its window."""

    def __init__(self, stretches: List[Stretch],
                 untraced_s_per_unit: Optional[float] = None):
        self.stretches = stretches
        self.untraced_s_per_unit = untraced_s_per_unit

    @property
    def window_s(self) -> float:
        return sum(s.window_s for s in self.stretches)

    @property
    def busy_s(self) -> float:
        return sum(s.busy_s for s in self.stretches)

    @property
    def n_device_events(self) -> int:
        return sum(s.n_device_events for s in self.stretches)

    @property
    def units(self) -> int:
        return sum(s.units for s in self.stretches)

    def device_s(self, match: Optional[Callable[[str], bool]] = None
                 ) -> float:
        return sum(t for s in self.stretches for n, t in s.device_s.items()
                   if match is None or match(n))

    @property
    def calls(self) -> list:
        return [c for s in self.stretches for c in s.calls]

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = {}
        for s in self.stretches:
            for n, t in s.device_s.items():
                ops[n] = ops.get(n, 0.0) + t
        gaps: Dict[str, float] = {}
        for s in self.stretches:
            for n, t in s.gaps:
                gaps[n] = gaps.get(n, 0.0) + t
        rank = lambda d: [[n, t] for n, t in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
