"""What a cell's driver does whatever its kind: the measured window and
the traced one over its unit of work (a training step or a frame)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from harness import program
from harness.counters import Counters
from harness.trace import Trace, run_stretch


class Driver:
    """Subclasses set up the program (`setup`), run one unit (`unit`),
    count the failed units of a window (`failed`), give the window's
    end-to-end metrics (`metrics`), free the program (`free_program`)
    and check what it produced (`check`, `control`)."""

    def __init__(self, cell, seed: int, device: torch.device,
                 traced: bool = False):
        self.cell, self.seed, self.dev = cell, seed, device
        self.traced = traced
        self.counters: Optional[Counters] = None

    def window(self, seconds: float) -> dict:
        """Units back to back for `seconds`, then a device sync."""
        program.sync(self.dev)
        program.reset_peak(self.dev)
        out = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out.append(self.unit())
        program.sync(self.dev)
        elapsed = time.perf_counter() - t0
        return {"attempted": len(out), "failed": self.failed(out),
                "metrics": self.metrics(out, elapsed),
                "peak": program.peak_bytes(self.dev)}

    def traced_window(self, seconds: float) -> dict:
        """The window with the traffic's `stretches` traced stretches of
        `stretch_units` units each, evenly spaced in it. The units run
        between the stretches give the untraced seconds a unit takes."""
        tr = self.cell.traffic
        k, per = tr["stretches"], tr["stretch_units"]
        stretches, out = [], []
        program.sync(self.dev)
        program.reset_peak(self.dev)
        t0 = time.perf_counter()
        traced_s = 0.0
        for i in range(k):
            while time.perf_counter() - t0 < seconds * (i + 1) / (k + 1):
                out.append(self.unit())
            program.sync(self.dev)
            ts = time.perf_counter()
            stretches.append(run_stretch(
                lambda: out.extend(self.unit() for _ in range(per)),
                per, self.counters))
            traced_s += time.perf_counter() - ts
        while time.perf_counter() - t0 < seconds:
            out.append(self.unit())
        program.sync(self.dev)
        untraced = len(out) - k * per
        per_unit = (time.perf_counter() - t0 - traced_s) / untraced \
            if untraced else None
        return {"attempted": len(out), "failed": self.failed(out),
                "trace": Trace(stretches, per_unit),
                "peak": program.peak_bytes(self.dev)}

    def unit(self):
        raise NotImplementedError

    def failed(self, out: List) -> int:
        raise NotImplementedError

    def metrics(self, out: List, elapsed: float) -> Dict[str, float]:
        raise NotImplementedError
