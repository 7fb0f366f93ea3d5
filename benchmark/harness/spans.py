"""The arithmetic of the per-layer metrics read from the program's own
spans and counters (`nr3d_lib_tpu_torch.profile`'s ring), after the
traced window.

A unit is one `step` or `frame` span with the spans under it; the ring
holds the last spans of the run, set-up's included, most of them
untraced. A reading is the median over the units the ring holds whole:
where the ring is full, a unit that began before its oldest span closed
may have lost children, and is left out. A program without the ring
(`profile.spans`) gives nothing to read: every reader returns None."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Iterable, List, Optional


def recorded():
    """The ring's spans, oldest first, and whether it is full; None where
    the program keeps no ring."""
    from nr3d_lib_tpu_torch import profile

    read = getattr(profile, "spans", None)
    if read is None:
        return None
    spans = read()
    return spans, len(spans) >= profile.RING_SPANS


def units(spans: List, full: bool, root: str) -> List[List]:
    """Each whole unit named `root`: its root span first, then every span
    under it."""
    under: Dict[int, List] = {}
    roots = []
    for s in spans:
        top = s
        while top.parent is not None:
            top = top.parent
        if top is s:
            if s.name == root:
                roots.append(s)
        elif top.name == root:
            under.setdefault(id(top), []).append(s)
    oldest = min((s.t1 for s in spans), default=0)
    return [[r] + under.get(id(r), []) for r in roots
            if not full or r.t0 >= oldest]


def _units(root: str) -> Optional[List[List]]:
    ring = recorded()
    return (units(*ring, root) or None) if ring is not None else None


def median_per_unit(root: str, value: Callable[[List], float]
                    ) -> Optional[float]:
    """The median over the whole units of `value(unit's spans)`."""
    found = _units(root)
    if found is None:
        return None
    return float(statistics.median(value(u) for u in found))


def host_ms(names: Iterable[str]) -> Callable[[List], float]:
    """A unit's host ms in the spans of these names."""
    names = set(names)
    return lambda unit: sum(s.t1 - s.t0 for s in unit
                            if s.name in names) * 1e-6


def syncs(unit: List) -> float:
    """A unit's host waits for the device, every span's."""
    return float(sum(s.syncs for s in unit))


def span_ms(root: str, name: str) -> Optional[float]:
    """The median host ms of the spans `name` inside whole units `root`."""
    found = _units(root)
    if found is None:
        return None
    ms = [(s.t1 - s.t0) * 1e-6 for u in found for s in u if s.name == name]
    return float(statistics.median(ms)) if ms else None


def kept_share(root: str) -> Optional[float]:
    """Percent: the samples the compacting queries kept over their final
    slots, Σ kept / Σ slots over the `query` spans inside whole units
    `root` (one device read for all of them)."""
    import torch

    found = _units(root)
    if found is None:
        return None
    qs = [s for u in found for s in u if s.name == "query" and s.slots]
    if not qs:
        return None
    kept = float(torch.stack([s.kept for s in qs]).sum())
    return 100.0 * kept / sum(s.slots for s in qs)
