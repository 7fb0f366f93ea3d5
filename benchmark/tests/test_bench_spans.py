"""The per-layer metrics read from the program's span ring: each of the
nine readers on a hand-built ring (its median over the units, its
share), None on an empty ring and on a program without the ring, and a
unit that a full ring may have cut out of the reading."""

from types import SimpleNamespace

import pytest
import torch

from harness import spans as S
from harness import spec

MS = 1_000_000
READERS = ["query_host_ms.train", "backward_host_ms.train",
           "optimizer_ms.train", "occ_update_ms.train",
           "host_syncs_per_step.train", "kept_share.train",
           "host_syncs_per_frame.render", "to_host_ms.render",
           "kept_share.render"]


def _span(name, parent, t0, ms, syncs=0, slots=0, kept=None, unit=None):
    unit = parent.unit if unit is None and parent is not None else unit
    return SimpleNamespace(name=name, parent=parent, unit=unit, t0=t0,
                           t1=t0 + int(ms * MS), syncs=syncs, slots=slots,
                           kept=kept)


def _step(it, query_ms, backward_ms, clip_ms, adam_ms, kept, update_ms=None):
    """A step's spans in the order they close, the step last."""
    t = it * 1000 * MS
    step = _span("step", None, t, 900, unit=it)
    out = []
    if update_ms is not None:
        life = _span("step.lifecycle", step, t, update_ms + 1)
        out += [_span("occ.update", life, t, update_ms, syncs=2), life]
    fwd = _span("step.forward", step, t + 100 * MS, query_ms + 1)
    q = _span("query", fwd, t + 100 * MS, query_ms, slots=100,
              kept=torch.tensor(kept))
    out += [_span("query.field", q, t + 101 * MS, 1), q, fwd,
            _span("step.backward", step, t + 400 * MS, backward_ms,
                  syncs=1),
            _span("step.clip", step, t + 600 * MS, clip_ms),
            _span("step.optimizer", step, t + 700 * MS, adam_ms), step]
    return out


def _frame(i, to_host_ms, assemble_ms, kept):
    t = (10_000 + i * 1000) * MS
    frame = _span("frame", None, t, 900, unit=i)
    chunk = _span("frame.chunk", frame, t + 10 * MS, 50)
    q = _span("query", chunk, t + 11 * MS, 40, slots=200,
              kept=torch.tensor(kept))
    return [_span("frame.rays", frame, t, 1, syncs=1), q, chunk,
            _span("frame.to_host", frame, t + 100 * MS, to_host_ms,
                  syncs=3),
            _span("frame.assemble", frame, t + 300 * MS, assemble_ms),
            frame]


def _ring():
    return (_step(0, 20, 5, 2, 1, 60, update_ms=3) +
            _step(1, 10, 7, 3, 1, 80) + _step(2, 12, 6, 2, 2, 90) +
            _frame(0, 60, 2, 50) + _frame(1, 70, 3, 10) +
            _frame(2, 80, 1, 30))


@pytest.fixture
def ring(monkeypatch):
    from nr3d_lib_tpu_torch import profile

    held = []
    monkeypatch.setattr(profile, "spans", lambda: list(held))
    return held


def _read(name):
    return spec.load_reader(name)(None)


def test_readers_on_a_hand_built_ring(ring):
    ring.extend(_ring())
    want = {"query_host_ms.train": 12.0,          # of 20, 10, 12
            "backward_host_ms.train": 6.0,        # of 5, 7, 6
            "optimizer_ms.train": 4.0,            # of 3, 4, 4
            "occ_update_ms.train": 3.0,           # the one update
            "host_syncs_per_step.train": 1.0,     # of 3, 1, 1
            "kept_share.train": 100 * 230 / 300,
            "host_syncs_per_frame.render": 4.0,   # 1 + 3 each
            "to_host_ms.render": 73.0,            # of 62, 73, 81
            "kept_share.render": 100 * 90 / 600}
    for name in READERS:
        assert _read(name) == pytest.approx(want[name]), name


def test_readers_on_an_empty_ring(ring):
    assert [_read(name) for name in READERS] == [None] * len(READERS)


def test_readers_without_the_ring(monkeypatch):
    from nr3d_lib_tpu_torch import profile

    monkeypatch.delattr(profile, "spans")
    assert [_read(name) for name in READERS] == [None] * len(READERS)


def test_a_full_ring_reads_whole_units_only():
    spans = _ring()
    steps = S.units(spans, False, "step")
    assert [u[0].unit for u in steps] == [0, 1, 2]
    assert len(steps[0]) == 9 and len(steps[1]) == 7
    # the ring dropped step 0's first spans: what a full ring holds of
    # step 0 began before the oldest span it still holds had closed
    cut = spans[2:]
    assert [u[0].unit for u in S.units(cut, True, "step")] == [1, 2]
    assert [u[0].unit for u in S.units(cut, False, "step")] == [0, 1, 2]
    assert [u[0].unit for u in S.units(spans, True, "frame")] == [0, 1, 2]
