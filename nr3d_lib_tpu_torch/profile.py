"""Hierarchical profiler and span recorder: a host wall-time tree whose
nodes also annotate the device trace (port of nr3d_lib_tpu/profile.py),
and an always-on ring of the spans the program opens.

`Profiler(warmup, record_frames, record_depth, then, sync)`, the
`@profile` decorator or `with profile("name"):` context, `debug_profile`
and `device_trace` keep JAX's names. Every scope opens a span:

* it always goes into a bounded ring of the calling thread
  (`RING_SPANS`, the oldest dropped first), which `spans()` reads
  without clearing: its name, its parent span, its unit (the training
  step's `it` or the renderer's frame number, the parent's where not
  given), its start and end, and the counters charged to it
  (`count_sync`, `count_backward_sync`, `mark_kept`, `mark_fused`,
  `count`); a backward's span (`backward_scope`) goes into the ring of
  the thread that ran its forward;
* it feeds a `Profiler`'s tree while that profiler records (`report()`);
  `sync=True` calls `torch.cuda.synchronize()` at node exit, so a node's
  host time covers the device work it queued;
* while a `torch.profiler` session is on, and only then, it is a
  record-function range as well, so a trace taken by `device_trace` (or
  any session recording host activity) carries the span names, as
  `jax.named_scope` does in an XLA trace.

Spans are stamped in ns on `time.time_ns()`, the clock torch.profiler
stamps its events with (`kineto_results.trace_start_ns()`, an event's
`start_ns()`), so a span and the device work it queued share one
timeline. Outside a profiler session a span costs two clock reads, a
list and a ring append.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Profiler", "profile", "debug_profile", "get_default_profiler",
           "enable_profiling", "device_trace", "Span", "spans",
           "count_sync", "count_backward_sync", "mark_kept", "mark_fused",
           "count", "backward_scope", "RING_SPANS"]

# spans each thread keeps: 50 s of the F=4 NeuS training step (~2,000
# steps of ~21 spans) or of 800² frames (~670 of ~13) fit with room
RING_SPANS = 65_536
_now = time.time_ns


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        count_sync()
        torch.cuda.synchronize()


class _Thread:
    """One thread's recorder state: its ring of closed span records (the
    oldest dropped first), its innermost open one, and its scopes by
    name."""
    __slots__ = ("ring", "cur", "scopes")

    def __init__(self):
        self.ring: Deque[list] = collections.deque(maxlen=RING_SPANS)
        self.cur: Optional[list] = None
        self.scopes: Dict[str, _Scope] = {}


_local = threading.local()


def _thread() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        state = _local.state = _Thread()
        _local.scopes = state.scopes
        return state


class ProfileNode:
    __slots__ = ("name", "parent", "children", "total", "count")

    def __init__(self, name: str, parent: Optional["ProfileNode"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, ProfileNode] = {}
        self.total = 0.0
        self.count = 0

    def child(self, name: str) -> "ProfileNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = ProfileNode(name, self)
        return node


# A span's record while it is open and in the ring, a list (the cheapest
# object to make): [name, unit, parent record, t0, t1, syncs, slots,
# kept, fused, record_function or None, Profiler node or None, named
# counts or None]. `spans()` turns records into `Span`s.
class _Scope:
    """A scope of one name (and unit) of the thread that made it, which
    `with` enters any number of times, nested too: each entry opens a
    record and each exit closes it into the thread's ring."""
    __slots__ = ("name", "unit", "state")

    def __init__(self, name: str, unit: Optional[int], state: _Thread):
        self.name, self.unit, self.state = name, unit, state

    def __enter__(self):
        state = self.state
        rec = [self.name, self.unit, state.cur, 0, 0, 0, 0, None, 0, None,
               None, None]
        if _autograd_profiler._is_profiler_enabled:
            rf = rec[9] = _RecordFunctionFast(self.name)
            rf.__enter__()
        state.cur = rec
        rec[3] = _now()

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        state = self.state
        rec = state.cur
        rec[4] = t1
        if rec[9] is not None:
            rec[9].__exit__(exc_type, exc, tb)
        state.cur = rec[2]
        state.ring.append(rec)
        return False

    def __call__(self, fn):
        """As a decorator: the span around every call of `fn`."""
        name, unit = self.name, self.unit

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with profile(name, unit):
                return fn(*args, **kwargs)

        return wrapped


class _TreeScope(_Scope):
    """A scope that also feeds `prof`'s tree while it records."""
    __slots__ = ("prof",)

    def __init__(self, name: str, unit: Optional[int], prof: "Profiler"):
        super().__init__(name, unit, _thread())
        self.prof = prof

    def __enter__(self):
        super().__enter__()
        prof = self.prof
        if prof.recording:
            node = self.state.cur[10] = prof._cur.child(self.name)
            prof._cur, prof._depth = node, prof._depth + 1

    def __exit__(self, exc_type, exc, tb):
        prof, rec = self.prof, self.state.cur
        node = rec[10]
        if node is not None and prof.sync:
            _sync()
        super().__exit__(exc_type, exc, tb)
        if node is not None:
            node.total += (rec[4] - rec[3]) * 1e-9
            node.count += 1
            prof._cur, prof._depth = node.parent, prof._depth - 1
        return False

    def __call__(self, fn):
        name, unit, prof = self.name, self.unit, self.prof

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _TreeScope(name, unit, prof):
                return fn(*args, **kwargs)

        return wrapped


class Span:
    """A span as `spans()` gives it: its `name`; its `parent` span (None
    at the top); its `unit`, the step or frame it belongs to (its
    parent's where not given); `t0` and `t1`, ns on torch.profiler's
    clock (`t1` 0 while open); `syncs`, the host's waits for the device
    charged to it and not to a child; `slots` and `kept`, a query's
    final sample slots (a host int) and the tensor that counts those
    holding a sample (on the device: read only where a reader asks);
    `fused`, the marches in it that ran as one march-and-budget kernel
    (a host int: 0 where the march took the dense route); `counts`, its
    named counters (`count`: host ints, a query's `samples` say)."""
    __slots__ = ("name", "parent", "unit", "t0", "t1", "syncs", "slots",
                 "kept", "fused", "counts")

    def __init__(self, rec: list, parent: Optional["Span"]):
        self.name, self.parent = rec[0], parent
        self.unit = rec[1] if rec[1] is not None or parent is None else \
            parent.unit
        self.t0, self.t1, self.syncs, self.slots, self.kept, self.fused = \
            rec[3:9]
        self.counts = rec[11] or {}


def spans() -> List[Span]:
    """The calling thread's closed spans that the ring still holds, in the
    order they closed (a parent after its children). Not cleared."""
    made: Dict[int, Span] = {}

    def span(rec: list) -> Span:
        s = made.get(id(rec))
        if s is None:
            up = rec[2]
            s = made[id(rec)] = Span(rec, None if up is None else span(up))
        return s

    return [span(rec) for rec in list(_thread().ring)]


def count_sync(n: int = 1) -> None:
    """Charge `n` host waits for the device to the innermost open span."""
    cur = _thread().cur
    if cur is not None:
        cur[5] += n


def count_backward_sync(t: torch.Tensor) -> None:
    """The backward of the op that made `t` waits for the device once:
    charge it, when it runs, to the span then innermost open in this
    thread (autograd runs a card's backward in a thread of its own while
    this one waits in `backward()`)."""
    state = _thread()

    def charge(grad):
        cur = state.cur
        if cur is not None:
            cur[5] += 1

    t.register_hook(charge)


def mark_kept(slots: int, kept: torch.Tensor) -> None:
    """Give the innermost open span a query's final sample slots and the
    tensor that counts those holding a sample."""
    cur = _thread().cur
    if cur is not None:
        cur[6], cur[7] = slots, kept


def count(name: str, n: int) -> None:
    """Add `n` (a host int) to the counter `name` of the innermost open
    span."""
    cur = _thread().cur
    if cur is not None:
        counts = cur[11]
        if counts is None:
            counts = cur[11] = {}
        counts[name] = counts.get(name, 0) + n


class _BackwardScope:
    """A span entered in the thread that runs a backward (autograd runs a
    card's backward in a thread of its own) and recorded in the ring of
    the thread that made the scope in the forward, under the span open
    there when the backward runs (`step.backward` while `loss.backward()`
    waits)."""
    __slots__ = ("name", "state", "rec")

    def __init__(self, name: str, state: _Thread):
        self.name, self.state, self.rec = name, state, None

    def __enter__(self):
        rec = self.rec = [self.name, None, self.state.cur, 0, 0, 0, 0, None,
                          0, None, None, None]
        if _autograd_profiler._is_profiler_enabled:
            rf = rec[9] = _RecordFunctionFast(self.name)
            rf.__enter__()
        rec[3] = _now()

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec[4] = _now()
        if rec[9] is not None:
            rec[9].__exit__(exc_type, exc, tb)
        self.state.ring.append(rec)
        return False


def backward_scope(name: str) -> _BackwardScope:
    """Made in a forward, entered in its backward: a span charged to the
    forward's thread (`_BackwardScope`)."""
    return _BackwardScope(name, _thread())


def mark_fused() -> None:
    """Charge a march run as one march-and-budget kernel to the innermost
    open span."""
    cur = _thread().cur
    if cur is not None:
        cur[8] += 1


class Profiler:
    """Hierarchical profiler.

    Args:
      warmup: frames to skip before recording.
      record_frames: number of frames to record; after that, ``then`` fires.
      record_depth: max tree depth recorded.
      then: callback ``then(profiler)`` after recording completes.
      sync: synchronize the card at node exit.
    """

    def __init__(self, warmup: int = 0, record_frames: int = -1,
                 record_depth: int = 10, then: Optional[Callable] = None,
                 sync: bool = False, enabled: bool = True):
        self.warmup = warmup
        self.record_frames = record_frames
        self.record_depth = record_depth
        self.then = then
        self.sync = sync
        self.enabled = enabled
        self.reset()

    # ------------------------------------------------------------- frames
    def step_frame(self):
        """Mark a frame boundary (once per training/render iteration)."""
        self._frame += 1
        if (not self._done and self.record_frames > 0
                and self._frame >= self.warmup + self.record_frames):
            self._done = True
            if self.then is not None:
                self.then(self)

    @property
    def recording(self) -> bool:
        return (self.enabled and not self._done and self._frame >= self.warmup
                and self._depth < self.record_depth)

    # -------------------------------------------------------------- scopes
    def scope(self, name: str, unit: Optional[int] = None) -> _Scope:
        return _TreeScope(name, unit, self)

    # -------------------------------------------------------------- report
    def report(self, min_frac: float = 0.0) -> str:
        lines: List[str] = [f"{'node':<50} {'total(ms)':>10} {'count':>7} "
                            f"{'avg(ms)':>9} {'%parent':>8}"]

        def visit(node: ProfileNode, depth: int):
            for child in node.children.values():
                frac = child.total / node.total if node.total > 0 else 1.0
                if node is self.root:
                    frac = 1.0
                if frac < min_frac:
                    continue
                avg = child.total / max(child.count, 1)
                lines.append(
                    f"{'  ' * depth + child.name:<50} "
                    f"{child.total * 1e3:>10.3f} {child.count:>7d} "
                    f"{avg * 1e3:>9.3f} {frac * 100:>7.1f}%")
                visit(child, depth + 1)

        visit(self.root, 0)
        return "\n".join(lines)

    def reset(self):
        self.root = ProfileNode("<root>")
        self._cur = self.root
        self._depth = 0
        self._frame = 0
        self._done = False


_default = Profiler(enabled=False)


def get_default_profiler() -> Profiler:
    return _default


def enable_profiling(**kwargs) -> Profiler:
    global _default
    _default = Profiler(enabled=True, **kwargs)
    return _default


def profile(name_or_fn=None, unit: Optional[int] = None) -> _Scope:
    """``@profile`` decorator, or ``with profile("name"):`` context (also
    a decorator, ``@profile("name")``): a span of the calling thread, on
    the default profiler's tree while it is enabled. `unit` ids the step
    or frame the span and its children belong to."""
    if unit is None and not _default.enabled:
        try:
            return _local.scopes[name_or_fn]
        except (AttributeError, KeyError):
            pass
    if callable(name_or_fn):
        return profile(name_or_fn.__qualname__, unit)(name_or_fn)
    if _default.enabled:
        return _TreeScope(name_or_fn, unit, _default)
    state = _thread()
    if unit is not None:
        return _Scope(name_or_fn, unit, state)
    scope = state.scopes[name_or_fn] = _Scope(name_or_fn, None, state)
    return scope


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler session (host and, where there is a card, device
    activities) around the block; its Chrome trace goes to
    `<log_dir>/trace.json`, and the session is yielded for
    `key_averages()`."""
    import os

    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def debug_profile(name: str = "debug"):
    """One-off synchronized timing print."""
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        print(f"[debug_profile] {name}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
