"""Hierarchical profiler: a host wall-time tree whose nodes also annotate
the device trace (port of nr3d_lib_tpu/profile.py).

`Profiler(warmup, record_frames, record_depth, then, sync)`, the
`@profile` decorator or `with profile("name"):` context, `debug_profile`
and `device_trace` keep JAX's names. Each node is a
`torch.profiler.record_function` span as well, so a trace taken by
`device_trace` (or any `torch.profiler` session) carries the node names,
as `jax.named_scope` does in an XLA trace. `sync=True` calls
`torch.cuda.synchronize()` at node exit, so a node's host time covers
the device work it queued.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Profiler", "profile", "debug_profile", "get_default_profiler",
           "enable_profiling", "device_trace"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ProfileNode:
    __slots__ = ("name", "parent", "children", "total", "count", "_t0")

    def __init__(self, name: str, parent: Optional["ProfileNode"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, ProfileNode] = {}
        self.total = 0.0
        self.count = 0
        self._t0 = 0.0

    def child(self, name: str) -> "ProfileNode":
        node = self.children.get(name)
        if node is None:
            node = self.children[name] = ProfileNode(name, self)
        return node


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
    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.recording:
            yield
            return
        node = self._cur.child(name)
        parent = self._cur
        self._cur, self._depth = node, self._depth + 1
        node._t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if self.sync:
                _sync()
            node.total += time.perf_counter() - node._t0
            node.count += 1
            self._cur, self._depth = parent, self._depth - 1

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


def profile(name_or_fn=None):
    """``@profile`` decorator or ``with profile("name"):`` context, on the
    default profiler."""
    if callable(name_or_fn):
        fn = name_or_fn

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _default.scope(fn.__qualname__):
                return fn(*args, **kwargs)

        return wrapped
    name = name_or_fn

    class _Ctx:
        def __enter__(self):
            self._cm = _default.scope(name)
            return self._cm.__enter__()

        def __exit__(self, *exc):
            return self._cm.__exit__(*exc)

        def __call__(self, fn):
            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with _default.scope(name):
                    return fn(*args, **kwargs)

            return wrapped

    return _Ctx()


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
