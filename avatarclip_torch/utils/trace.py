"""The port's tracing: spans of the program's layers and its counters.

``span(name, step=None)`` is a context manager around one piece of a
step's host work. It is off unless a torch.profiler is running (the flag
``torch.autograd.profiler._is_profiler_enabled``, read through the module at
each call): then it returns the shared :data:`NULL` context, which reads no
clock, calls nothing in torch and records nothing. While a profiler runs
(``Runner.profile_trace``, a benchmark's traced window, any
``torch.profiler.profile``) a span enters ``torch.profiler.record_function``
under its name, so that Chrome traces show it, and appends a :class:`Span`
to a bounded store: its name, the enclosing span's name on the same thread,
the thread, the step's id and its start and end in ``time.time_ns()``, the
clock kineto stamps its events with. ``spans()`` reads the store and
``clear()`` empties it.

A span given ``step`` makes that id the current step of every thread, so
the spans that autograd's worker thread opens in a backward share it. A
name's first segment is its layer: ``loop``, ``render``, ``clip``,
``motion`` (the motion decoder: ``motion.decode``, ``motion.loss``),
``backward`` (``backward.clip``, ``backward.motion``: a graph's input
gradient).

``count(name, n=1)`` is the registry of the port's kernel launches (and of
any other count: the graphs' ``clip_graph_*`` and ``motion_graph_*``,
utils/graphs.py): always on, thread-safe. ``counters()`` reads it,
``reset_counters()`` empties it, and ``launches()`` gives every kernel
wrapper's count under :data:`KERNELS`, 0 where none ran.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 18  # the store keeps the newest spans beyond this many

# every counter a kernel wrapper keeps: one a launch of its kernel
KERNELS = (
    "zbuffer_tiled", "zbuffer_brute",
    "neus_ray_fwd", "neus_ray_bwd", "neus_point_fwd", "neus_point_bwd",
    "composite_fwd", "composite_bwd",
    "soft_fwd", "soft_bwd", "soft_fwd_reduce", "soft_bwd_reduce",
    "sdf_fwd", "sdf_bwd", "sdf_only_fwd",
    "color_fwd", "color_bwd",
)


class Span(NamedTuple):
    name: str
    parent: str | None  # the enclosing span on the same thread
    thread: int
    step: object  # the step's id, shared by the step's spans
    t0_ns: int
    t1_ns: int
    ids: dict | None  # what the span noted of its step (``note``)


_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()
_step = None  # the current step's id, every thread's


class _Null:
    """The context of every span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Open:
    __slots__ = ("name", "step", "ids", "parent", "rf", "t0")

    def __init__(self, name: str, step):
        self.name, self.step, self.ids = name, step, None

    def __enter__(self):
        global _step
        if self.step is None:
            self.step = _step
        else:
            _step = self.step
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.t0 = time.time_ns()
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        t1 = time.time_ns()
        _local.stack.pop()
        _store.append(Span(self.name, self.parent, threading.get_ident(), self.step, self.t0, t1,
                           self.ids))
        return False

    def note(self, **ids) -> None:
        """Record ``ids`` (what this step is) with the span."""
        self.ids = {**(self.ids or {}), **ids}


def span(name: str, step=None):
    """The context of one span (module docstring); :data:`NULL` while no
    profiler runs."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return _Open(name, step)


def spans() -> list[Span]:
    """The recorded spans, oldest first (at most :data:`MAX_SPANS`)."""
    return list(_store)


def clear() -> None:
    global _step
    _store.clear()
    _step = None


_counts: dict[str, int] = {}
_count_lock = threading.Lock()  # the validation worker thread launches kernels too


def count(name: str, n: int = 1) -> None:
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    with _count_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _count_lock:
        _counts.clear()


def launches() -> dict[str, int]:
    """Every kernel wrapper's launches (:data:`KERNELS`), 0 where none ran."""
    c = counters()
    return {k: c.get(k, 0) for k in KERNELS}
