"""The device's idle time split by the program's spans (metrics/_spans.py)
on a made-up window: idle intervals split by overlap, the innermost span
across threads, time under no span, the division by steps, the window's
clipping, and nothing read from a program without spans."""

import sys
import types
from types import SimpleNamespace

import pytest

from benchmark.harness import registry
from benchmark.harness import trace as tr
from benchmark.metrics import _spans


def sp(name, t0, t1, thread=1):
    return SimpleNamespace(name=name, t0_ns=t0, t1_ns=t1, thread=thread)


# device busy [1000, 1100), [1300, 1400), [2000, 2100), [3000, 3100): idle
# intervals [1100, 1300), [1400, 2000), [2100, 3000); the window 1000-3100
DEVICE = [(1000, 100, "k0"), (1300, 100, "k1"), (2000, 100, "k2"), (3000, 100, "k3")]
SPANS = [
    sp("loop.step", 500, 2500),  # starts before the window
    sp("render.rays", 1150, 1250),  # inside the first idle interval
    sp("backward", 1500, 2400),
    sp("backward.neus_core", 1700, 1800, thread=2),  # worker thread, inside backward
    sp("clip.image", 1750, 1900),  # main thread, overlaps the worker's span
    sp("loop.sync", 2600, 2800),
    sp("render.old", 0, 900),  # outside the window
]


def test_innermost_is_the_shortest_open_span_on_any_thread():
    line = _spans.innermost(SPANS, 1000, 3100)
    assert line == [
        (1000, 1150, "loop.step"), (1150, 1250, "render.rays"), (1250, 1500, "loop.step"),
        (1500, 1700, "backward"), (1700, 1800, "backward.neus_core"), (1800, 1900, "clip.image"),
        (1900, 2400, "backward"), (2400, 2500, "loop.step"), (2600, 2800, "loop.sync"),
    ]


def test_idle_is_split_by_overlap_and_by_layer():
    t = tr.Trace(3.1e-6, 2, list(DEVICE))
    ns = _spans.split_idle(t, SPANS)
    # [1100, 1300): loop 1100-1150 and 1250-1300, render 1150-1250
    # [1400, 2000): loop 1400-1500, backward 1500-1700, the worker's backward
    #               1700-1800, clip 1800-1900, backward 1900-2000
    # [2100, 3000): backward 2100-2400, loop 2400-2500, unspanned 2500-2600,
    #               loop.sync 2600-2800, unspanned 2800-3000
    assert ns == {"loop": 100 + 100 + 100 + 200, "render": 100, "backward": 200 + 100 + 100 + 300,
                  "clip": 100, "unspanned": 100 + 200}
    assert sum(ns.values()) == (3100 - 1000) - 400  # the window less its busy time


def test_metrics_are_ms_a_step_and_add_up_to_the_idle(monkeypatch):
    mod = types.ModuleType(_spans.TRACE_MODULE)
    mod.spans = lambda: list(SPANS)
    monkeypatch.setitem(sys.modules, _spans.TRACE_MODULE, mod)
    run = SimpleNamespace(trace=tr.Trace(3.1e-6, 2, list(DEVICE)), ctx={})
    want = {"loop": 500, "render": 100, "clip": 100, "backward": 700}
    for suffix in ("sculpt", "animate"):
        for layer, v in want.items():
            got = registry.reader(f"idle.{layer}_ms.{suffix}")(run)
            assert got == pytest.approx(v * 1e-6 / 2), (layer, suffix)
    by = _spans.idle_by_layer(run)
    assert by["unspanned"] == pytest.approx(300e-6 / 2)
    assert by["idle"] == pytest.approx(sum(by[k] for k in (*want, "unspanned")))
    assert by["idle"] == pytest.approx((3100 - 1000 - 400) * 1e-6 / 2)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.delitem(sys.modules, _spans.TRACE_MODULE, raising=False)
    run = SimpleNamespace(trace=tr.Trace(3.1e-6, 2, list(DEVICE)), ctx={})
    assert registry.reader("idle.loop_ms.sculpt")(run) is None
    mod = types.ModuleType(_spans.TRACE_MODULE)
    mod.spans = lambda: [sp("loop.step", 0, 900), sp("loop.sync", 5000, 6000)]  # none in the window
    monkeypatch.setitem(sys.modules, _spans.TRACE_MODULE, mod)
    run = SimpleNamespace(trace=tr.Trace(3.1e-6, 2, list(DEVICE)), ctx={})
    assert registry.reader("idle.render_ms.animate")(run) is None
    run = SimpleNamespace(trace=None, ctx={})
    assert registry.reader("idle.clip_ms.sculpt")(run) is None
