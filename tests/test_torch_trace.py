"""The port's tracing (avatarclip_torch/utils/trace.py) on the CPU.

Off (no torch.profiler running): ``span`` hands back the one shared null
context, reads no clock, calls nothing in torch, allocates nothing and
records nothing; the counters count all the same. On (under
``torch.profiler.profile``): spans nest on their thread, take the step's id
(autograd's worker thread included), appear in the profile under their
names at the store's stamps, and the store stays bounded. A train_clip step
of a tiny Runner and a PoseOptimizer step record their layers' spans, and
steps with the spans on give the losses of steps with them off.

The spans of the kernels' own autograd Functions (``backward.neus_core``,
``backward.soft``) open only where the kernels run, on the card; on the CPU
the plain versions take their place.
"""

import collections
import itertools
import threading
import time
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avatarclip_torch.pipelines import animate
from avatarclip_torch.pipelines import synthetic as tsyn
from avatarclip_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tiny tensors' many small ops thrash when
    several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    torch.set_num_threads(n)
    trace.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU], record_shapes=False, with_stack=False)


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------


def test_off_span_is_the_shared_null_and_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    before = trace.counters()
    for name, step in (("loop.step", 3), ("render.rays", None)):
        sp = trace.span(name, step)
        assert sp is trace.NULL
        with sp as entered:
            assert entered is trace.NULL
            trace.count("test.off")
    assert trace.spans() == []
    assert trace.counters()["test.off"] == before.get("test.off", 0) + 2


class _Boom:
    def __getattr__(self, name):
        raise AssertionError(f"an off span used {name}")


def test_off_span_reads_no_clock_and_calls_no_torch(monkeypatch):
    monkeypatch.setattr(trace, "time", _Boom())
    monkeypatch.setattr(trace, "torch", _Boom())
    monkeypatch.setattr(trace, "threading", _Boom())
    monkeypatch.setattr(trace, "_store", _Boom())
    with trace.span("loop.step", 1), trace.span("backward"):
        pass


def _peak(loop, n=20_000) -> int:
    """The most memory traced while ``loop(n)`` runs, over 3 runs' least."""
    peaks = []
    for _ in range(3):
        tracemalloc.reset_peak()
        c0 = tracemalloc.get_traced_memory()[0]
        loop(n)
        peaks.append(tracemalloc.get_traced_memory()[1] - c0)
    return min(peaks)


def test_off_span_allocates_nothing():
    """A loop of off spans traces no more memory than the same loop around
    the null context itself (an allocation a call would show however soon
    it is freed: a list a call reads 8 bytes more)."""
    null = trace.NULL

    def bare(n):
        for _ in itertools.repeat(None, n):
            with null:
                pass

    def spans(n):
        for _ in itertools.repeat(None, n):
            with trace.span("loop.step", 5):
                pass

    def listed(n):
        for _ in itertools.repeat(None, n):
            with null:
                x = [n]  # noqa: F841

    for f in (bare, spans, listed):
        f(1000)  # past the interpreter's specialisation
    tracemalloc.start()
    try:
        base, off, alloc = _peak(bare), _peak(spans), _peak(listed)
    finally:
        tracemalloc.stop()
    assert alloc > base  # the measure sees one small allocation a call
    assert off <= base


def test_counters_count_and_reset():
    trace.count("test.launch")
    trace.count("test.launch", 4)
    assert trace.counters()["test.launch"] >= 5
    assert set(trace.launches()) == set(trace.KERNELS)
    trace.reset_counters()
    assert trace.counters() == {}
    assert trace.launches() == {k: 0 for k in trace.KERNELS}


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------


def test_on_spans_nest_by_thread_and_share_the_step():
    def worker():
        with trace.span("backward.worker"):
            pass

    with _cpu_profile():
        with trace.span("loop.step", 7) as step_span:
            assert step_span is not trace.NULL
            with trace.span("render.inner") as inner:
                inner.note(S=128, face=True)
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        with trace.span("loop.sync"):
            pass
    by = {s.name: s for s in trace.spans()}
    main = threading.get_ident()
    assert by["loop.step"].parent is None and by["loop.step"].step == 7
    assert by["render.inner"].parent == "loop.step" and by["render.inner"].thread == main
    assert by["render.inner"].ids == {"S": 128, "face": True}
    assert by["backward.worker"].parent is None and by["backward.worker"].step == 7
    assert by["backward.worker"].thread != main
    assert by["loop.sync"].step == 7 and by["loop.sync"].parent is None
    for s in by.values():
        assert s.t0_ns <= s.t1_ns
    step, inner = by["loop.step"], by["render.inner"]
    assert step.t0_ns <= inner.t0_ns <= inner.t1_ns <= step.t1_ns
    assert [s.name for s in trace.spans()][-1] == "loop.sync"


def test_on_span_appears_in_the_profile_at_the_stores_stamps():
    """The profile's user annotation of a span starts and ends within 50 us
    of the stamps in the store: the spans are on the profiler's clock."""
    x = torch.randn(128, 128)
    with _cpu_profile() as prof:
        for _ in range(5):  # the first spans of a profile enter it slower
            with trace.span("loop.warm"):
                x @ x
        with trace.span("render.check", 1):
            for _ in range(20):
                x = torch.tanh(x @ x)
    (s,) = [s for s in trace.spans() if s.name == "render.check"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "render.check" and e.is_user_annotation()]
    assert len(events) == 1
    e = events[0]
    assert abs(e.start_ns() - s.t0_ns) <= 50_000, (e.start_ns(), s.t0_ns)
    assert abs(e.start_ns() + e.duration_ns() - s.t1_ns) <= 50_000
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::tanh"]
    assert ops and all(s.t0_ns <= o.start_ns() and o.start_ns() + o.duration_ns() <= s.t1_ns for o in ops)


def test_on_store_stays_bounded(monkeypatch):
    assert trace._store.maxlen == trace.MAX_SPANS
    monkeypatch.setattr(trace, "_store", collections.deque(maxlen=8))
    with _cpu_profile():
        for i in range(20):
            with trace.span("loop.step", i):
                pass
    got = trace.spans()
    assert len(got) == 8 and [s.step for s in got] == list(range(12, 20))


# ---------------------------------------------------------------------------
# the program's steps
# ---------------------------------------------------------------------------

SCULPT_PARENTS = {
    "loop.camera": None, "loop.step": None, "loop.sync": None,
    "loop.draws": "loop.step", "render.gt_raster": "loop.step", "render.rays": "loop.step",
    "render.neus_sweeps": "loop.step", "render.neus_core": "loop.step", "render.shade": "loop.step",
    "clip.image": "loop.step", "backward": "loop.step", "loop.adam": "loop.step",
}
POSE_PARENTS = {
    "loop.draws": None, "loop.step": None, "loop.sync": None,
    "render.smpl": "loop.step", "render.soft": "loop.step", "clip.image": "loop.step",
    "backward": "loop.step", "loop.adam": "loop.step",
}


def _runner(tmp_path):
    r = tsyn.make_runner(str(tmp_path), "tiny", res=32, device="cpu")
    r.init_clip()
    r.init_smpl()
    return r


def _sculpt_step(r):
    cam, S = r.sample_iteration_camera(r.iter_step)
    m = r._timed(lambda: r._clip_update(S, cam, r.iter_step))
    r.iter_step += 1
    return float(m["loss"])


def _pose_gen():
    ctx = animate.AnimateContext(clip_size="tiny", render_res=32, device="cpu")
    g = animate.PoseOptimizer(ctx=ctx, seed=3, num_iteration=2)
    var = g.draw_init().requires_grad_(True)
    return g, var, g.make_optimizer(var), ctx.get_text_feature("a person raising both arms")


def _pose_step(g, var, opt, text):
    t0 = time.perf_counter()
    loss = g.step(var, opt, text, g.draw_step())
    g._clock(t0)
    return float(loss)


def _check(spans, parents, step):
    names = {s.name for s in spans}
    assert names == set(parents), sorted(names ^ set(parents))
    for s in spans:
        assert s.parent == parents[s.name], (s.name, s.parent)
        assert s.step == step, (s.name, s.step)


def test_runner_step_records_the_sculpting_spans(tmp_path):
    r = _runner(tmp_path)
    _sculpt_step(r)
    assert trace.spans() == []
    with _cpu_profile():
        _sculpt_step(r)
    got = trace.spans()
    _check(got, SCULPT_PARENTS, 1)
    (cam,) = [s for s in got if s.name == "loop.camera"]
    again, S = r.sample_iteration_camera(1)
    assert cam.ids == {"S": S, "face": again["face_iter"]}
    step = next(s for s in got if s.name == "loop.step")
    for s in got:
        if s.parent == "loop.step":
            assert step.t0_ns <= s.t0_ns <= s.t1_ns <= step.t1_ns, s.name
    order = [s.name for s in sorted(got, key=lambda s: s.t0_ns)]
    assert order[:2] == ["loop.camera", "loop.step"] and order[-1] == "loop.sync"
    layers = [n for n in order if n.startswith(("render.", "clip.", "backward", "loop.adam"))]
    assert layers == ["render.gt_raster", "render.rays", "render.neus_sweeps", "render.neus_core",
                      "render.shade", "clip.image", "backward", "loop.adam"]


def test_pose_step_records_the_pose_spans():
    g, var, opt, text = _pose_gen()
    _pose_step(g, var, opt, text)
    with _cpu_profile():
        _pose_step(g, var, opt, text)
    got = trace.spans()
    _check(got, POSE_PARENTS, 1)
    assert [s.name for s in got].count("clip.image") == 2
    assert g.steps == 2


@pytest.mark.parametrize("cell", ["sculpt", "pose"])
def test_spans_leave_the_losses_as_they_were(tmp_path, cell):
    """Two runs from the same seed, the spans on in one: the same losses."""
    def losses(on: bool, sub: str):
        if cell == "sculpt":
            r = _runner(tmp_path / sub)
            step = lambda: _sculpt_step(r)
        else:
            g, var, opt, text = _pose_gen()
            step = lambda: _pose_step(g, var, opt, text)
        if not on:
            return [step() for _ in range(2)]
        with _cpu_profile():
            out = [step() for _ in range(2)]
        assert trace.spans()
        return out

    assert losses(True, "on") == losses(False, "off")
