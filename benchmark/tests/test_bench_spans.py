"""The readers of the port's spans and counters (``harness/spans.py``, the
``progress_ms``, ``syncs`` and ``session_span_ms`` metrics, the
``idle_by_span`` tool's arithmetic), on records made by hand and by the
port's own Renderer and editor session on the CPU."""

from __future__ import annotations

import types

import pytest

from benchmark.harness import runs, spans, spec
from benchmark.tools import idle_by_span

import path_trace_golang_tpu_torch as pt
from path_trace_golang_tpu_torch.interactive import InteractiveSession
from path_trace_golang_tpu_torch.scene import builtin
from path_trace_golang_tpu_torch.utils import metrics


class _Clock:
    """Spans at given instants: ``metrics.Span`` with its times set by hand."""

    def __init__(self):
        self.trace = metrics.Trace()

    def add(self, name, start, end, parent=None):
        sp = self.trace.open(name, parent)
        sp.start_ns, sp.end_ns = start, end
        return sp


def _frame_trace(progress_ns=(3, 4), syncs=8, render_ns=70):
    c = _Clock()
    root = c.add("session.frame", 0, 30 + render_ns)
    c.add("session.edit", 0, 5, root)
    c.add("session.handoff", 10, 12, root)
    r = c.add("render", 20, 20 + render_ns, root)
    t = 30
    for ns in progress_ns:
        c.add("render.progress", t, t + ns, r)
        t += 10
    c.add("session.publish", 20 + render_ns, 25 + render_ns, root)
    c.trace.counters["syncs"] = syncs
    return c.trace


def _window(walls_ns):
    """A window whose renders took these walls (the Renderer's own, ns)."""
    return types.SimpleNamespace(renders=[types.SimpleNamespace(wall_s=w / 1e9) for w in walls_ns])


@pytest.fixture
def recent(monkeypatch):
    """The port's kept traces, emptied for the test."""
    monkeypatch.setattr(metrics, "RECENT", type(metrics.RECENT)(maxlen=metrics.RECENT_MAX))
    return metrics.RECENT


def test_the_readers_take_the_windows_traces_from_the_port(recent):
    recent.append(_frame_trace((100,), 99, 200))  # the warm-up frame, before the window
    for prog, syncs, wall in (((3, 4), 8, 70), ((5, 6), 10, 80), ((1, 1), 12, 90)):
        recent.append(_frame_trace(prog, syncs, wall))
    recent.append(_frame_trace((100,), 99, 300))  # a render after the window
    run = _window([70, 80, 90])
    assert spec.metric_reader("progress_ms.preview")(run) == pytest.approx(7e-6)  # ns to ms: 7, 11, 2
    assert spec.metric_reader("syncs.preview")(run) == 10
    # self time outside the render: 30 ns a frame
    assert spec.metric_reader("session_span_ms.preview")(run) == pytest.approx(30e-6)


@pytest.mark.parametrize("walls", [
    [60, 70, 80, 90],  # more renders than matching traces: some were not kept
    [70, 80, 95],  # a render whose span is shorter than its wall: not its trace
    [70, 80, 90 - 3e6],  # a span that outlasts its render's wall by more than the slack
])
def test_the_readers_refuse_traces_that_do_not_match_the_windows_renders(recent, walls):
    for wall in (70, 80, 90):
        recent.append(_frame_trace(render_ns=wall))
    run = _window(walls)
    assert spans.window_traces(run) == []
    for name in ("progress_ms", "syncs.mesh", "session_span_ms.preview"):
        assert spec.metric_reader(name)(run) is None


def test_a_frame_recorded_as_two_traces_is_refused(recent):
    recent.append(_frame_trace(render_ns=70))
    half = _Clock()
    half.add("session.frame", 0, 10)  # a frame's first part, without its render
    recent.append(half.trace)
    for wall in (80, 90):
        recent.append(_frame_trace(render_ns=wall))
    assert spans.window_traces(_window([70, 80, 90])) == []
    assert len(spans.window_traces(_window([80, 90]))) == 2


def test_the_readers_report_nothing_from_a_port_without_the_recorder(monkeypatch):
    monkeypatch.delattr(metrics, "RECENT")
    run = _window([10**6, 2 * 10**6])
    for name in ("progress_ms", "syncs.mesh", "session_span_ms.preview"):
        assert spec.metric_reader(name)(run) is None


def test_the_readers_read_a_renders_and_an_editor_frames_own_spans(recent):
    r = pt.Renderer(contract="gpu", seed=1, device="cpu")
    r.render(builtin.demo_cornell(), pt.RenderConfig(6, 4, 2, 2), progress=lambda p, im: None)
    run = _window([r.stats.wall_seconds * 1e9])
    want = sum(sp.ns for sp in r.spans if sp.name == "render.progress") / 1e6
    assert spec.metric_reader("progress_ms")(run) == want > 0
    assert spec.metric_reader("syncs")(run) == r.counters["syncs"] == 2 * 3 + 2
    assert spec.metric_reader("session_span_ms.preview")(run) is None  # no editor frame

    s = InteractiveSession(builtin.demo_cornell(), renderer=pt.Renderer(contract="gpu", seed=1, device="cpu"))
    s.settings.width, s.settings.height, s.settings.samples_per_px, s.settings.max_depth = 6, 4, 2, 2
    s.move_key("a")
    s.render_now()
    run = _window([s.renderer.stats.wall_seconds * 1e9])
    frame = s.spans
    render = spans.render_span(recent[-1])
    st = metrics.self_times(frame)
    inside = {id(sp) for sp in metrics.subtree(frame, render)}
    outside = sum(v for k, v in st.items() if k not in inside) / 1e6
    assert spec.metric_reader("session_span_ms.preview")(run) == pytest.approx(outside)
    assert outside == pytest.approx((frame[0].ns - render.ns) / 1e6)


def test_the_phase_readers_read_what_the_spans_hold(monkeypatch, recent):
    """The phase table that the accepted readers parse is the spans' own:
    ``interval_ms``, ``pack_ms`` and ``finish_ms`` read the summed
    ``render.interval``, the ``render.pack`` and the ``render.finish`` span
    (and what lies before each inside its phase), to the table's 0.1 ms."""
    monkeypatch.setenv("PATHTRACER_TIME_PHASES", "1")
    r = pt.Renderer(contract="cpu", seed=1, device="cpu")
    with runs.PhaseCapture(True) as cap:
        r.render(builtin.demo_cornell(), pt.RenderConfig(6, 4, 40, 2), progress=lambda p, im: None)
    table = pt.render.phase_table(r.spans)
    assert [n for n, _ms in cap.phases] == [n for n, _ms in table]
    run = types.SimpleNamespace(renders=[types.SimpleNamespace(phases=cap.phases)])
    rows = dict(table)
    assert spec.metric_reader("pack_ms")(run) == pytest.approx(rows["pack_scene"], abs=0.051)
    assert spec.metric_reader("finish_ms")(run) == pytest.approx(rows["final_fetch"], abs=0.051)
    intervals = [ms for n, ms in table if n.startswith("interval@")]
    assert len(intervals) == 20
    assert spec.metric_reader("interval_ms")(run) == pytest.approx(sum(intervals), abs=0.051 * 20)


def test_idle_goes_to_the_innermost_span_on_any_thread():
    c = _Clock()
    root = c.add("render", 0, 100)
    win = c.add("render.window", 10, 40, root)
    c.add("read", 30, 40, win)
    prog = c.add("render.progress", 50, 80, root)
    other = c.add("session.edit", 60, 70)  # another thread's root, shallower than prog's child
    cb = c.add("callback", 65, 75, prog)
    assert (spans.depth(cb), spans.path(cb), spans.path(root), spans.path(other)) == (
        1 + 1, "render.progress/callback", "render", "session.edit")
    gaps = [(5e-9, 15e-9), (35e-9, 68e-9), (90e-9, 110e-9)]
    got = spans.idle_by_span(gaps, c.trace.spans, 0)
    want = {"render": 5 + 10 + 10, "render.window": 5, "render.window/read": 5, "render.progress": 15,
            "render.progress/callback": 3, "": 10}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-9), k
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in gaps))
    # an offset moves the spans, not the gaps
    assert spans.idle_by_span([(1.0 + 5e-9, 1.0 + 15e-9)], c.trace.spans, 10**9)["render.window"] == pytest.approx(
        5e-9, abs=1e-12)


def test_the_offset_is_held_to_a_probe_range():
    off = 10**12
    window = ((1000 + off) / 1e9, (5000 + off) / 1e9)
    assert spans.offset_error_s(off, window, (900, 1100), (4900, 5100)) == 0.0
    assert spans.offset_error_s(off, window, (1200, 1300), (4900, 5100)) == pytest.approx(200e-9, rel=1e-3)
    assert spans.offset_error_s(off, window, (900, 1100), (4000, 4500)) == pytest.approx(500e-9, rel=1e-3)
    assert abs(spans.clock_offset_ns() - spans.clock_offset_ns()) < 10**6


def test_the_probes_lie_where_the_profiler_saw_them():
    """On the CPU profiler: each probe's range lies between its brackets by
    the measured offset, to 50 µs."""
    from torch.profiler import ProfilerActivity, profile

    spans.clock_probe()  # the first range a process opens is slow to open
    off = spans.clock_offset_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        probes = [spans.clock_probe() for _ in range(3)]
    seen = sorted((e.start_ns() / 1e9, e.end_ns() / 1e9) for e in prof.profiler.kineto_results.events()
                  if e.name() == spans.PROBE)
    assert len(seen) == 3
    for rng, (opened, closed) in zip(seen, probes):
        assert spans.offset_error_s(off, rng, opened, closed) < 50e-6


def test_the_tool_summarises_a_render_and_its_warm_up(recent, monkeypatch):
    monkeypatch.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    monkeypatch.setattr(pt.soa, "_BVH_BUILD_CACHE", {})
    r = pt.Renderer(contract="cpu", seed=1, device="cpu")
    for _ in range(3):
        r.render(builtin.demo_mesh(), pt.RenderConfig(4, 2, 40, 1), progress=lambda p, im: None)
    per = idle_by_span.per_render(list(recent))
    assert per["renders"] == 3 and per["syncs"] == 20 * 3 + 2 and per["windows"] == 20
    assert per["readback_bytes"] == 21 * 4 * 2 * 3 + (2 * 20 + 1) * 8
    assert 0 < per["first_progress_ms"] < per["render_ms"] and per["progress_ms"] > 0
    assert per["pack.digest_ms"] > 0 and per["session_span_ms"] is None
    warm = idle_by_span.warmup(recent[0])
    assert set(warm) == {"kernels.load_ms", "kernels.build_ms", "counters"}
    assert warm["counters"]["bvh_cache_misses"] == 1 and "bvh_cache_hits" not in warm["counters"]
    assert [t.counters.get("bvh_cache_hits") for t in recent] == [None, 1, 1]
    assert idle_by_span.span_cost_ns(100)["span_ns"] > 0


@pytest.mark.parametrize("cell, names", [
    ("showcase-gpu-final", {"progress_ms", "syncs"}),
    ("showcase-gpu-preview", {"progress_ms.preview", "syncs.preview", "session_span_ms.preview"}),
])
def test_a_traced_run_reports_the_spans_metrics(cell, names):
    """A whole traced run of a tiny cell through the harness: the readers get
    its ``TracedRun`` and find the window's traces."""
    from benchmark.harness import core
    from benchmark.tests.bench_tiny import tiny_cell

    res = core.run_cell(tiny_cell(cell), 2**31 + 7, 0.5, trace=True, device="cpu")
    assert res.line["correct"], res.line["checks"]
    assert names <= set(res.line["metrics"])
    assert res.line["metrics"][sorted(names)[-1]]["value"] > 0
