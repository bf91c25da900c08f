"""The port's own spans and counters in a traced run, and their place on the device trace's clock.

The port keeps each finished request's trace (``utils/metrics.py``: a
render's, or an editor frame's with its render, every thread's spans under
one request id) in ``metrics.RECENT``.  A reader takes the traces of the
window's renders from there, each held to its render by the render's own
wall; where they do not all match, none.  A port without the recorder
gives no traces, and the readers then return None.

The spans are timed on ``time.perf_counter_ns``; the profiler's host and
device records on its own clock, the Unix epoch's.  :func:`clock_offset_ns`
measures the offset between the two in the traced process itself;
:func:`clock_probe` opens a ``record_function`` range bracketed by
``perf_counter_ns`` reads around its opening and its closing, and
:func:`offset_error_s` holds the offset to where the profiler saw that
range.
"""

from __future__ import annotations

import time
from statistics import median

__all__ = ["window_traces", "render_span", "per_render_median", "session_self_ms", "clock_offset_ns",
           "clock_probe", "PROBE", "offset_error_s", "depth", "path", "idle_by_span"]

PROBE = "span_clock_probe"
WALL_SLACK_S = 2e-3  # a render span outlasts the Renderer's wall by the few µs to its close; a pause of the collector


def _recorder():
    """The port's span recorder, or None where the port has none."""
    from path_trace_golang_tpu_torch.utils import metrics

    return metrics if hasattr(metrics, "RECENT") else None


def window_traces(run) -> list:
    """The traces of the window's renders (or editor frames), oldest
    first: of the runs of kept traces, one a render, in which each trace's
    ``render`` span outlasts its render's own wall (``Render.wall_s``,
    which the Renderer takes just before the span closes) by 0 to
    :data:`WALL_SLACK_S`, the one whose largest excess is least.  Empty
    where the port keeps none, or where no run matches (more renders than
    it keeps, a frame recorded as two traces)."""
    rec = _recorder()
    n = len(run.renders)
    if rec is None or not n:
        return []
    kept = list(rec.RECENT)
    walls = [r.wall_s for r in run.renders]
    best, least = [], WALL_SLACK_S
    for end in range(n, len(kept) + 1):
        got = kept[end - n:end]
        excess = [_excess(t, w) for t, w in zip(got, walls)]
        if None not in excess and max(excess) <= least:
            best, least = got, max(excess)
    return best


def _excess(trace, wall_s: float):
    """How much longer, in s, the trace's ``render`` span is than ``wall_s``;
    None where it has none or it is shorter."""
    sp = render_span(trace)
    if sp is None or sp.end_ns is None or sp.ns / 1e9 < wall_s:
        return None
    return sp.ns / 1e9 - wall_s


def render_span(trace):
    """The trace's ``render`` span (the root of a render's trace, a child of
    an editor frame's), or None."""
    return next((sp for sp in trace.spans if sp.name == "render"), None)


def per_render_median(run, value):
    """The median over the window's traces that hold a render of
    ``value(trace)``; None where there are none."""
    vals = [value(t) for t in window_traces(run) if render_span(t) is not None]
    return median(vals) if vals else None


def session_self_ms(trace):
    """The self time of an editor frame's session spans, the ``render``
    subtree left out, in ms; None for a trace that is no editor frame."""
    if trace.spans[0].name != "session.frame":
        return None
    rec = _recorder()
    r = render_span(trace)
    skip = {id(sp) for sp in rec.subtree(trace.spans, r)} if r is not None else set()
    return sum(v for k, v in rec.self_times(trace.spans).items() if k not in skip) / 1e6


def clock_offset_ns(pairs: int = 201) -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the median over
    ``pairs`` reads of the epoch's clock each between two reads of the
    perf counter (their midpoint)."""
    d = []
    for _ in range(pairs):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        d.append(t - (a + b) // 2)
    return int(median(d))


def clock_probe() -> tuple:
    """A ``record_function`` range named :data:`PROBE`, opened and closed
    at once: ((``perf_counter_ns`` before, after its opening), (before,
    after its closing)), for :func:`offset_error_s`."""
    from torch.profiler import record_function

    rf = record_function(PROBE)
    a0 = time.perf_counter_ns()
    rf.__enter__()
    a1 = time.perf_counter_ns()
    b0 = time.perf_counter_ns()
    rf.__exit__(None, None, None)
    b1 = time.perf_counter_ns()
    return (a0, a1), (b0, b1)


def offset_error_s(offset_ns: int, window: tuple, opened: tuple, closed: tuple) -> float:
    """How far, in s, a range that the profiler saw (``window``: start, end
    in s on its clock) lies outside where the offset puts it: its start
    between the ``perf_counter_ns`` reads ``opened`` (before, after the
    range opened), its end between ``closed``'s.  0 where both lie inside,
    which holds the offset as tight as the brackets are wide."""
    err = 0.0
    for t, (lo, hi) in ((window[0], opened), (window[1], closed)):
        lo_s, hi_s = (lo + offset_ns) / 1e9, (hi + offset_ns) / 1e9
        err = max(err, lo_s - t, t - hi_s)
    return max(err, 0.0)


def depth(sp) -> int:
    d = 0
    while sp.parent is not None:
        sp, d = sp.parent, d + 1
    return d


def path(sp) -> str:
    """The span's names from below its root down to it, joined by ``/``
    (the root's own name for the root)."""
    names = []
    while sp.parent is not None:
        names.append(sp.name)
        sp = sp.parent
    return "/".join(reversed(names)) or sp.name


def idle_by_span(gaps, spans, offset_ns: int) -> dict:
    """The device-idle seconds of ``gaps`` ((start, end) on the profiler's
    clock) under each innermost span of ``spans`` (the deepest open one,
    from whatever thread; the one opened last among equals), by its
    :func:`path`; the part under no span as ``""``.  Spans are mapped onto
    the profiler's clock by ``offset_ns``."""
    ev = []
    for sp in spans:
        if sp.end_ns is None:
            continue
        key = (depth(sp), sp.start_ns, id(sp))
        ev.append(((sp.start_ns + offset_ns) / 1e9, 1, key, sp))
        ev.append(((sp.end_ns + offset_ns) / 1e9, -1, key, sp))
    for a, b in gaps:
        ev.append((a, 2, None, None))
        ev.append((b, -2, None, None))
    ev.sort(key=lambda e: (e[0], e[1] < 0))  # at one instant, ends after starts: no zero-length holes
    out: dict = {}
    active: dict = {}
    in_gap = 0
    t_prev = None
    for t, kind, key, sp in ev:
        if in_gap and t_prev is not None and t > t_prev:
            name = path(active[max(active)]) if active else ""
            out[name] = out.get(name, 0.0) + (t - t_prev)
        t_prev = t
        if kind == 1:
            active[key] = sp
        elif kind == -1:
            active.pop(key, None)
        else:
            in_gap += 1 if kind == 2 else -1
    return out
