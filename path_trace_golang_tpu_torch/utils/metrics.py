"""Structured render metrics, NaN surveillance, and the span recorder.

Counterpart of the JAX package's ``utils/metrics.py``: per-interval
records (pass index, wall-clock, Mrays/s, non-finite count) collected by
:class:`MetricsLog` and written to a JSONL sink (``PATHTRACER_METRICS=<path>``,
the keys of :meth:`PassRecord.to_json`, which ``tools/metrics_report.py``
reads) or a callback.

A pass is a pure function of (scene, seed, pass index), so the recovery
from a transient device fault is detect-nonfinite, then recompute the
pass; :func:`nonfinite_count` feeds that check, and the Renderer reports
it in ``RenderStats`` and the metrics log.

The span recorder keeps, in memory, what the host does for one request (a
render, or an editor frame and its render): a :class:`Trace` of
:class:`Span` records (name, start and end on ``time.perf_counter_ns``,
parent, request id, thread) and its counters.  A thread records into the
trace bound to it (:func:`request` binds a new one where none is,
:func:`bound` binds a given one, as the editor's render thread does);
:func:`span` and :func:`count` do nothing on a thread with none.  Spans
never synchronise the card and launch nothing there: a read of the card
is :func:`to_host`, a span of its own that counts ``syncs`` and
``readback_bytes``.  Each finished request's trace is appended to
:data:`RECENT`, the last :data:`RECENT_MAX` of the process.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["PassRecord", "MetricsLog", "nonfinite_count", "Span", "Trace", "request", "span", "bound", "count",
           "to_host", "self_times", "subtree", "RECENT"]


@dataclasses.dataclass
class PassRecord:
    pass_index: int
    wall_seconds: float
    ray_segments: int
    mrays_per_sec: float
    nonfinite: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "pass": self.pass_index,
                "wall_s": round(self.wall_seconds, 4),
                "segments": self.ray_segments,
                "mrays_per_sec": round(self.mrays_per_sec, 2),
                "nonfinite": self.nonfinite,
            }
        )


class MetricsLog:
    """Collects per-interval pass records; optionally tees to a JSONL file
    (PATHTRACER_METRICS env var) and/or a callback."""

    def __init__(self, sink: Optional[Callable[[PassRecord], None]] = None):
        self.records: List[PassRecord] = []
        self.sink = sink
        self._path = os.environ.get("PATHTRACER_METRICS", "")
        self._t_last = time.perf_counter()
        self._segs_last = 0

    @property
    def observed(self) -> bool:
        """Whether a record reaches anything but :attr:`records` (a sink or
        the JSONL file)."""
        return self.sink is not None or bool(self._path)

    def interval(self, pass_index: int, total_segments: int, nonfinite: int = 0) -> PassRecord:
        now = time.perf_counter()
        wall = now - self._t_last
        segs = total_segments - self._segs_last
        rec = PassRecord(
            pass_index=pass_index,
            wall_seconds=wall,
            ray_segments=segs,
            mrays_per_sec=(segs / wall / 1e6) if wall > 0 else 0.0,
            nonfinite=nonfinite,
        )
        self._t_last = now
        self._segs_last = total_segments
        self.records.append(rec)
        if self.sink is not None:
            self.sink(rec)
        if self._path:
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(rec.to_json() + "\n")
        return rec


def nonfinite_count(arr) -> torch.Tensor:
    """Number of non-finite elements, a 0-d int64 tensor on ``arr``'s device
    (reading it is the caller's one sync)."""
    return (~torch.isfinite(torch.as_tensor(arr))).sum()



# ---------------------------------------------------------------------------
# The span recorder
# ---------------------------------------------------------------------------

_now = time.perf_counter_ns
_REQUEST_IDS = itertools.count(1)
_LOCAL = threading.local()
RECENT_MAX = 512
RECENT: collections.deque = collections.deque(maxlen=RECENT_MAX)  # finished requests' traces, oldest first


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``perf_counter_ns``;
    ``end_ns`` None while open), the ``parent`` span (None at the root), the
    ``request`` id, the ``thread`` (``threading.get_ident``) it was opened
    on, and ``arg``, a pass index where the name needs one."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "thread", "arg")

    def __init__(self, name: str, parent: Optional["Span"], request: int, arg=None):
        self.name, self.parent, self.request, self.arg = name, parent, request, arg
        self.thread = threading.get_ident()
        self.end_ns = None
        self.start_ns = _now()

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Trace:
    """The spans (in the order they opened) and counters of one request."""

    def __init__(self):
        self.request = next(_REQUEST_IDS)
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}

    def open(self, name: str, parent: Optional[Span] = None, arg=None) -> Span:
        sp = Span(name, parent, self.request, arg)
        self.spans.append(sp)
        return sp

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def finish(self, root: Span) -> None:
        """Close the root span and keep the trace in :data:`RECENT`."""
        root.end_ns = _now()
        RECENT.append(self)


def _stack() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class span:
    """``with span(name):`` records a span in the trace bound to this
    thread, under the innermost open one; nothing where no trace is bound.
    ``as`` gives the span, or None."""

    __slots__ = ("name", "arg", "span", "stack")

    def __init__(self, name: str, arg=None):
        self.name, self.arg = name, arg

    def __enter__(self) -> Optional[Span]:
        self.stack = st = _stack()
        if not st:
            self.span = None
            return None
        trace, parent = st[-1]
        self.span = sp = trace.open(self.name, parent, self.arg)
        st.append((trace, sp))
        return sp

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.end_ns = _now()
            self.stack.pop()
        return False


class request:
    """``with request(name) as rq:`` opens the span of a request: under the
    innermost open span of the trace bound to this thread, or, where none
    is, as the root of a new trace, which is kept in :data:`RECENT` when
    the block ends.  ``rq.trace``, ``rq.span``; ``rq.spans()`` and
    ``rq.counters()`` give the block's own spans and counts."""

    __slots__ = ("name", "trace", "span", "root", "index", "_before")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "request":
        st = _stack()
        self.root = not st
        self.trace, parent = (Trace(), None) if self.root else st[-1]
        self.index = len(self.trace.spans)
        self._before = dict(self.trace.counters)
        self.span = self.trace.open(self.name, parent)
        st.append((self.trace, self.span))
        return self

    def __exit__(self, *exc):
        _stack().pop()
        if self.root:
            self.trace.finish(self.span)
        else:
            self.span.end_ns = _now()
        return False

    def spans(self) -> List[Span]:
        """The request span and the spans opened in its trace after it."""
        return self.trace.spans[self.index:]

    def counters(self) -> Dict[str, int]:
        return {k: v - self._before.get(k, 0) for k, v in self.trace.counters.items() if v != self._before.get(k, 0)}


class bound:
    """``with bound(trace, parent):`` binds ``trace`` to this thread for the
    block, new spans opening under ``parent``."""

    __slots__ = ("item",)

    def __init__(self, trace: Trace, parent: Optional[Span]):
        self.item = (trace, parent)

    def __enter__(self):
        _stack().append(self.item)
        return self.item[0]

    def __exit__(self, *exc):
        _stack().pop()
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the trace bound to this thread, if any."""
    st = _stack()
    if st:
        st[-1][0].count(name, n)


def to_host(t: torch.Tensor, name: str = "read"):
    """A read of ``t`` by the host as a span of its own, so that the host's
    wait on the card shows where it happens: a 0-d tensor's value
    (``t.item()``), else ``t.cpu()``.  Counts one ``syncs`` and the bytes
    read (``readback_bytes``)."""
    with span(name):
        out = t.item() if t.dim() == 0 else t.cpu()
    count("syncs")
    count("readback_bytes", t.numel() * t.element_size())
    return out


def subtree(spans: List[Span], root: Span) -> List[Span]:
    """The spans of ``spans`` that lie under ``root`` (``root`` included)."""
    inside = {id(root)}
    out = []
    for sp in spans:  # a parent opens before its children
        if sp is root or (sp.parent is not None and id(sp.parent) in inside):
            inside.add(id(sp))
            out.append(sp)
    return out


def self_times(spans: List[Span]) -> Dict[int, int]:
    """Each span's self time in ns, by ``id(span)``: its duration less the
    part of it that its children cover."""
    kids: Dict[int, list] = collections.defaultdict(list)
    for sp in spans:
        if sp.parent is not None:
            kids[id(sp.parent)].append((max(sp.start_ns, sp.parent.start_ns), min(sp.end_ns, sp.parent.end_ns)))
    out = {}
    for sp in spans:
        covered, t = 0, sp.start_ns
        for a, b in sorted(kids.get(id(sp), ())):
            a = max(a, t)
            if b > a:
                covered += b - a
                t = b
        out[id(sp)] = sp.ns - covered
    return out
