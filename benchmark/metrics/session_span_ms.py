"""The editor's session spans (interactive.InteractiveSession), self time outside the render: median ms a frame."""

from statistics import median

from benchmark.harness import spans


def read(run):
    vals = [v for v in map(spans.session_self_ms, spans.window_traces(run)) if v is not None]
    return median(vals) if vals else None
