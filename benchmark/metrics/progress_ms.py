"""The progress frames (render.progress: the progress image, its read-back and the callback): the median ms a render.

The callback is the caller's own code, in the benchmark the loop's keeping of
the frame; the idle tool splits it out as ``render.progress/callback``."""

from benchmark.harness import spans


def read(run):
    return spans.per_render_median(
        run, lambda t: sum(sp.ns for sp in t.spans if sp.name == "render.progress") / 1e6)
