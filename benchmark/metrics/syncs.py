"""The Renderer's waits on the card (each read of a card tensor, the `syncs` counter): the median a render."""

from benchmark.harness import spans


def read(run):
    return spans.per_render_median(run, lambda t: t.counters.get("syncs", 0))
