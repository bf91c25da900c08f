"""The Renderer's progress intervals (each one's non-finite count and metrics record): the median ms a render."""

from benchmark.harness import readers


def read(run):
    return readers.phase_median(run, lambda name: name.startswith("interval@"))
