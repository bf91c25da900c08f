"""The device's idle share of a traced window (renders or editor frames), in %."""

from benchmark.harness import readers


def read(run):
    return readers.idle_pct(run)
