"""The editor's front end (interactive.InteractiveSession): the median ms of a frame outside the Renderer."""

from benchmark.harness import readers


def read(run):
    return readers.front_end_ms(run)
