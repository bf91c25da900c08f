"""The finish (post.finalize_* and the image's read-back, the final_fetch phase): ms a finished render, the median."""

from benchmark.harness import readers


def read(run):
    return readers.phase_median(run, lambda name: name == "final_fetch")
