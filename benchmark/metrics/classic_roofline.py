"""The classic window kernel (classic_window_kernel, csrc/classic.cu): % of its roofline."""

from benchmark.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "classic_window_kernel")
