"""Kernel B1's regeneration instance (csrc/render_pass.cu, B2 inside on a paged mesh): % of its roofline."""

from benchmark.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "render_pass_kernel")
