"""The fog kernel (fog_pass_kernel, csrc/render_pass.cu): % of its roofline."""

from benchmark.harness import readers


def read(run):
    return readers.kernel_roofline_pct(run, "fog_pass_kernel")
