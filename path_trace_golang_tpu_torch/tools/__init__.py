"""Command-line tools of the PyTorch/CUDA port (``tools/perf``: the perf probes)."""
