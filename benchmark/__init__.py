"""The benchmark of the PyTorch / CUDA port (``path_trace_golang_tpu_torch``): see README.md."""
