"""The perf probes T1-T4 on the card: counterparts of the JAX package's TPU
probes of the same names under the repository's ``tools/perf/``.

Run each as ``python -m path_trace_golang_tpu_torch.tools.perf.<name>``
(``microbench``, ``paged_probe``, ``fetch_probe``, ``fetch_probe2``); add
``--device cpu`` to run the plain PyTorch versions instead of the kernels.
"""
