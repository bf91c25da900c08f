"""The Mosaic repros T5-T8 on the card: counterparts of the JAX package's TPU
repros of the same names under the repository's ``tools/repro/``.

Run each as ``python -m path_trace_golang_tpu_torch.tools.repro.<name>``
(``window_slice_probe``, ``mosaic_cond_skip``, ``mosaic_reshape_repro``,
``group_rows_relayout``); add ``--device cpu`` to run the plain PyTorch
versions instead of the kernels.
"""
