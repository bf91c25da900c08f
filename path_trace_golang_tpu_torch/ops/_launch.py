"""Dispatch, argument checks and error reporting for kernels bound through ctypes.

Shared by the ops modules of the probes and the repros (``probes.py``,
``repro.py``) and by ``cuda_trace.py``: each public function there runs its
kernel on a CUDA tensor and its plain version on a CPU tensor, and a failed
launch raises with the library's own message.
"""

from __future__ import annotations

import torch


def on_device(what: str, t: torch.Tensor, plain, cuda, *args):
    """Dispatch on the device of ``t``: the kernel on CUDA, the plain version on the CPU."""
    if t.is_cuda:
        return cuda(*args)
    if t.device.type == "cpu":
        return plain(*args)
    raise NotImplementedError(f"{what}: no kernel for device {t.device}")


def check(what: str, *pairs) -> None:
    """``pairs``: (tensor, dtype); every tensor contiguous, of its dtype, on one CUDA device."""
    first = pairs[0][0]
    for t, dtype in pairs:
        if not t.is_cuda:
            raise ValueError(f"{what}: the kernel needs CUDA tensors, got {t.device}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: needs a contiguous {dtype} tensor, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{what}: every tensor must be on one device")


def stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.pt_error_string(err).decode()}")
