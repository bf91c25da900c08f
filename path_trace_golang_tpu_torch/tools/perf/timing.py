"""Device selection and timing shared by the perf probes.

On the card a launch is timed with CUDA events over ``n`` launches after
one warm-up launch.  A probe's launch can take less time on the card than
its wrapper takes on the host (tens of microseconds), so the card is first
held busy by a spin kernel (``torch.cuda._sleep``) while the host enqueues
the ``n`` launches: the events then time the launches back to back, not the
host's pace.  On the CPU (``--device cpu``, the plain versions) the host
clock times them, and the probes label those times as such: they say how
fast PyTorch's CPU kernels are, nothing about the card.
"""

from __future__ import annotations

import time

import torch

SPIN_CYCLES_PER_CALL = 10_000_000  # ~5 ms of the card's clock: more than the host takes to enqueue one call


def resolve(device: str) -> torch.device:
    """The probes' device: the card unless the caller asks for the CPU; no
    card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on an NVIDIA card (pass --device cpu for the plain versions)")
    return dev


def describe(dev: torch.device) -> str:
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return f"{props.name}, {props.multi_processor_count} SMs (times: CUDA events)"
    return "cpu: the plain PyTorch versions (times: host clock, not a device metric)"


def full_card_blocks(dev: torch.device, per_sm: int = 8) -> int:
    """A grid that fills the card: ``per_sm`` blocks on every SM (one block
    a TPU block on the CPU, where there is no card to fill)."""
    if dev.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(dev).multi_processor_count * per_sm


def ms_per_launch(fn, n: int, dev: torch.device) -> float:
    """Mean time of one ``fn()`` in ms over ``n`` calls after one warm-up."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * n)  # the host enqueues the n calls meanwhile
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) * 1e3 / n
