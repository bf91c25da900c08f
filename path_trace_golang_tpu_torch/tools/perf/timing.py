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

import json
import os
import subprocess
import sys
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


# the plain versions' call counters of ops/cuda_trace.py: a render on the card calls none of them
PLAIN_COUNTERS = ("PLAIN_CALLS", "FOG_PLAIN_CALLS", "TRACE_PLAIN_CALLS", "WALK_PLAIN_CALLS")


def plain_calls() -> int:
    """Calls of the plain versions in this process so far."""
    from ...ops import cuda_trace

    return sum(getattr(cuda_trace, c) for c in PLAIN_COUNTERS)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them (the name
    alone where nvidia-smi cannot be read); "cpu" on the CPU."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
                              str(index)], capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(index)


def scene_named(name: str, fallback: str):
    """(scene, label): the scene file that ``scene.builtin.find_scene`` resolves ``name`` to, else the builtin
    scene of that name, else the builtin ``fallback`` (as the JAX package's bench.py:108-114 falls back to
    demo_showcase); the label says which."""
    from ...scene import builtin
    from ...scene import io as scene_io

    path = builtin.find_scene(name)
    if path is not None:
        return scene_io.load(path), os.path.basename(path)
    sc = builtin.builtin_scene(name)
    if sc is not None:
        return sc, f"{name}(builtin)"
    return builtin.builtin_scene(fallback), f"{fallback}(builtin; no file for {name})"


def finish(tool: str, dev: torch.device, fields: dict, out=None, plain=None) -> int:
    """Print the tool's one JSON line (and write it to ``out`` where given): the tool, the device, the card's
    name and power limit, the plain versions' calls (``plain``, or this process's) and ``fields``.  Returns the
    exit code: 1 where a render on the card called a plain version."""
    plain = plain_calls() if plain is None else plain
    text = json.dumps({"tool": tool, "device": str(dev), "card": card_line(dev), "plain_calls": plain, **fields})
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    if dev.type == "cuda" and plain:
        print(f"{tool}: FAIL: {plain} calls of a plain version on the card", file=sys.stderr)
        return 1
    return 0


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
