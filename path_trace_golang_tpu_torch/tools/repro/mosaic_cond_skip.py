"""Does a uniform branch inside a kernel skip its work: repro T6.

Counterpart of the JAX package's ``tools/repro/mosaic_cond_skip.py``: a
kernel runs ``rounds`` rounds whose body guards 32 serial products
``c <- a @ c`` with a flag read from device memory, so that the same
kernel runs both ways; a cond-free control kernel anchors the cost of the
chain (``ops/repro.py::cond_chain``).  Calls are timed one by one (CUDA
events; on the CPU the host clock), interleaved control, true, false, four
times, and the checksums printed as the JAX script prints them.

The JAX script's ``b`` is all ones, and each row of its ``a`` sums to 1.0f,
so ``a @ ones == ones`` bit for bit: the three checksums agree and the
script's fold WARNING always prints.  It is kept as the JAX script has it;
the kernel is held to its plain version on a random ``b`` elsewhere
(``chip_smoke.py``, ``tests/test_torch_repro.py``).

Usage: python -m path_trace_golang_tpu_torch.tools.repro.mosaic_cond_skip
       [rounds] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ...ops import repro
from ..perf import timing

N = repro.LANE
ROUNDS = 16384


def make_a() -> np.ndarray:
    """The JAX script's ``_mk_a``: a permutation with weight 0.9 plus a
    second one with weight 0.1 (f32[N, N])."""
    i = np.arange(N)
    a = np.zeros((N, N), np.float32)
    a[i, (i + 1) % N] = 0.9
    a[i, (i * 7 + 3) % N] += 0.1
    return a


def make_inputs(device="cuda"):
    """(a, b): ``make_a()`` and the JAX script's ones."""
    return torch.from_numpy(make_a()).to(device), torch.ones((N, N), dtype=torch.float32, device=device)


def time_call(fn, dev: torch.device):
    """One call of ``fn`` in seconds (CUDA events on the card), and its result."""
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        r = fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / 1e3, r
    t0 = time.perf_counter()
    r = fn()
    return time.perf_counter() - t0, r


def run(rounds: int = ROUNDS, device: str = "cuda", reps: int = 4) -> dict:
    """Print the JAX script's lines; returns {"ms": {name: [ms, ...]},
    "sums": {name: checksum}} for ``ctrl``, ``true`` and ``false``."""
    dev = timing.resolve(device)
    print(f"device: {timing.describe(dev)}; rounds={rounds}, {repro.INNER} products a round")
    a, b = make_inputs(dev)
    flags = {v: torch.full((1,), v, dtype=torch.int32, device=dev) for v in (0, 1)}
    runs = {"ctrl": (True, 1), "true": (False, 1), "false": (False, 0)}

    def once(name):
        control, flag = runs[name]
        dt, r = time_call(lambda: repro.cond_chain(flags[flag], a, b, rounds, control), dev)
        return dt, float(r.abs().sum())

    once("true"), once("ctrl")  # build and warm both kernels
    ts = {name: [] for name in runs}
    sums = {}
    for _ in range(reps):  # interleaved, as the JAX script
        for name in runs:
            dt, s = once(name)
            ts[name].append(dt)
            sums[name] = s
    for name in runs:
        print(f"{name:5s}: {min(ts[name]) * 1e3:8.2f} ms  sum={sums[name]:.4e}"
              f"  {[f'{t * 1e3:.2f}' for t in ts[name]]}")
    t_ctrl, t_true, t_false = (min(ts[k]) for k in runs)
    if sums["true"] == sums["false"]:
        print("WARNING: cond-true and cond-false agree -> loop folded, probe invalid")
    if t_ctrl < 3 * t_false or t_true < 3 * t_false:
        print(f"note: raise rounds (ctrl {t_ctrl * 1e3:.2f} ms barely above skip)")
    ratio = t_true / max(t_false, 1e-9)
    print(f"true/false {ratio:.2f}x -> "
          + ("cond BRANCHES (skip is real)" if ratio > 1.5 else "cond PREDICATES or chain too small"))
    return {"ms": {k: [t * 1e3 for t in v] for k, v in ts.items()}, "sums": sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rounds", nargs="?", type=int, default=ROUNDS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.rounds, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
