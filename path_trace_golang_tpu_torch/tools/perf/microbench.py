"""Op-throughput roofline of the card: perf probe T1.

Counterpart of the JAX package's ``tools/perf/microbench.py``: the
sustained throughput of the op classes the bounce loop is made of (fma,
sqrt, rsqrt, divide, exp, sin, the u32 hash draw, compare+select), each a
long dependent chain inside one kernel (``ops/probes.py::op_chain``), so
nothing can fold the work away.  Two classes are added: ``ffma``, one fused
multiply-add (the slot that the f32 peak counts), beside ``fma``, which the
port's kernels compile to a multiply and an add (``--fmad=false``).

Two shapes: the TPU probe's one block of 256x128 (one chain per thread, a
few warps an SM: the chains' latency), and a grid that fills the card
(every SM full, 4 independent chains per thread: the issue rate).  The
fma-slot equivalents (the cost of one op in units of one fused
multiply-add, and of one unfused fma) use the full-card rates.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.microbench
       [--device cpu] [--iters N]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ...ops import probes
from . import timing

ROWS, LANE = 256, 128  # the TPU probe's block
INNER = probes.OP_INNER["fma"]  # ops per loop iteration (the hash: 16 rounds)
ITERS = 2000
CHAIN = 20  # dependent launches per timed measurement
ILP = 4  # independent chains per thread on the full-card grid
LABELS = {"fma": "fma", "ffma": "ffma", "sqrt": "sqrt", "rsqrt": "rsqrt", "divide": "divide", "exp": "exp",
          "sin": "sin", "hash": "rng draw", "select": "cmp+select"}


def shapes(dev: torch.device) -> dict:
    """shape name -> (elements, chains per thread)."""
    out = {"tpu-block": (ROWS * LANE, 1)}
    if dev.type == "cuda":
        out["full-card"] = (timing.full_card_blocks(dev, per_sm=8) * 256 * ILP, ILP)
    return out


def run(device: str = "cuda", iters: int = ITERS, chain: int = CHAIN, kinds=probes.OP_KINDS) -> dict:
    """Time every class on every shape; print the JAX probe's lines and the
    fma-slot equivalents.  Returns {shape: {class: {"ms", "gops", "ops",
    "finite"}}}: ``ms`` for one launch, ``ops`` the ops one launch does."""
    dev = timing.resolve(device)
    print(f"device: {timing.describe(dev)}")
    results = {}
    for shape, (n, ilp) in shapes(dev).items():
        print(f"-- {shape}: {n} elements, {ilp} chain(s) a thread, {iters} iterations")
        res = results[shape] = {}
        x = torch.full((n,), 0.73, dtype=torch.float32, device=dev)
        for kind in kinds:
            out = [x]

            def call():
                r = x
                for _ in range(chain):
                    r = probes.op_chain(kind, r, iters, ilp)
                out[0] = r

            ms = timing.ms_per_launch(call, 1, dev) / chain
            ops = n * iters * probes.OP_INNER[kind]
            name = f"{LABELS[kind]} (x{probes.OP_INNER[kind]})"
            res[kind] = {"ms": ms, "gops": ops / ms / 1e6, "ops": ops,
                         "finite": bool(torch.isfinite(out[0]).all())}
            print(f"{name:18s} {res[kind]['gops']:10.1f} Gop/s   ({ms * chain:.2f} ms / {chain} calls)")
    top = results.get("full-card", results["tpu-block"])
    for ref in ("ffma", "fma"):
        if ref in top:
            print(f"\nfma-slot equivalents on the {'full-card' if 'full-card' in results else 'tpu-block'} "
                  f"shape (cost of one op in units of one {ref}):")
            for kind, r in top.items():
                if kind != ref:
                    print(f"  {LABELS[kind]:12s} {top[ref]['gops'] / r['gops']:6.2f}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None, help=f"default {ITERS} on the card, 4 on the CPU")
    a = ap.parse_args(argv)
    cpu = torch.device(a.device).type == "cpu"
    res = run(a.device, a.iters or (4 if cpu else ITERS), 1 if cpu else CHAIN)
    return 0 if all(r["finite"] for s in res.values() for r in s.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
