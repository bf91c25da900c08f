"""The staged relayout repro: repro T7.

Counterpart of the JAX package's ``tools/repro/mosaic_reshape_repro.py``:
x f32[8, 128] regrouped to (8/G, G*128) and run through five escalating
stages (``ops/repro.py::reshape_stage``):

  stage 1  the regrouping and its inverse (identity)
  stage 2  x*2 + 1
  stage 3  a 3-trip loop with an f32 carry
  stage 4  stage 3 with the walk's pop (lowest set bit through float bits)
  stage 5  stage 4 with a one-hot bf16 product of w and a minimum over its rows

Where the JAX script compares the Pallas kernel with the same math traced
by XLA, this compares the kernel with its plain PyTorch version, bit for
bit, and times it.  Exit 1 at the first stage that differs.

Usage: python -m path_trace_golang_tpu_torch.tools.repro.mosaic_reshape_repro
       [G] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import repro
from ..perf import timing

ROWS, LANE = 8, repro.LANE


def make_inputs(device="cuda"):
    """The JAX script's x f32[8, 128] and w f32[128, 128] from ``RandomState(7)``."""
    r = np.random.RandomState(7)
    x = r.uniform(0.5, 2.0, (ROWS, LANE)).astype(np.float32)
    w = r.uniform(-1.0, 1.0, (LANE, LANE)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def run(g: int = 4, device: str = "cuda", n: int = 20) -> dict:
    """Every stage against its plain version; returns {stage: {"ok", "max_abs_diff", "ms"}}."""
    dev = timing.resolve(device)
    print(f"backend={dev.type}  G={g}  ({timing.describe(dev)})", flush=True)
    x, w = make_inputs(dev)
    results = {}
    for stage in repro.STAGES:
        got = repro.reshape_stage(x, w, stage, g)
        want = repro.reshape_stage_plain(x, w, stage, g)
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        diff = float((got - want).abs().max())
        ms = timing.ms_per_launch(lambda: repro.reshape_stage(x, w, stage, g), n, dev)
        results[stage] = {"ok": ok, "max_abs_diff": diff, "ms": ms}
        print(f"stage {stage}: {'ok' if ok else f'MISMATCH (max abs diff {diff:g})'}  ({ms:.4f} ms a launch)",
              flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = run(a.g, a.device, 1 if torch.device(a.device).type == "cpu" else 20)
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
