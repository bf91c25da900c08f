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


def special_inputs(device="cuda") -> dict:
    """Stage 5's inputs with special values, {case: (x, w)}: the tool's x
    with a NaN and a run of negative entries (where acc starts at -0, so the
    sign of a zero contribution shows), and the tool's w with, by case:
    ``zeros`` -0, +0 and -0 as the least entries of the pops' columns 1, 2
    and 4 (their other entries made positive; the -0 of column 4 in a row
    of negative entries); ``inf at a pop`` that and a -inf at column 4, its
    row's only non-finite entry;
    ``inf off the pops`` a +inf at column 100; ``nan`` a NaN at column 2;
    ``bf16 overflow`` a finite entry that rounds to inf in bf16."""
    x, w0 = make_inputs("cpu")
    x = x.clone()
    x[0, 5] = float("nan")
    x[1, :16] = -x[1, :16]
    zeros = w0.clone()
    zeros[3] = -zeros[3].abs()
    for c in (1, 2, 4):
        zeros[:, c] = zeros[:, c].abs()
    zeros[40, 1], zeros[41, 2], zeros[3, 4] = -0.0, 0.0, -0.0
    cases = {"zeros": zeros}
    cases["inf at a pop"] = zeros.clone()
    cases["inf at a pop"][9, 4] = -float("inf")
    for case, (r, c, v) in {"inf off the pops": (9, 100, float("inf")), "nan": (11, 2, float("nan")),
                            "bf16 overflow": (13, 4, 3.4e38)}.items():
        cases[case] = w0.clone()
        cases[case][r, c] = v
    return {case: (x.to(device), w.to(device)) for case, w in cases.items()}


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
