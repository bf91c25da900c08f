"""The grouped-rows relayout repro: repro T8.

Counterpart of the JAX package's ``tools/repro/group_rows_relayout.py``:
x f32[32, 128] regrouped to (32/G, G*128); per wide row a 3-trip loop
``acc <- acc + (acc > min(acc))`` from ``2*row`` (a minimum across the
wide row, folded back into every lane); the regrouping undone
(``ops/repro.py::group_rows``).  Where the JAX script compares the Pallas
kernel with the interpreter and with XLA, this compares the kernel with its
plain PyTorch version, and times it.  Exit 1 on a mismatch.

Usage: python -m path_trace_golang_tpu_torch.tools.repro.group_rows_relayout
       [G] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import repro
from ..perf import timing

ROWS, LANE = 32, repro.LANE


def make_input(device="cuda") -> torch.Tensor:
    """The JAX script's x f32[32, 128] from ``RandomState(7)``."""
    x = np.random.RandomState(7).uniform(-4, 4, (ROWS, LANE)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def run(g: int = 4, device: str = "cuda", n: int = 20) -> dict:
    """The kernel against its plain version; returns {"max_abs_diff", "bit_equal", "ms"}."""
    dev = timing.resolve(device)
    x = make_input(dev)
    ref = repro.group_rows_plain(x, g)
    got = repro.group_rows(x, g)
    d = float((ref - got).abs().max())
    ms = timing.ms_per_launch(lambda: repro.group_rows(x, g), n, dev)
    print(f"G={g}  backend={dev.type}  ({timing.describe(dev)})")
    print(f"  plain-vs-kernel   maxdiff: {d:.6g}  "
          f"(mean ref {float(ref.mean()):.4f} vs kernel {float(got.mean()):.4f}); {ms:.4f} ms a launch")
    return {"max_abs_diff": d, "bit_equal": torch.equal(ref.view(torch.int32), got.view(torch.int32)), "ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("g", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    res = run(a.g, a.device, 1 if torch.device(a.device).type == "cpu" else 20)
    if res["max_abs_diff"] > 1e-5:
        print("  MISMATCH: the kernel disagrees with its plain version")
        return 1
    print("  no mismatch at this G on this device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
