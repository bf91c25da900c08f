"""Fetch-cost attribution: perf probe T4.

Counterpart of the JAX package's ``tools/perf/fetch_probe2.py``: five
variants over a f32[P*32, 128] table read as P = 80 tiles of 32x128
(``ops/probes.py::fetch_attrib``): ``loop_only`` (the loop, nothing
read), ``dyn_row`` (one row a tile), ``dyn_vec`` (every tile streamed and
summed, then a sum over rows), ``static_vec`` (the same, the page loop
unrolled), ``dyn_scalar`` (one element a tile).  Two grids: the TPU
probe's 16 blocks and one that fills the card.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.fetch_probe2
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import probes
from . import timing

P, ROWS, N_BLOCKS, LANE = 80, 32, 16, 128


def make_table(seed: int = 0, device="cuda") -> torch.Tensor:
    """f32[P*32, 128] of uniform [0, 1) floats from ``seed``."""
    return torch.from_numpy(np.random.RandomState(seed).rand(P * 32, 128).astype(np.float32)).to(device)


def run(device: str = "cuda", n: int = 10) -> dict:
    """Time every variant on both grids; returns {(grid, variant): {"ms",
    "us_per_page"}}."""
    dev = timing.resolve(device)
    print(f"device: {timing.describe(dev)}")
    table = make_table(0, dev)
    grids = {"tpu-grid": N_BLOCKS}
    if dev.type == "cuda":
        grids["full-card"] = timing.full_card_blocks(dev)
    results = {}
    for grid, blocks in grids.items():
        x = torch.zeros((ROWS * blocks, LANE), dtype=torch.float32, device=dev)
        for v in probes.FETCH_VARIANTS:
            ms = timing.ms_per_launch(lambda: probes.fetch_attrib(v, table, x, P), n, dev)
            results[(grid, v)] = {"ms": ms, "us_per_page": ms * 1e3 / P}
            print(f"{grid} ({blocks} blocks) {v:11s}: {ms:7.4f} ms/launch, {ms * 1e3 / P:7.4f} us/page")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.device, 1 if torch.device(a.device).type == "cpu" else 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
