"""Dynamic page-tile fetch cost by table layout: perf probe T3.

Counterpart of the JAX package's ``tools/perf/fetch_probe.py``: a block of
32x128 outputs loops over the P = 80 page tiles of a table and adds each
tile's first and last element (``ops/probes.py::tile_fetch``).  On the card
a block stages each tile whole into shared memory, as a redesigned walk
would, so the time is the cost of moving one tile by layout:

* a  (P, 128, 32)  triangles on rows, attributes minor (the shipping layout)
* b  (P, 32, 128)  attributes on rows, triangles minor
* c  (P*32, 128)   2D, a 32-row slice (a, b and c: the same 16 KB a tile)
* d  (P*8, 128)    2D, an 8-row slice (4 KB a tile)

Two grids: the TPU probe's 16 blocks (one block an SM, with the kernel's
ring of three tiles in flight) and one that fills the card (8 blocks an
SM).  On 16 blocks every layout takes ~0.11 us a tile: a 16 KB tile is the
rate one SM takes bytes in, and a 4 KB tile (d) the rate at which one
block's bulk copies come back, so there the comparison between layouts
reads the kernel's issue loop, not the layouts' bytes (PERF.md).
The full-card grid still tells d from a.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.fetch_probe
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import probes
from . import timing

P = 80
ROWS = 32
N_BLOCKS = 16
LANE = 128
SHAPES = {"a": (P, 128, 32), "b": (P, 32, 128), "c": (P * 32, 128), "d": (P * 8, 128)}


def make_table(layout: str, seed: int = 0, device="cuda") -> torch.Tensor:
    """The layout's table of uniform [0, 1) floats from ``seed`` (the JAX
    probe draws the same values from numpy's global generator seeded so)."""
    t = np.random.RandomState(seed).rand(*SHAPES[layout]).astype(np.float32)
    return torch.from_numpy(t).to(device)


def run(device: str = "cuda", n: int = 10) -> dict:
    """Time every layout on both grids; returns {(grid, layout): {"ms",
    "us_per_fetch"}}."""
    dev = timing.resolve(device)
    print(f"device: {timing.describe(dev)}")
    grids = {"tpu-grid": N_BLOCKS}
    if dev.type == "cuda":
        grids["full-card"] = timing.full_card_blocks(dev)
    results = {}
    for grid, blocks in grids.items():
        x = torch.zeros((ROWS * blocks, LANE), dtype=torch.float32, device=dev)
        for layout in probes.TILE_LAYOUTS:
            table = make_table(layout, 0, dev)
            ms = timing.ms_per_launch(lambda: probes.tile_fetch(layout, table, x, P), n, dev)
            us = ms * 1e3 / P
            results[(grid, layout)] = {"ms": ms, "us_per_fetch": us}
            print(f"{grid} ({blocks} blocks) layout {layout}: {ms:7.4f} ms/launch, {us:7.4f} us/fetch "
                  f"({probes.TILE_ELEMS[layout] * 4} bytes a tile and block)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.device, 1 if torch.device(a.device).type == "cpu" else 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
