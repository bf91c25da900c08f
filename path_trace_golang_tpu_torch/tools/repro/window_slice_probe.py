"""Probe: a data-dependent window of a table inside a kernel: repro T5.

Counterpart of the JAX package's ``tools/repro/window_slice_probe.py``:
each lane gathers its page's column of a bf16 table through a one-hot
product over the W = 256 pages from the window's base (the smallest live
page, floored to 128 and clamped), in two layouts of the table
(``ops/repro.py::window_slice``):

  A. the table bf16[96, 512]: the window is 96 strided runs of 512 bytes
  B. its transpose bf16[512, 96]: the window is one contiguous run

Each output is held to the numpy gather, as in the JAX script, and each
layout's kernel is timed.  A failed build or launch raises.

Usage: python -m path_trace_golang_tpu_torch.tools.repro.window_slice_probe
       [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import repro
from ..perf import timing

R, P, W, LANE = 96, 512, repro.WINDOW, repro.LANE
NAMES = {"A": "A lane-dim dslice", "B": "B transposed sublane dslice"}


def make_inputs(device="cuda"):
    """The JAX script's inputs from ``default_rng(0)``: the table bf16[R, P]
    (float64 draws converted to bf16 in one step), the pages int32[1, LANE]
    with lane 7 dead, and the expected f32[R, LANE] (numpy)."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((R, P))).to(torch.bfloat16)
    p_l = rng.integers(100, 220, size=(1, LANE)).astype(np.int32)
    p_l[0, 7] = -1
    cols = table.float().numpy()
    want = np.zeros((R, LANE), np.float32)
    for i in range(LANE):
        if p_l[0, i] >= 0:
            want[:, i] = cols[:, p_l[0, i]]
    return table.to(device), torch.from_numpy(p_l).to(device), want


def special_inputs(device="cuda") -> dict:
    """The kernel's closed form against special values, {case: (table
    bf16[R, P], pages int32[1, LANE])}: the tool's table and pages (window
    [0, 256), pages 100-219, lane 7 dead) with, by case:
    ``zeros`` -0 and +0 at the pages of lanes 0 and 1 (rows 0-7);
    ``-0 in a negative row`` row 5 made negative with -0 at lane 0's page,
    and row 6 negative (every term of a row is then -0 but the selected);
    ``inf at a page`` +inf at lane 2's page in row 9, its only non-finite
    entry; ``-inf off the pages`` -inf at column 10 of row 11;
    ``inf past the window`` +inf at column 256 of row 13 (outside: no
    effect); ``nan off the pages`` NaN at column 20 of row 15;
    ``bf16 overflow`` 3.4e38 at lane 3's page in row 17 and at column 30 of
    row 19, inf once rounded to bf16; ``dead lanes`` lanes 0-3 at page -1;
    ``pages past the window`` lanes 9-11 at pages 256, 300 and 511."""
    table, p_l, _want = make_inputs("cpu")
    t0, pages = table.float(), p_l[0].tolist()
    inf, nan = float("inf"), float("nan")
    cases = {}

    def case(name, edits=(), lanes=()):
        t, p = t0.clone(), p_l.clone()
        for fn in edits:
            fn(t)
        for lane, page in lanes:
            p[0, lane] = page
        cases[name] = (t.to(torch.bfloat16), p)

    def negative(row):
        def fn(t):
            t[row] = -t[row].abs()
        return fn

    def put(row, col, v):
        def fn(t):
            t[row, col] = v
        return fn

    case("zeros", [lambda t: t[:8, pages[0]].fill_(-0.0), lambda t: t[:8, pages[1]].fill_(0.0)])
    case("-0 in a negative row", [negative(5), negative(6), put(5, pages[0], -0.0)])
    case("inf at a page", [put(9, pages[2], inf)])
    case("-inf off the pages", [put(11, 10, -inf)])
    case("inf past the window", [put(13, W, inf)])
    case("nan off the pages", [put(15, 20, nan)])
    case("bf16 overflow", [put(17, pages[3], 3.4e38), put(19, 30, 3.4e38)])
    case("dead lanes", lanes=[(k, -1) for k in range(4)])
    case("pages past the window", lanes=[(9, W), (10, 300), (11, P - 1)])
    return {name: (t.to(device), p.to(device)) for name, (t, p) in cases.items()}


def layout_table(table: torch.Tensor, layout: str) -> torch.Tensor:
    return table if layout == "A" else table.T.contiguous()


def run(device: str = "cuda", n: int = 20) -> dict:
    """Both layouts: correctness against the numpy gather and the time of one
    launch; returns {layout: {"correct", "ms"}}."""
    dev = timing.resolve(device)
    print(f"device: {timing.describe(dev)}")
    table, p_l, want = make_inputs(dev)
    results = {}
    for layout in repro.LAYOUTS:
        tab = layout_table(table, layout)
        out = repro.window_slice(tab, p_l, layout).cpu().numpy()
        ok = np.array_equal(out, want)
        print(f"{NAMES[layout]}: compiled, correct={ok}", flush=True)
        if not ok:
            bad = np.argwhere(out != want)
            print(f"  first mismatch {bad[0]}: {out[tuple(bad[0])]} vs {want[tuple(bad[0])]}")
        ms = timing.ms_per_launch(lambda: repro.window_slice(tab, p_l, layout), n, dev)
        results[layout] = {"correct": ok, "ms": ms}
        print(f"  {ms:.4f} ms a launch (window of {W} pages at base {repro.window_base(p_l.reshape(-1), P)})")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.device, 1 if torch.device(a.device).type == "cpu" else 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
