"""Estimate the traced segments of one render inside its frame with the plain reference, and freeze them.

    python3 benchmark/tools/frame_segments.py [--cells a,b] [--renders 4] [--pairs 65536] [--write]

On the card.  For each final cell: ``--renders`` render seeds, and for each
``--pairs`` (pixel, pass) pairs drawn uniformly over the frame's own pixels
(not the lanes that pad its last chunk) and the render's passes, traced by
``benchmark/reference``; the mean segments of a pair times the frame's
pixels and passes is one render's segments.  Nothing of the port runs.
With ``--write`` the estimate goes into ``work/<cell>.json`` as
``frame_segments``, which the cell's rate takes as one render's work.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import check, spec  # noqa: E402
from benchmark.harness.stats import sub_seed  # noqa: E402
from benchmark.reference import lanes  # noqa: E402


def estimate(cell, renders: int, pairs: int, device: str) -> dict:
    import torch

    st = spec.resolve_settings(cell.traffic, cell.config["scene"])
    w, h, passes = st["width"], st["height"], st["passes"]
    frame = lanes.Frame(lanes.load_scene(cell.config["scene"]), cell.traffic["contract"], w, h, st["depth"], device)
    rng = np.random.default_rng(sub_seed(1, 7))
    per = []
    for i in range(renders):
        seed = sub_seed(1, 0, i)
        lane = rng.integers(0, w * h, size=pairs)
        p = rng.integers(0, passes, size=pairs)
        _cols, segs = check._trace(frame, lane % w, lane // w, (seed + p) & 0xFFFFFFFF, np.zeros(pairs, int), None,
                                   device)
        per.append(segs.to(torch.float64).cpu().numpy())
    segs = np.concatenate(per)
    mean, se = float(segs.mean()), float(segs.std(ddof=1) / math.sqrt(len(segs)))
    return {"value": int(round(mean * w * h * passes)), "se_share": se / mean, "pairs": int(len(segs)),
            "renders": renders, "pixels": w * h, "passes": passes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cells", default="showcase-gpu-final,mesh10k-gpu-final,showcase-cpu-final")
    p.add_argument("--renders", type=int, default=4)
    p.add_argument("--pairs", type=int, default=65536)
    p.add_argument("--write", action="store_true", help="store the estimate in work/<cell>.json")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("frame_segments: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    bench = spec.load_benchmark()
    for name in args.cells.split(","):
        est = estimate(spec.find_cell(bench, name), args.renders, args.pairs, "cuda")
        est["card"] = smi
        print(json.dumps({"cell": name, "frame_segments": est}), flush=True)
        if args.write:
            path = spec.BENCH_DIR / "work" / f"{name}.json"
            work = json.loads(path.read_text())
            work["frame_segments"] = est
            path.write_text(json.dumps(work, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
