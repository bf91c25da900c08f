"""The readings that the correctness limits are set from: the port and the control, seed by seed.

    python3 benchmark/tools/control.py --workload <cell> --seeds 11,12,13 [--seconds s] [--out file]

On the card, at the cell's own size: for each seed, a short window of the
cell's own loop (one render, or the editor's frames for ``--seconds``),
then the check's reference on the check's own sample, through the check's
own ``readings``.  Prints a JSON line a seed with the compared numbers of
the port (``program``, as a benchmark run reads them) and of the control
(``control``): the reference put in the port's place with each pass's
radiance and the accumulator in bfloat16, the nearest precision below the
float32 that the renderer states, judged by the same numbers against the
float32 reference; and each side's verdict against the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import check, spec  # noqa: E402


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    """The port's and the control's compared numbers for one seed, each
    with its verdict against the cell's limits (``check.verdict``)."""
    import torch

    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.scene.model import Scene

    traffic, scene_json = cell.traffic, cell.config["scene"]
    settings = spec.resolve_settings(traffic, scene_json)
    module = spec.find_loop(traffic["loop"], cell.bench_dir)
    loop = module.Loop(pt, Scene.from_json(scene_json), settings, traffic, seed, device)
    window = loop.window(seconds, phases=False)
    loop.close()
    if device == "cuda":
        torch.cuda.empty_cache()
    prog, ctrl = check.readings(window, traffic, settings, scene_json, seed, device, module, (None, torch.bfloat16))
    failed = sum(1 for r in window.renders if r.error is not None)
    return {"seed": seed, "renders": len(window.renders), "program": prog, "control": ctrl,
            "program_correct": check.verdict(prog, cell.limits, failed)[0],
            "control_correct": check.verdict(ctrl, cell.limits, failed)[0]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=0.0, help="each seed's window (0: one render or frame)")
    p.add_argument("--out", default=None, help="append the lines to this file too")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = {"cell": cell.name, **readings(cell, seed, args.seconds, "cuda"),
                "seconds": time.perf_counter() - t, "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
