"""One run of one cell: set-up, the measured window, the trace, the check, the result line.

``main`` is the command (``python3 benchmark/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``); ``run_cell`` is the run itself,
on the card or, in the benchmark's own tests, on the CPU with the port's
plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Optional

from . import spec

__all__ = ["main", "run_cell", "forbidden_modules", "RunResult", "TraceGuardError"]

FORBIDDEN = ("jax", "jaxlib", "flax", "path_trace_golang_tpu")


class TraceGuardError(RuntimeError):
    """The traced window's device record disagrees with the port's counters."""


@dataclasses.dataclass
class TracedRun:
    """What a per-layer metric's reader gets: the window's renders (with
    their phase tables), the profiler's device record and the cell's frozen
    work."""

    renders: list
    device_ops: list
    window_s: float
    busy_s: float
    work: Optional[dict]


@dataclasses.dataclass
class RunResult:
    line: dict
    checks: dict  # name -> (value, limit)


def forbidden_modules() -> list:
    """The top-level names of ``sys.modules`` that the benchmark's process
    must not hold (JAX, or the JAX package that the port was made from),
    compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, control=None) -> RunResult:
    """Set up, measure ``seconds``, check, and build the result line.  With
    ``control`` (a torch dtype) the check judges the control, the reference
    summed in that dtype, in the program's place."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.scene.model import Scene

    from . import check, trace as tr

    traffic, scene_json = cell.traffic, cell.config["scene"]
    settings = spec.resolve_settings(traffic, scene_json)
    card = device == "cuda"
    module = spec.find_loop(traffic["loop"], cell.bench_dir)
    loop = module.Loop(pt, Scene.from_json(scene_json), settings, traffic, seed, device)
    loop.setup()
    if card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    if trace:
        os.environ["PATHTRACER_TIME_PHASES"] = "1"
    before = tr.counters(cuda_trace)
    with tr.Profiled(trace and card) as prof:
        window = loop.window(seconds, phases=trace)
    after = tr.counters(cuda_trace)
    os.environ.pop("PATHTRACER_TIME_PHASES", None)

    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if card else 0}
    if trace:
        if card:
            bad = tr.launch_mismatches(prof.device_ops, before, after)
            if bad:
                raise TraceGuardError("; ".join(bad))
            busy, win = prof.busy_s, prof.window[1] - prof.window[0]
            device_info.update(busy_s=busy, window_s=win)
            breakdown = tr.breakdown(prof)
            run = TracedRun(window.renders, prof.device_ops, win, busy, cell.work)
        else:
            run = TracedRun(window.renders, [], window.seconds, 0.0, cell.work)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = module.quantities(window, cell.work)
        values["setup_s"] = setup_s
        print("benchmark: " + ", ".join(f"{k} {v}" for k, v in values.items()), file=sys.stderr)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}

    # the check, once the program's state is freed: its images stay on the host
    loop.close()
    del loop
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(window, traffic, settings, scene_json, seed, device, module, control)
    print(f"benchmark: set-up {setup_s:.3f} s, window {window.seconds:.3f} s of {len(window.renders)} renders, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    if card:
        numbers["plain_calls"] = sum(after[k] - before[k] for k in tr.PLAIN_COUNTERS)
    failed = sum(1 for r in window.renders if r.error is not None)
    correct, checks = check.verdict(numbers, cell.limits, failed)
    line = {"correct": correct, "attempted": len(window.renders), "failed": failed, "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return RunResult(line, checks)


def _parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = _parse(argv)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    # the run renders as a user does: no knob of the port's is set
    for k in [k for k in os.environ if k.startswith("PATHTRACER_")]:
        del os.environ[k]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    except TraceGuardError as e:
        print(f"benchmark: the trace does not hold the port's launches, nothing reported: {e}", file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)} after the window; nothing reported", file=sys.stderr)
        return 3
    print(json.dumps(res.line))
    sys.stdout.flush()
    for k, (v, lim) in res.checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    return 0
