"""Where the card sits idle in a traced window, named by the port's own spans.

    python3 benchmark/tools/idle_by_span.py --workload <cell> --seed <n> --seconds <s> [--out file]

On the card.  One run of the cell as ``benchmark/run.py --trace 1`` makes
it (set-up, then torch.profiler over the window, the launch guard), but
with the phase table off, so that nothing synchronises the card that an
untraced run does not.  The port's spans of the window's renders or editor
frames (``harness/spans.py``) are laid on the profiler's clock by the
offset measured in this process, which is held first to two probe ranges
(``spans.clock_probe``, one as the profiler starts, one before it stops:
``probes`` gives each one's error and the widths of its brackets, in µs);
then each stretch of the window in which no operation ran on the card goes
to the innermost span open on any thread at that moment.  Prints one JSON
line (and exits 1 where the offset misplaces a probe by more than
``MAX_OFFSET_ERROR_S`` or the launch guard fails: ``faults``): the idle ms
under each span (by its path below the root; ``""`` is the part under no
span), the share under a named span below the root, and, a render or
frame, the medians of ``progress_ms``, the time to the first progress
frame, ``syncs``, ``readback_bytes``, the pack's split, the pass windows
and ``session_span_ms``; the window's counters summed (``counters``: the
BVH cache's hits and misses, the editor's debounce timers scheduled and
cancelled, ...); the warm-up render's ``kernels.load`` and
``kernels.build`` beside ``setup_s``, and its counters; and what one span
costs the host here.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path
from statistics import median

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import spans as hs  # noqa: E402
from benchmark.harness import spec  # noqa: E402
from benchmark.harness.stats import idle_gaps  # noqa: E402

MAX_OFFSET_ERROR_S = 2e-4


def span_cost_ns(n: int = 20000) -> dict:
    """The host's cost of one span and one count in a bound trace, ns."""
    from path_trace_golang_tpu_torch.utils import metrics

    tr = metrics.Trace()
    root = tr.open("cost")
    with metrics.bound(tr, root):
        t = time.perf_counter_ns()
        for _ in range(n):
            with metrics.span("x"):
                pass
        t_span = time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        for _ in range(n):
            metrics.count("x")
        t_count = time.perf_counter_ns() - t
    return {"span_ns": t_span / n, "count_ns": t_count / n}


def _ms(ns) -> float:
    return ns / 1e6


def per_render(traces) -> dict:
    """The medians over the traces that hold a render: what the spans and
    counters of one render (or editor frame) say."""
    rows = []
    for t in traces:
        r = hs.render_span(t)
        if r is None:
            continue
        named = lambda name: [sp for sp in t.spans if sp.name == name]  # noqa: E731
        prog = named("render.progress")
        rows.append({
            "progress_ms": _ms(sum(sp.ns for sp in prog)),
            "first_progress_ms": _ms(prog[0].end_ns - r.start_ns) if prog else None,
            "render_ms": _ms(r.ns),
            "syncs": t.counters.get("syncs", 0),
            "readback_bytes": t.counters.get("readback_bytes", 0),
            "windows": len(named("render.window")),
            "spans": len(t.spans),
            **{f"{n}_ms": _ms(sum(sp.ns for sp in named(n))) for n in
               ("render.pack", "pack.digest", "pack.bvh_build", "pack.upload", "render.interval", "render.finish")},
            "session_span_ms": hs.session_self_ms(t),
        })
    out = {}
    for k in (rows[0] if rows else {}):
        vals = [row[k] for row in rows if row[k] is not None]
        out[k] = median(vals) if vals else None
    out["renders"] = len(rows)
    return out


def warmup(trace) -> dict:
    """The warm-up render's loads and builds of the kernels' libraries, ms,
    and its counters."""
    if trace is None:
        return {}
    out = {f"{n}_ms": _ms(sum(sp.ns for sp in trace.spans if sp.name == n))
           for n in ("kernels.load", "kernels.build")}
    out["counters"] = dict(trace.counters)
    return out


def probe_errors(prof, probes, offset_ns: int) -> list:
    """Each probe's error (``spans.offset_error_s``) against the range the
    profiler saw, and the widths of its brackets, µs."""
    seen = sorted((s, e) for name, s, e in prof.host_ops if name == hs.PROBE)
    if len(seen) != len(probes):
        return [{"error_us": None, "seen": len(seen)}]
    return [{"error_us": hs.offset_error_s(offset_ns, rng, opened, closed) * 1e6,
             "opened_us": (opened[1] - opened[0]) / 1e3, "closed_us": (closed[1] - closed[0]) / 1e3}
            for rng, (opened, closed) in zip(seen, probes)]


def measure(cell, seed: int, seconds: float, t0: float) -> dict:
    import torch

    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.scene.model import Scene
    from path_trace_golang_tpu_torch.utils import metrics

    from benchmark.harness import trace as tr

    traffic, scene_json = cell.traffic, cell.config["scene"]
    settings = spec.resolve_settings(traffic, scene_json)
    module = spec.find_loop(traffic["loop"], cell.bench_dir)
    loop = module.Loop(pt, Scene.from_json(scene_json), settings, traffic, seed, "cuda")
    loop.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm = metrics.RECENT[-1] if metrics.RECENT else None

    hs.clock_probe()  # the first range a process opens is slow to open: its brackets would be ms wide
    offset = hs.clock_offset_ns()
    before = tr.counters(cuda_trace)
    with tr.Profiled(True) as prof:
        probes = [hs.clock_probe()]
        window = loop.window(seconds, phases=False)
        probes.append(hs.clock_probe())
    after = tr.counters(cuda_trace)
    offset_after = hs.clock_offset_ns()
    prof.device_ops = [op for op in prof.device_ops if op[0] != hs.PROBE]  # a range's mark, should the card get one
    errs = probe_errors(prof, probes, offset)
    faults = tr.launch_mismatches(prof.device_ops, before, after)
    for e in errs:
        if e["error_us"] is None or e["error_us"] > MAX_OFFSET_ERROR_S * 1e6:
            faults.append(f"the spans' clock offset misplaces a probe range: {e}")

    traces = hs.window_traces(window)
    if not traces:
        faults.append("no kept trace a render: the window's spans are not the port's, or not one a render")
    a, b = prof.window
    gaps = idle_gaps([(s, e) for _n, s, e in prof.device_ops], a, b)
    idle = hs.idle_by_span(gaps, [sp for t in traces for sp in t.spans], offset)
    idle_s = sum(idle.values())
    below_root = sum(v for k, v in idle.items() if k not in ("", "render", "session.frame"))
    loop.close()
    return {
        "cell": cell.name, "seed": seed, "card": torch.cuda.get_device_name(0), "faults": faults,
        "setup_s": setup_s, "warmup": warmup(warm),
        "offset_ns": offset, "offset_drift_ns": offset_after - offset, "probes": errs,
        "window_s": b - a, "busy_s": prof.busy_s, "idle_s": idle_s, "renders": len(window.renders),
        "idle_named_share": below_root / idle_s if idle_s > 0 else None,
        "idle_ms": {k: v * 1e3 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "per_render": per_render(traces),
        "counters": dict(sum((collections.Counter(t.counters) for t in traces), collections.Counter())),
        "cost": span_cost_ns(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="append the line to this file too")
    args = p.parse_args(argv)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    for k in [k for k in os.environ if k.startswith("PATHTRACER_")]:  # the run renders as a user does
        del os.environ[k]
    import torch

    if not torch.cuda.is_available():
        print("idle_by_span: needs a CUDA card", file=sys.stderr)
        return 2
    res = measure(cell, args.seed, args.seconds, T0)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    for fault in res["faults"]:  # the line stands, but its idle split is not to be trusted
        print(f"idle_by_span: {fault}", file=sys.stderr)
    return 1 if res["faults"] else 0


if __name__ == "__main__":
    sys.exit(main())
