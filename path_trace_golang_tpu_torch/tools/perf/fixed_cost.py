"""A render's fixed cost: the port's fixed_cost tool.

Counterpart of the JAX package's ``tools/perf/fixed_cost.py``.  Renders
bench_mesh (10,240 triangles) at 512x512, depth 8, with 1 and with 4
passes, reps interleaved, and fits ``t = F + c*spp`` through the best of
each (:func:`fit`).  Then the parts of F, each timed alone with the card
synchronised, the best of 5 after a warm-up:

* finalize   ``post.finalize_gpu_contract`` on a 512x512 accumulator and
             the u8 image's read-back;
* nonfinite  ``utils/metrics.nonfinite_count`` and its read;
* null       a one-element add and ``.item()``: the bare round trip;
* upload     4 MB from the host to the card.

and "accounted": finalize + nonfinite against F (as the JAX tool adds them).

Usage: python -m path_trace_golang_tpu_torch.tools.perf.fixed_cost [reps]
       [--size N] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import timing


def fit(t1s, t4s):
    """(F, c) of ``t = F + c*spp`` through the best 1-pass and 4-pass times
    (JAX fixed_cost.py:59-64)."""
    t1, t4 = min(t1s), min(t4s)
    slope = (t4 - t1) / 3.0
    return t1 - slope, slope


def best_of(fn, dev, n: int = 5) -> float:
    """The least of ``n`` timed calls of ``fn`` after one warm-up, each
    ending with the card synchronised."""
    fn()
    timing.sync(dev)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        timing.sync(dev)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=3)
    ap.add_argument("--size", type=int, default=512, help="the frame's width and height (512)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)

    import path_trace_golang_tpu_torch as pt
    from ...post import finalize_gpu_contract
    from ...scene import builtin
    from ...utils import metrics as metrics_mod

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    sc = builtin.bench_mesh()
    w = h = args.size
    renderer = pt.Renderer(contract="gpu", seed=3, device=dev)

    def run(spp: int) -> float:
        t0 = time.perf_counter()
        renderer.render(sc, pt.RenderConfig(w, h, spp, 8))
        return time.perf_counter() - t0

    print("first renders at spp=1 and spp=4 ...", flush=True)
    run(1)
    run(4)
    t1s, t4s = [], []
    for _ in range(args.reps):  # interleaved
        t1s.append(run(1))
        t4s.append(run(4))
    fixed, slope = fit(t1s, t4s)
    print(f"spp=1: {min(t1s):.4f}s {[round(t, 4) for t in t1s]}")
    print(f"spp=4: {min(t4s):.4f}s {[round(t, 4) for t in t4s]}")
    print(f"fit: t = {fixed:.4f} + {slope:.4f}*spp", flush=True)

    accum = torch.full((h, w, 3), 0.5, dtype=torch.float32, device=dev)
    t_fin = best_of(lambda: finalize_gpu_contract(accum, 1).cpu().numpy(), dev)
    t_nf = best_of(lambda: int(metrics_mod.nonfinite_count(accum)), dev)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    t_null = best_of(lambda: (one + 1.0).item(), dev)
    host = np.zeros(1 << 20, np.float32)
    t_up = best_of(lambda: torch.from_numpy(host).to(dev), dev)
    print(f"finalize + {w * h * 3 / 1e6:.2f} MB read-back: {t_fin * 1e3:.3f} ms")
    print(f"nonfinite reduce + read: {t_nf * 1e3:.3f} ms")
    print(f"null dispatch round trip: {t_null * 1e3:.3f} ms")
    print(f"4 MB host->device upload: {t_up * 1e3:.3f} ms")
    print(f"accounted: {(t_fin + t_nf) * 1e3:.3f} ms of {fixed * 1e3:.3f} ms fixed", flush=True)
    return timing.finish("fixed_cost", dev, {
        "size": args.size, "depth": 8, "reps": args.reps, "spp1_s": t1s, "spp4_s": t4s, "fixed_s": fixed,
        "per_spp_s": slope, "finalize_s": t_fin, "nonfinite_s": t_nf, "null_dispatch_s": t_null,
        "upload_4mb_s": t_up, "accounted_s": t_fin + t_nf}, args.out)


if __name__ == "__main__":
    sys.exit(main())
