"""Each mesh walk's share of a render: the port's walk_attrib tool.

Counterpart of the JAX package's ``tools/perf/walk_attrib.py``.  Renders
the bvh_bench scene (a 10,240-triangle gold UV sphere, 80 pages, over a
plane with one sphere light) in one process, with
``PATHTRACER_BVH_DROP`` skipping each of the paged mesh walks in turn:

  base             every walk runs (the shipping configuration)
  -closest         the bounce loop's closest-hit walk skipped
  -shadow          NEE's shadow walk skipped
  -spec            the rough-metal specular-NEE walk skipped
  -all             every mesh walk skipped (the object sweep and shading)

The dropped images are wrong by design; only the wall clock matters.
Every configuration renders once first, then the timed renders run in
interleaved reps; each configuration's gap to ``base`` attributes the
render's time.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.walk_attrib [reps]
       [--size N] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import timing
from .bvh_bench import uv_sphere

CONFIGS = [
    ("base", ""),
    ("-closest", "closest"),
    ("-shadow", "shadow"),
    ("-spec", "spec"),
    ("-all", "closest,shadow,spec"),
]


def bvh_bench_scene():
    """The JAX tool's scene (walk_attrib.py:44-67): uv_sphere(80, 64) in gold
    metal over a grey plane, one sphere light, a gradient sky."""
    from ...scene import model as M

    verts, faces = uv_sphere(80, 64)
    return M.Scene(
        camera=M.Camera(position=M.Vec3(0, 1.5, 4.5), target=M.Vec3(0, 1, 0), fov=50.0),
        materials=[
            M.Material(id="grey", type="lambert", albedo=M.Color(0.6, 0.6, 0.65)),
            M.Material(id="gold", type="metal", albedo=M.Color(0.9, 0.7, 0.3), smoothness=0.6),
            M.Material(id="sun", type="emissive", emit=M.Color(1, 0.95, 0.8), power=40.0),
        ],
        objects=[
            M.Object(id="floor", type="plane", material_id="grey", position=M.Vec3(0, 0, 0)),
            M.Object(id="blob", type="mesh", material_id="gold",
                     mesh={"vertices": [list(v) for v in verts], "faces": [list(f) for f in faces]}),
            M.Object(id="lamp", type="sphere_light", material_id="sun", position=M.Vec3(3, 5, 2),
                     size=M.Vec3(0.8, 0.8, 0.8)),
        ],
        sky=M.Sky(type="gradient", horizon=M.Color(0.8, 0.85, 1.0), zenith=M.Color(0.3, 0.5, 0.9)),
    )


def shares(times: dict) -> dict:
    """Each configuration's best time and its gap to base's best, as a share of base's best."""
    base = min(times["base"])
    return {name: (min(ts), (base - min(ts)) / base) for name, ts in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("reps", nargs="?", type=int, default=2)
    ap.add_argument("--size", type=int, default=512, help="the frame's width and height (512)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)

    import path_trace_golang_tpu_torch as pt

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    sc = bvh_bench_scene()
    renderer = pt.Renderer(contract="gpu", seed=3, device=dev)
    cfg = pt.RenderConfig(args.size, args.size, 1, 8)

    times = {n: [] for n, _ in CONFIGS}
    means, segs = {}, {}
    # the knob is the process's environment: it must not outlive the tool, whatever raises
    try:
        for name, drop in CONFIGS:
            os.environ["PATHTRACER_BVH_DROP"] = drop
            t0 = time.perf_counter()
            renderer.render(sc, cfg)
            print(f"warm {name:9s} {time.perf_counter() - t0:6.2f}s", flush=True)
        for _ in range(args.reps):
            for name, drop in CONFIGS:
                os.environ["PATHTRACER_BVH_DROP"] = drop
                t0 = time.perf_counter()
                img = renderer.render(sc, cfg)
                times[name].append(time.perf_counter() - t0)
                means[name], segs[name] = float(img.mean()), renderer.stats.ray_segments
    finally:
        os.environ.pop("PATHTRACER_BVH_DROP", None)

    best = shares(times)
    print(f"\n{'config':10s} {'best':>8s} {'all reps':>30s} {'share of base':>14s}  img mean")
    rows = []
    for name, drop in CONFIGS:
        t, share = best[name]
        reps_s = " ".join(f"{x:.4f}" for x in times[name])
        print(f"{name:10s} {t:8.4f} {reps_s:>30s} {'' if name == 'base' else f'{share:13.1%}':>14s}  "
              f"{means[name]:.1f}")
        rows.append({"config": name, "drop": drop, "best_s": t, "reps_s": times[name],
                     "share_of_base": None if name == "base" else share, "img_mean": means[name],
                     "segments": segs[name]})
    return timing.finish("walk_attrib", dev, {"size": args.size, "reps": args.reps, "rows": rows}, args.out)


if __name__ == "__main__":
    sys.exit(main())
