"""Where the mesh renderer's time goes, shape by shape.

Counterpart of the JAX package's ``tools/perf/mesh_attrib.py``.  For every
mesh shape, in one world spawned by ``parallel/launch.run_world`` (gloo,
the ranks sharing one card; ``--across-cards`` NCCL, one card a rank):

* ``wall``        the fixed workload's render on the mesh (the mean of
                  ``--reps`` (3) after a first render, the slowest rank's);
* ``shard_wall``  one rank, alone on a 1x1 mesh, rendering one shard's
                  workload as the JAX tool defines it (h // n_px rows,
                  spp // n_spp passes);
* ``tiny_wall``   the same mesh on 8x8, 1 pass, depth 2: its fixed cost;
* ``serialized_model`` = n_dev * shard_wall + tiny_wall: the wall if the
                  ranks' work ran one after another (on one card, what the
                  JAX tool assumed of its one-core host; across cards the
                  bound that concurrency beats);
* ``band_walls``  each px band's own work (its lanes and pass windows,
                  without collectives) timed by one rank alone, and
                  ``band_imbalance`` = wall / the largest of them: how far
                  the slowest band, which every rank waits for at the
                  gather, sets the wall.

The scene resolves by name (``--scene``, default the reference's
gpu_showcase) through ``scene.builtin.find_scene``, else a builtin of that
name, else demo_showcase; the tool prints which.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.mesh_attrib [width height spp]
       [--depth 8] [--scene NAME] [--shapes 1x1,8x1,4x2,1x8] [--across-cards] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import mesh_ranks, timing
from .mesh_scaling import parse_shapes, world_of


def default_shapes(n: int):
    """The JAX tool's shapes for n devices: 1x1, n x 1, n/2 x 2, 1 x n (n = 8 there)."""
    out = []
    for s in ((1, 1), (n, 1), (max(1, n // 2), 2), (1, n)):
        if s not in out and s[0] * s[1] <= n:
            out.append(s)
    return out


def model(n_dev: int, shard_wall: float, tiny_wall: float) -> float:
    """The serialized model: every rank's shard one after another, plus the shape's fixed cost."""
    return n_dev * shard_wall + tiny_wall


def run(width=64, height=36, spp=4, depth=8, scene="gpu_showcase", shapes=None, device="cuda",
        across_cards=False, reps=3) -> dict:
    from ...parallel.launch import run_world

    dev = timing.resolve(device)
    sc, label = timing.scene_named(scene, "demo_showcase")
    if shapes is None:
        shapes = default_shapes(torch.cuda.device_count() if across_cards else 8)
    world, backend, shapes = world_of(shapes, dev, across_cards)
    t0 = time.perf_counter()
    per_rank = run_world(mesh_ranks.attrib_rank, world, (sc, (width, height, spp, depth), shapes, dev.type, reps),
                         backend=backend, timeout=3000)
    world_s = time.perf_counter() - t0
    rows = []
    for shape in shapes:
        recs = [r for rank in per_rank for r in rank["records"] if tuple(r["shape"]) == tuple(shape)]
        one = next(r for r in recs if "shard_wall" in r)
        wall = max(r["wall"] for r in recs if "wall" in r)
        tiny = max(r["tiny_wall"] for r in recs if "tiny_wall" in r)
        n_dev = shape[0] * shape[1]
        rows.append(dict(mesh=f"{shape[0]}x{shape[1]}", devices=n_dev, wall=wall, shard_wall=one["shard_wall"],
                         serialized_model=model(n_dev, one["shard_wall"], tiny), tiny_wall=tiny,
                         band_walls=one["band_walls"], band_imbalance=wall / max(one["band_walls"]),
                         img_mean=next(r["img_mean"] for r in recs if "img_mean" in r)))
    return {"scene": label, "world": world, "backend": backend, "world_s": world_s, "rows": rows,
            "plain_calls": sum(rank["plain_calls"] for rank in per_rank)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="width height spp (64 36 4)")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--scene", default="gpu_showcase")
    ap.add_argument("--shapes", default=None, help="n_px x n_spp, comma-separated (the JAX tool's four)")
    ap.add_argument("--across-cards", action="store_true", help="one card a rank over NCCL")
    ap.add_argument("--reps", type=int, default=3, help="timed renders a measurement, after a first one (3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)
    w, h, spp = (args.sizes + [64, 36, 4][len(args.sizes):])[:3]

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    res = run(w, h, spp, args.depth, args.scene, parse_shapes(args.shapes) if args.shapes else None, args.device,
              args.across_cards, args.reps)
    print(f"scene {res['scene']} {w}x{h} spp {spp} d{args.depth}: a world of {res['world']} over "
          f"{res['backend']} in {res['world_s']:.1f} s (spawn and start-up included)", flush=True)
    for r in res["rows"]:
        n = r["devices"]
        print(f"mesh {r['mesh']}: wall {r['wall']:7.4f}s | 1-dev shard {r['shard_wall']:7.4f}s "
              f"(x{n} = {n * r['shard_wall']:7.4f}) | tiny {r['tiny_wall']:7.4f}s | serialized model "
              f"{r['serialized_model']:7.4f}s | px bands {[round(b, 4) for b in r['band_walls']]}, wall / slowest "
              f"band {r['band_imbalance']:.3f}", flush=True)
    return timing.finish("mesh_attrib", dev, {
        "scene": res["scene"], "width": w, "height": h, "spp": spp, "depth": args.depth, "world": res["world"],
        "backend": res["backend"], "world_s": res["world_s"], "rows": res["rows"]}, args.out,
        plain=res["plain_calls"])


if __name__ == "__main__":
    sys.exit(main())
