"""Scaling of the ("px", "spp") mesh renderer on one card and across cards.

Counterpart of the JAX package's ``tools/perf/mesh_scaling.py``, which
timed ``parallel.MeshRenderer`` on virtual CPU devices.  Here the shapes
1x1, 2x1, 4x1, 8x1, 4x2, 2x4 and 1x8 render one fixed workload (the same
pixels and passes: a rank's share shrinks as ranks grow) in one world of
the largest size, spawned by ``parallel/launch.run_world``:

* on one card the ranks share it over gloo, so the table measures what
  the mesh adds (its dispatches, collectives and host work) on top of one
  card's kernels, not a speed-up;
* with ``--across-cards`` the shapes that fit the machine's cards run over
  NCCL, one card a rank.

A row: the seconds a render (the mean of ``--reps`` (3) after a first render, the
slowest rank's), the 1x1 shape's seconds over it (``vs_1dev``), the first
render's seconds (in place of the JAX tool's compile_s) and the image's
mean.  The scene resolves by name (``--scene``, default the reference's
example_simple) through ``scene.builtin.find_scene``, else a builtin of
that name, else demo_cornell; the tool prints which.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.mesh_scaling [width height spp]
       [--depth 8] [--scene NAME] [--shapes 1x1,2x1,...] [--across-cards] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import mesh_ranks, timing

SHAPES = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (2, 4), (1, 8)]


def parse_shapes(text: str):
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",") if s]


def world_of(shapes, dev: torch.device, across_cards: bool):
    """(world size, backend, the shapes that fit): across cards the machine's cards over NCCL, else the
    largest shape over gloo (the ranks sharing one card, or the CPU)."""
    if across_cards:
        if dev.type != "cuda":
            raise ValueError("--across-cards needs the cards (--device cuda)")
        n = torch.cuda.device_count()
        return n, "nccl", [s for s in shapes if s[0] * s[1] <= n]
    return max(p * s for p, s in shapes), "gloo", list(shapes)


def run(width=128, height=72, spp=8, depth=8, scene="example_simple", shapes=SHAPES, device="cuda",
        across_cards=False, reps=3, keep_accum=False) -> dict:
    """Render every shape in one world; returns the rows (with the lead rank's image, and its final
    accumulator where ``keep_accum``), the scene's label, the world and the ranks' plain calls."""
    from ...parallel.launch import run_world

    dev = timing.resolve(device)
    sc, label = timing.scene_named(scene, "demo_cornell")
    world, backend, shapes = world_of(shapes, dev, across_cards)
    t0 = time.perf_counter()
    per_rank = run_world(mesh_ranks.scaling_rank, world,
                         (sc, (width, height, spp, depth), shapes, dev.type, reps, keep_accum),
                         backend=backend, timeout=3000)
    world_s = time.perf_counter() - t0
    rows = []
    for shape in shapes:
        recs = [r for rank in per_rank for r in rank["records"] if tuple(r["shape"]) == tuple(shape)]
        lead = next(r for r in recs if r["img"] is not None)
        secs = max(r["secs"] for r in recs)
        rows.append(dict(mesh=f"{shape[0]}x{shape[1]}", devices=shape[0] * shape[1], secs=secs,
                         vs_1dev=None, first_s=max(r["first_s"] for r in recs), img_mean=lead["img_mean"],
                         segments=lead["segments"], passes=lead["passes"], nonfinite=lead["nonfinite"],
                         img=lead["img"], accum=lead["accum"]))
    for row in rows:
        row["vs_1dev"] = rows[0]["secs"] / row["secs"]
    return {"scene": label, "world": world, "backend": backend, "world_s": world_s, "rows": rows,
            "plain_calls": sum(rank["plain_calls"] for rank in per_rank)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="width height spp (128 72 8)")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--scene", default="example_simple")
    ap.add_argument("--shapes", default=",".join(f"{p}x{s}" for p, s in SHAPES))
    ap.add_argument("--across-cards", action="store_true", help="one card a rank over NCCL")
    ap.add_argument("--reps", type=int, default=3, help="timed renders a measurement, after a first one (3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)
    w, h, spp = (args.sizes + [128, 72, 8][len(args.sizes):])[:3]

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    res = run(w, h, spp, args.depth, args.scene, parse_shapes(args.shapes), args.device, args.across_cards,
              args.reps)
    print(f"scene {res['scene']} {w}x{h} spp {spp} d{args.depth}: a world of {res['world']} over "
          f"{res['backend']} in {res['world_s']:.1f} s (spawn and start-up included)", flush=True)
    for r in res["rows"]:
        print(f"mesh {r['mesh']} ({r['devices']} dev): {r['secs']:8.4f}s/render (x{r['vs_1dev']:4.2f} vs 1-dev), "
              f"first {r['first_s']:6.2f}s, img mean {r['img_mean']:6.2f}", flush=True)
    rows = [{k: v for k, v in r.items() if k not in ("img", "accum")} for r in res["rows"]]
    return timing.finish("mesh_scaling", dev, {
        "scene": res["scene"], "width": w, "height": h, "spp": spp, "depth": args.depth, "world": res["world"],
        "backend": res["backend"], "world_s": res["world_s"], "worst_secs": max(r["secs"] for r in rows),
        "rows": rows}, args.out, plain=res["plain_calls"])


if __name__ == "__main__":
    sys.exit(main())
