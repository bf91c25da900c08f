"""Wanted pages against needed pages: what near-to-far order with an exact stop could save the warp sweep.

Counterpart of the JAX package's ``tools/perf/want_stats.py``.  For each of
``page_stats``' ray populations on the bench mesh (80, 320 and 782 pages):

* k_all: the pages a ray enters with best_t = inf (every page the walk
  tests, the sweep's visits on a ray that hits nothing);
* k_perfect: the pages whose box entry t0 is at most the ray's true first
  hit (times 1 + 1e-4, the JAX tool's margin): the floor that near-to-far
  page order with an exact stop could reach with these boxes;

each per ray (mean, p95, max) and per 32-ray warp union (the pages the
warp's set would visit).  The true first hit is the port's own closest-hit
walk on the same rays (``ops/cuda_trace.py::paged_traverse``: the kernel on
the card, the plain version on the CPU), where the JAX tool intersects
every triangle in float64.

Left out: the JAX tool's sweep over ``PATHTRACER_BVH_SUBBOX`` and its
page-size what-if.  The port's build fixes 2 sub-boxes a page and 128 rows
a page (``ops/bvh.py``: ``N_SUB_BOXES``, ``PAGE_TRIS``; ``csrc/paged_walk.cuh``
reads 128-row tiles), so neither is a setting of the port.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.want_stats
       [--sizes 80x64,160x128,250x200] [--rows 64] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import page_stats as ps
from . import timing

EPS = 1e-4  # the JAX tool's margin on the true hit
NOTE = ("the JAX tool's PATHTRACER_BVH_SUBBOX sweep and page-size what-if are left out: the port's build fixes 2 "
        "sub-boxes and 128 rows a page")


def true_hit_t(o, d, pack):
    """The ray's first mesh hit by the port's closest-hit walk (inf where none)."""
    from ...ops import cuda_trace

    w = cuda_trace.paged_traverse(o, d, pack, ps.T_MIN, torch.full_like(o.x, ps.BIG_T))
    return torch.where(w.hit, w.t, float("inf"))


def population_row(name, o, d, t_max, pack) -> dict:
    masks = ps.page_masks(o, d, pack.page_boxes, t_max)
    t_hit = true_hit_t(o, d, pack)
    hit_rate = float(torch.isfinite(t_hit).float().mean())
    if t_max is not None:  # a shadow ray's walk ends at its far limit
        t_hit = torch.minimum(t_hit, t_max)
    perfect = masks & (ps.page_entry_t0(o, d, pack.page_boxes) <= (t_hit * (1 + EPS))[None, :])
    out = {"population": name, "rays": int(o.x.numel()), "hit_rate": hit_rate}
    for label, m in (("all", masks), ("perfect", perfect)):
        out[f"k_{label}"] = ps.k_stats(m.sum(0).cpu().numpy())
        out[f"warp_{label}"] = ps.k_stats(ps.warp_model(m)["union"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(f"{a}x{b}" for a, b in ps.SIZES),
                    help="the UV sphere's n_lat x n_lon, comma-separated")
    ap.add_argument("--rows", type=int, default=64, help="rows of 128 rays a population (64)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    print(f"note: {NOTE}", flush=True)
    rows = []
    pops = ps.populations(args.rows)
    for n_lat, n_lon in ps.parse_sizes(args.sizes):
        pack = ps.mesh_pack(n_lat, n_lon, dev)
        for name, o, d, t_max in pops:
            row = population_row(name, *ps.rays_on(o, d, t_max, dev), pack)
            row.update(triangles=pack.n_triangles, pages=pack.paged.n_pages)
            rows.append(row)
            a, p, wa, wp = row["k_all"], row["k_perfect"], row["warp_all"], row["warp_perfect"]
            print(f"{row['triangles']:7d} triangles {row['pages']:4d} pages {name:14s}: hit rate "
                  f"{row['hit_rate']:.3f} | per ray k_all mean {a['mean']:6.2f} p95 {a['p95']:4.0f} "
                  f"max {a['max']:4d}, "
                  f"k_perfect mean {p['mean']:6.2f} p95 {p['p95']:4.0f} max {p['max']:4d} | per warp union all mean "
                  f"{wa['mean']:6.2f} max {wa['max']:4d}, perfect mean {wp['mean']:6.2f} max {wp['max']:4d}", flush=True)
    return timing.finish("want_stats", dev, {"rows_per_population": args.rows, "eps": EPS, "note": NOTE,
                                             "rows": rows}, args.out)


if __name__ == "__main__":
    sys.exit(main())
