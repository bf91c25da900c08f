"""Page-want statistics of the bench mesh's ray populations, recast for the warp sweep.

Counterpart of the JAX package's ``tools/perf/union_stats.py``, which
reports, per ray population, the pages a lane wants (k) against the unions
of a 128-lane row and of a block, the work of the TPU's rounds.  The port's
walk shares each page a warp visits out over the warp
(``csrc/paged_walk.cuh``), so this tool reports, for camera, cosine-bounce,
shadow and random rays (``page_stats.populations``) on the bench mesh at
10,240, 40,960 and 100,000 triangles (80, 320 and 782 pages):

* per ray, k: the pages it enters with best_t = inf (mean, p95, max; the
  JAX tool's ``k/lane`` columns);
* per 32-ray warp: the union of its rays' pages (mean, p95, max), the
  histogram of nw, the rays that want each visited page, and the lane-slot
  efficiency of the sweep's step 3 (the pairs the rays need over the lane
  slots the warp issues for them);
* on the card, the counting build's count of the closest-hit walk alone on
  the same rays, which must equal the warp model's visited pages, nw,
  lane slots, pairs and box tests exactly (the tool exits 1 otherwise).

The page masks come from the port's own page-entry test, on the card (the
CPU with ``--device cpu``, where there is no counting build to check).

Usage: python -m path_trace_golang_tpu_torch.tools.perf.union_stats
       [--sizes 80x64,160x128,250x200] [--rows 64] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys

from . import page_stats as ps
from . import timing


def population_row(name, o, d, t_max, pack, dev) -> dict:
    masks = ps.page_masks(o, d, pack.page_boxes, t_max)
    model = ps.warp_model(masks, pack.page_boxes.shape[1])
    row = {"population": name, "rays": int(o.x.numel()), "k": ps.k_stats(masks.sum(0).cpu().numpy()),
           "warp_union": ps.k_stats(model["union"]), "nw_hist": model["nw_hist"],
           "slot_efficiency": model["slot_efficiency"], "model": {k: model[k] for k in ps.CHECKED}}
    if dev.type == "cuda":
        row["counted_equal"], row["counted"] = ps.check_model(o, d, t_max, pack, model)
    return row


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
    rows, good = [], True
    pops = ps.populations(args.rows)
    for n_lat, n_lon in ps.parse_sizes(args.sizes):
        pack = ps.mesh_pack(n_lat, n_lon, dev)
        for name, o, d, t_max in pops:
            row = population_row(name, *ps.rays_on(o, d, t_max, dev), pack, dev)
            row.update(triangles=pack.n_triangles, pages=pack.paged.n_pages)
            rows.append(row)
            good = good and row.get("counted_equal", True)
            k, u = row["k"], row["warp_union"]
            check = "" if "counted" not in row else (
                f"; the counting build {'equal' if row['counted_equal'] else 'DIFFERS'}: {row['counted']}")
            print(f"{row['triangles']:7d} triangles {row['pages']:4d} pages {name:14s}: k/ray mean {k['mean']:6.2f} "
                  f"p95 {k['p95']:4.0f} max {k['max']:4d} | warp union mean {u['mean']:6.2f} p95 {u['p95']:4.0f} "
                  f"max {u['max']:4d} | lane-slot efficiency {row['slot_efficiency']:.2%} | nw 1..32 "
                  f"{row['nw_hist'][1:]}{check}", flush=True)
    rc = timing.finish("union_stats", dev, {"rows_per_population": args.rows, "rows": rows,
                                            "counted_equal": good if dev.type == "cuda" else None}, args.out)
    if not good:
        print("union_stats: FAIL: the counting build's sweep counts differ from the warp model", file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
