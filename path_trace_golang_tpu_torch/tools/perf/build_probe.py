"""Page partitions of the bench mesh scored by the warp sweep's work.

Counterpart of the JAX package's ``tools/perf/build_probe.py``: the same
10,240-triangle UV sphere cut into pages four ways (a numpy copy of the JAX
tool's partitions, the first being the port's own build):

  aligned-median   the shipped build (``ops/bvh.aligned_median_pages``)
  median           exact median splits, pages 50-100% full
  morton           Morton-order chunks of 128
  sah-aligned      median-split tree whose cut among the 128-aligned
                   candidates minimises the SAH, pages kept full

Each is laid out as the build lays out its pages (``ops/bvh.sort_pages``:
sorted along the axis of largest page-centre spread, 2 entry boxes a page)
and scored, on ``page_stats``' camera, bounce, shadow and random rays, by
the warp sweep's work (``page_stats.warp_model``): the pages a ray enters,
the pages a 32-ray warp visits and the lane slots a warp issues for their
(ray, row) pairs.  The JAX tool's cost model in TPU rounds (the one-hot
gather's matmul, the mask words' pops) describes the TPU's walk and is left
out.  The aligned-median partition must be ``ops/bvh.build_paged_bvh``'s
own pages (the tool exits 1 otherwise).

Usage: python -m path_trace_golang_tpu_torch.tools.perf.build_probe
       [n_lat n_lon] [--rows 64] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import bvh as B
from . import page_stats as ps
from . import timing
from .bvh_bench import uv_sphere

P = B.PAGE_TRIS


def build_median(cent, lo, hi):
    pages = []

    def emit(idxs):
        if len(idxs) <= P:
            pages.append(list(idxs))
            return
        c = cent[idxs]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idxs) // 2
        emit([idxs[i] for i in order[:half]])
        emit([idxs[i] for i in order[half:]])

    emit(list(range(len(cent))))
    return pages


def build_morton(cent, lo, hi):
    q = ((cent - cent.min(0)) / (np.ptp(cent, 0) + 1e-30) * 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = np.argsort(code, kind="stable")
    return [list(order[i:i + P]) for i in range(0, len(order), P)]


def build_sah_aligned(cent, lo, hi):
    def area(blo, bhi):
        d = np.maximum(bhi - blo, 0)
        return 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    pages = []

    def emit(idxs):
        n = len(idxs)
        if n <= P:
            pages.append(list(idxs))
            return
        best = None
        for axis in range(3):
            order = np.argsort(cent[idxs][:, axis], kind="stable")
            srt = [idxs[i] for i in order]
            slo = np.minimum.accumulate(lo[srt], 0)
            shi = np.maximum.accumulate(hi[srt], 0)
            rlo = np.minimum.accumulate(lo[srt][::-1], 0)[::-1]
            rhi = np.maximum.accumulate(hi[srt][::-1], 0)[::-1]
            for cut in range(P, n, P):
                sah = area(slo[cut - 1], shi[cut - 1]) * cut + area(rlo[cut], rhi[cut]) * (n - cut)
                if best is None or sah < best[0]:
                    best = (sah, srt[:cut], srt[cut:])
        emit(best[1])
        emit(best[2])

    emit(list(range(len(cent))))
    return pages


STRATEGIES = (
    ("aligned-median", lambda cent, lo, hi: B.aligned_median_pages(cent)),
    ("median", build_median),
    ("morton", build_morton),
    ("sah-aligned", build_sah_aligned),
)


def mesh(n_lat: int, n_lon: int):
    """(v0, e1, e2) f64[T, 3] of the UV sphere, as the JAX tool makes them."""
    verts, faces = uv_sphere(n_lat, n_lon)
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    v0 = v[f[:, 0]]
    return v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0


def layout(pages, lo, hi, cent):
    """(pages in the build's order, f32[P, 2, 6] entry boxes)."""
    pages, _axis, _margin, sub = B.sort_pages(pages, lo, hi, cent)
    return pages, np.asarray(sub, np.float64).reshape(len(pages), -1, 6).astype(np.float32)


def shipped_pages(v0, e1, e2):
    """``build_paged_bvh``'s pages as lists of triangle indices (-1 for a
    degenerate triangle, whose row the build zeroes), and its entry boxes."""
    t = len(v0)
    paged, tiles, bbox = B.build_paged_bvh(v0, e1, e2, np.zeros(t, np.int64), np.arange(t), np.zeros(t, bool), None)
    rows = [tiles[p, :int(bbox[p, 6])] for p in range(paged.n_pages)]
    pages = [[int(r[13]) if r[15] > 0.5 else -1 for r in rs] for rs in rows]
    return pages, B.page_boxes_table(paged)


def degenerate(e1, e2):
    """The triangles whose row the build zeroes (no plane: |e1 x e2|^2 <= 1e-30)."""
    n = np.cross(e1, e2)
    return np.einsum("ij,ij->i", n, n) <= 1e-30


def score(pages, boxes, pops, dev) -> dict:
    """The warp model's numbers of one partition on every population."""
    out = {}
    tb = torch.from_numpy(boxes).to(dev)
    for name, o, d, t_max in pops:
        ov, dv, tm = ps.rays_on(o, d, t_max, dev)
        m = ps.page_masks(ov, dv, tb, tm)
        model = ps.warp_model(m, boxes.shape[1])
        warps = model["sets"]
        out[name] = {"k_mean": float(m.sum(0).float().mean()), "warp_pages": model["pages_visited"] / warps,
                     "warp_slots": model["lane_slots"] / warps, "slot_efficiency": model["slot_efficiency"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_lat", nargs="?", type=int, default=80)
    ap.add_argument("n_lon", nargs="?", type=int, default=64)
    ap.add_argument("--rows", type=int, default=64, help="rows of 128 rays a population (64)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    v0, e1, e2 = mesh(args.n_lat, args.n_lon)
    lo, hi, cent = B.tri_bounds(v0, e1, e2)
    pops = ps.populations(args.rows)
    ship_pages, ship_boxes = shipped_pages(v0, e1, e2)
    rows, same = [], None
    for name, build in STRATEGIES:
        pages, boxes = layout(build(cent, lo, hi), lo, hi, cent)
        if name == "aligned-median":
            dead = degenerate(e1, e2)
            same = [[-1 if dead[i] else int(i) for i in m] for m in pages] == ship_pages and np.array_equal(
                boxes, ship_boxes)
        row = {"partition": name, "pages": len(pages), "fill": float(np.mean([len(m) for m in pages]) / P),
               "scores": score(pages, boxes, pops, dev)}
        rows.append(row)
        cells = " | ".join(f"{pop} k {s['k_mean']:5.2f} warp pages {s['warp_pages']:6.2f} slots {s['warp_slots']:8.1f}"
                           for pop, s in row["scores"].items())
        print(f"{name:15s} P={row['pages']:4d} fill={row['fill']:4.2f} | {cells}", flush=True)
    print(f"aligned-median is build_paged_bvh's partition: {same}", flush=True)
    rc = timing.finish("build_probe", dev, {"n_lat": args.n_lat, "n_lon": args.n_lon, "rows_per_population": args.rows,
                                            "aligned_median_is_shipped": same, "rows": rows}, args.out)
    if not same:
        print("build_probe: FAIL: the aligned-median partition is not build_paged_bvh's", file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
