"""Mesh scaling of the render path: Mrays/s at 10k, 40k and 100k triangles.

Counterpart of the JAX package's ``tools/perf/tri_scaling.py``.  For each
``bench_mesh(n_lat, n_lon)`` (2 n_lat n_lon triangles) at 512x512, 1 pass,
depth 8: the host's pack (the paged build), a first render, then the best
of 3 renders in one process.  A row reports the triangles, pages, the page
tiles' MiB, Mrays/s, the best and first render's seconds and the image's
mean; beside them the paged walk alone on the frame's primary rays
(pixel centres, closest hit), whose box tests grow with the page count:
every ray tests every page's boxes, 32 pages a window
(``csrc/paged_walk.cuh``), and on the card the f32 operations the walk
does for those rays (its counting build).

The JAX rows' ``p_pad``, ``window`` and ``gather_window`` describe the
TPU's one-hot page gather, which the port does not have (a thread loads its
page rows itself): they are left out.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.tri_scaling
       [--sizes 80x64,160x128,250x200] [--size 512] [--reps 3] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import timing

SIZES = [(80, 64), (160, 128), (250, 200)]  # 10,240, 40,960 and 100,000 triangles
NOTE = ("the JAX fields p_pad, window and gather_window describe the TPU's one-hot page gather, which the port "
        "does not have: left out")


def pixel_centre_rays(pack, w: int, h: int):
    """The frame's primary rays through pixel centres, one a pixel (no lens, no jitter)."""
    from ...ops.camera import camera_basis
    from ...ops.vec import V3

    b = camera_basis(pack.cam, w, h)
    idx = torch.arange(w * h, device=pack.device, dtype=torch.int64)
    u = ((idx % w).float() + 0.5) / float(max(w - 1, 1))
    v = (float(h - 1) - torch.div(idx, w, rounding_mode="floor").float() + 0.5) / float(max(h - 1, 1))
    d = V3(b[3] + u * b[6] + v * b[9] - b[0], b[4] + u * b[7] + v * b[10] - b[1],
           b[5] + u * b[8] + v * b[11] - b[2]).normalize()
    return V3.broadcast_scalars(u, b[0], b[1], b[2]), d


def size_row(n_lat: int, n_lon: int, size: int, reps: int, dev: torch.device) -> dict:
    import path_trace_golang_tpu_torch as pt
    from ...ops import cuda_trace
    from ...scene import builtin

    sc = builtin.bench_mesh(n_lat, n_lon)
    t0 = time.perf_counter()
    pack = pt.pack_scene(sc, size, size, device=dev)
    timing.sync(dev)
    pack_s = time.perf_counter() - t0
    r = pt.Renderer(contract="gpu", seed=3, device=dev)
    cfg = pt.RenderConfig(size, size, 1, 8)
    t0 = time.perf_counter()
    img = r.render(sc, cfg)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        img = r.render(sc, cfg)
        times.append(time.perf_counter() - t0)
    best = min(times)

    o, d = pixel_centre_rays(pack, size, size)
    far = torch.full_like(o.x, 1e20)
    walk_ms = timing.ms_per_launch(lambda: cuda_trace.paged_traverse(o, d, pack, 0.001, far), 5, dev)
    walk_ops = cuda_trace.paged_count_ops(o, d, pack, 0.001, best_t=far) if dev.type == "cuda" else None
    return dict(
        n_lat=n_lat, n_lon=n_lon, triangles=pack.n_triangles, pages=pack.paged.n_pages,
        tiles_mib=pack.page_tiles.numel() * 4 / (1 << 20), pack_s=pack_s, first_s=first_s, best_s=best,
        reps_s=times, mrays=r.stats.ray_segments / best / 1e6, segments=r.stats.ray_segments,
        img_mean=float(img.mean()), walk_ms=walk_ms, walk_rays=size * size, walk_ops=walk_ops,
        walk_ops_per_ray=None if walk_ops is None else walk_ops / (size * size),
    )


def parse_sizes(text: str):
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default=",".join(f"{a}x{b}" for a, b in SIZES), help="n_lat x n_lon, comma-separated")
    ap.add_argument("--size", type=int, default=512, help="the frame's width and height (512)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    print(f"note: {NOTE}", flush=True)
    rows = []
    for n_lat, n_lon in parse_sizes(args.sizes):
        row = size_row(n_lat, n_lon, args.size, args.reps, dev)
        rows.append(row)
        ops = "" if row["walk_ops"] is None else f", {row['walk_ops_per_ray']:.0f} f32 operations a ray"
        print(f"{row['triangles']:7d} triangles, {row['pages']:4d} pages ({row['tiles_mib']:.2f} MiB of tiles, "
              f"packed in {row['pack_s']:.2f} s): {row['mrays']:9.2f} Mrays/s, best {row['best_s']:.4f} s of "
              f"{[round(t, 4) for t in row['reps_s']]}, first {row['first_s']:.3f} s, image mean "
              f"{row['img_mean']:.1f}; the walk alone on {row['walk_rays']} primary rays {row['walk_ms']:.3f} ms"
              f"{ops}", flush=True)
    return timing.finish("tri_scaling", dev, {"size": args.size, "passes": 1, "depth": 8, "note": NOTE,
                                              "rows": rows}, args.out)


if __name__ == "__main__":
    sys.exit(main())
