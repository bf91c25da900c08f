"""Where does the paged sweep's time go?  Perf probe T2.

Counterpart of the JAX package's ``tools/perf/paged_probe.py``: traversal-
only launches (``ops/probes.py::paged_probe``) over the paged table of a
10,240-triangle sphere (80 pages), on incoherent and coherent rays, in five
variants, and the split of the walk's time that their differences give:

* ``fetch``  - one tile element a page: the load floor;
* ``all``    - every page swept by every ray, no entry test;
* ``dense``  - the TPU kernel's block cursor, here a warp's: the union of
               its 32 rays' wanted pages, each swept by all 32;
* ``gather`` - the per-ray walk of kernel B2, keys only;
* ``real``   - kernel B2 as the kernels run it (the warp-cooperative walk),
               with the winner's exact t and the merge (the bits of the
               merged distance); beside ``gather``, the A/B of the two walks.

``all``, ``dense`` and ``gather`` give the same keys, bit for bit.  Times
are per launch of ``REPS`` chained traversals of all rays, and per ray and
traversal.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.paged_probe
       [n_lat n_lon] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ...ops import bvh as B
from ...ops import probes
from ...scene import model as M
from ...soa import pack_scene
from . import timing
from .bvh_bench import uv_sphere

ROWS = 32
N_BLOCKS = 16
LANE = 128
REPS = 16
KINDS = ("incoherent", "coherent")


def probe_scene(n_lat: int = 80, n_lon: int = 64) -> M.Scene:
    """The probe's sphere mesh as a lambert object of a scene: the pack that
    the ``real`` variant walks (``pack_scene(probe_scene(), 512, 512)``)."""
    verts, faces = uv_sphere(n_lat, n_lon)
    return M.Scene(
        camera=M.Camera(position=M.Vec3(0, 1.5, 4.5), target=M.Vec3(0, 1, 0)),
        materials=[M.Material(id="g", type="lambert", albedo=M.Color(0.6, 0.6, 0.65))],
        objects=[M.Object(id="b", type="mesh", material_id="g",
                          mesh={"vertices": [list(v) for v in verts], "faces": [list(f) for f in faces]})],
    )


def build_table(n_lat: int = 80, n_lon: int = 64, device="cuda"):
    """The probe's paged table, as the JAX probe builds it: returns (paged,
    tiles f32[P,128,32], boxes f32[P,k,6], real_boxes).  ``real_boxes`` are
    the boxes of the scene pack that the ``real`` variant walks (the mesh
    as a lambert object of a scene at 512x512), over the same tiles."""
    verts, faces = uv_sphere(n_lat, n_lon)
    pack = pack_scene(probe_scene(n_lat, n_lon), 512, 512, device=device)
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    v0 = v[f[:, 0]]
    t = len(f)
    paged, tiles, _bbox = B.build_paged_bvh(
        v0, v[f[:, 1]] - v0, v[f[:, 2]] - v0, np.zeros(t, np.int64), np.arange(t), np.zeros(t, bool), None
    )
    dev = torch.device(device)
    boxes = torch.from_numpy(B.page_boxes_table(paged)).to(dev)
    return paged, torch.from_numpy(tiles).to(dev), boxes, pack.page_boxes.contiguous()


def packets(kind: str, seed: int = 11, device="cuda") -> torch.Tensor:
    """The JAX probe's rays, bit for bit, as f32[6, N] (origin, direction)
    with N = ROWS * N_BLOCKS * LANE in row-major order.  Made with numpy on
    the host, whose float32 square root is correctly rounded (PyTorch's on
    the CPU is not always), then moved to ``device``."""
    shape = (ROWS * N_BLOCKS, LANE)
    r = np.random.RandomState(seed)
    f32 = np.float32
    if kind == "incoherent":
        o = [r.uniform(-3, 3, shape).astype(f32) for _ in range(3)]
        d = [r.uniform(-1, 1, shape).astype(f32) for _ in range(3)]
    else:
        # camera-ish: common origin, directions in a narrow cone at the mesh
        o = [np.full(shape, v, f32) for v in (0.0, 1.5, 4.5)]
        jit = np.linspace(-0.15, 0.15, shape[0] * LANE, dtype=f32).reshape(shape)
        d = [jit, jit * f32(0.5) - f32(0.1), -np.ones(shape, f32)]
    # V3.normalize of the JAX package: 1 / sqrt(max(d.d, 1e-20)), then a product each
    inv = f32(1.0) / np.sqrt(np.maximum(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], f32(1e-20)))
    rays = np.stack([c.reshape(-1) for c in o + [c * inv for c in d]])
    return torch.from_numpy(rays).to(device).contiguous()


def run(device: str = "cuda", n_lat: int = 80, n_lon: int = 64, reps: int = REPS, n_rep: int = 5) -> dict:
    """Time every variant on both packets; print the JAX probe's lines and
    the split.  Returns {(kind, variant): {"ms", "ns_per_ray", "improved"}}
    (``improved``: rays whose key is not the largest, as the JAX probe
    counts them)."""
    dev = timing.resolve(device)
    paged, tiles, boxes, real_boxes = build_table(n_lat, n_lon, dev)
    n = ROWS * N_BLOCKS * LANE
    print(f"device: {timing.describe(dev)}")
    print(f"pages: {paged.n_pages}, lanes {n}, {reps} traversals a launch")
    results = {}
    for kind in KINDS:
        rays = packets(kind, device=dev)
        for variant in probes.PAGED_VARIANTS:
            bx = real_boxes if variant == "real" else boxes
            box = [None]

            def call():
                box[0] = probes.paged_probe(variant, tiles, bx, rays, reps)

            ms = timing.ms_per_launch(call, n_rep, dev)
            out = box[0]
            ns = ms * 1e6 / (n * reps)
            hits = int((out != out.max()).sum())
            results[(kind, variant)] = {"ms": ms, "ns_per_ray": ns, "improved": hits}
            print(f"{kind:10s} {variant:6s}: {ms:8.3f} ms/launch ({ns:7.3f} ns/ray/traversal)  improved-lanes {hits}")
    for kind in KINDS:
        ns = {v: results[(kind, v)]["ns_per_ray"] for v in probes.PAGED_VARIANTS}
        print(
            f"\n{kind}: cursor+carry overhead (dense - all) = {ns['dense'] - ns['all']:.3f} ns/ray "
            f"({(ns['dense'] - ns['all']) / ns['dense']:.0%} of dense); fetch floor = {ns['fetch']:.3f} ns/ray; "
            f"sweep arithmetic (all - fetch) = {ns['all'] - ns['fetch']:.3f} ns/ray; divergence (gather - dense) "
            f"= {ns['gather'] - ns['dense']:.3f} ns/ray; merge (real - gather) = {ns['real'] - ns['gather']:.3f} "
            f"ns/ray"
        )
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mesh", nargs="*", type=int, help="n_lat n_lon (default 80 64)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    n_lat, n_lon = (a.mesh + [80, 64][len(a.mesh):])[:2]
    cpu = torch.device(a.device).type == "cpu"
    run(a.device, n_lat, n_lon, 1 if cpu else REPS, 1 if cpu else 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
