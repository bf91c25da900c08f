"""Page-want statistics of the paged walk, recast for the port's warp sweep.

Shared by ``union_stats``, ``want_stats`` and ``build_probe``.  The JAX
package's tools (``tools/perf/union_stats.py``, ``want_stats.py``,
``build_probe.py``) measure what the TPU's walk pays: rounds of 128 lanes,
each as long as its busiest lane's page count.  The port's walk
(``csrc/paged_walk.cuh``) is a warp-cooperative sweep: the 32 lanes of a
warp that call it together visit the union of their rays' pages in
ascending order, and each visited page's (ray, row) pairs are shared out
over the warp, ``s = width // nw`` lanes to each of the ``nw`` rays that
want it, ``ceil(128 / s)`` rounds of the row loop.  So what a warp pays is
its union's pages and the lane slots of those rounds, against the
``128 nw`` pairs its rays need.  :func:`warp_model` computes that from the
rays' page masks alone; the counting build counts the same on the card
(``ops/cuda_trace.py::paged_count_split``), and :func:`check_model` holds
the two equal.

The mesh is the bench scene's UV sphere (``scene.builtin.bench_mesh``: 80 x
64 = 10,240 triangles, 80 pages; tri_scaling's 160 x 128 and 250 x 200,
320 and 782 pages), packed as a render packs it.  The ray populations are
the JAX ``union_stats.py``'s, made with its arithmetic from
``RandomState(3)``: camera rows crossing the blob, cosine bounce rays from
the sphere's surface, shadow rays from there to the lamp at (3, 5, 2), and
random rays; the shadow rays stop at the lamp's centre (``t_max``), as
the JAX ``build_probe.py``'s do.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import bvh as bvh_mod
from ...ops.vec import V3

ROW = 128  # lanes of a JAX row: the populations are rows of 128 rays
WARP = 32  # rays of a warp of the walk alone (one thread a ray)
SIZES = [(80, 64), (160, 128), (250, 200)]  # 10,240, 40,960 and 100,000 triangles
BIG_T = 3e38  # the walk's "no hit yet" distance: every page the ray's path enters is wanted
T_MIN = 1e-3
LAMP = (3.0, 5.0, 2.0)


def mesh_pack(n_lat: int, n_lon: int, dev: torch.device):
    """The bench scene's pack at ``n_lat`` x ``n_lon`` (its pages are the
    UV sphere's alone: the plane and the lamp are objects)."""
    import path_trace_golang_tpu_torch as pt
    from ...scene import builtin

    return pt.pack_scene(builtin.bench_mesh(n_lat, n_lon), 64, 64, device=dev)


def populations(n_rows: int = 64, seed: int = 3):
    """The four populations of ``n_rows`` x 128 rays, flat and row-major:
    [(name, o f32[N, 3], d f32[N, 3], t_max f32[N] or None)]."""
    w = h = 512
    r = np.random.RandomState(seed)
    idx = np.arange(n_rows * ROW)
    px = (idx % w).reshape(n_rows, ROW)
    py = (idx // w + 180).reshape(n_rows, ROW)  # rows crossing the blob
    u = px / (w - 1)
    vv = ((h - 1) - py) / (h - 1)
    pos = np.array([0, 1.5, 4.5])
    tgt = np.array([0, 1, 0])
    fwd = (tgt - pos) / np.linalg.norm(tgt - pos)
    right = np.cross(fwd, [0, 1, 0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    half = np.tan(np.radians(50) / 2)
    dirs = (fwd[None, None] + right[None, None] * ((u * 2 - 1) * half)[..., None]
            + up[None, None] * ((vv * 2 - 1) * half)[..., None])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cam_o = np.broadcast_to(pos, dirs.shape).astype(np.float32)

    theta = r.uniform(0, np.pi, (n_rows, ROW))
    phi = r.uniform(0, 2 * np.pi, (n_rows, ROW))
    n = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)], -1)
    surf = np.array([0, 1, 0]) + n  # the unit sphere at (0, 1, 0)
    u1, u2 = r.uniform(size=(2, n_rows, ROW))
    rr = np.sqrt(u1)
    ang = 2 * np.pi * u2
    tang = np.cross(n, [0.13, 0.87, 0.48])
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    bitan = np.cross(n, tang)
    bd = (tang * (rr * np.cos(ang))[..., None] + bitan * (rr * np.sin(ang))[..., None]
          + n * np.sqrt(1 - u1)[..., None])
    bd /= np.linalg.norm(bd, axis=-1, keepdims=True)
    bo = (surf + 1e-3 * n).astype(np.float32)

    sd = np.array(LAMP)[None, None] - surf
    sdist = np.linalg.norm(sd, axis=-1, keepdims=True)
    sd /= sdist

    ro = np.stack([r.uniform(-3, 3, (n_rows, ROW)).astype(np.float32) for _ in range(3)], -1)
    rd = np.stack([r.uniform(-1, 1, (n_rows, ROW)).astype(np.float32) for _ in range(3)], -1)
    rd = rd * (np.float32(1.0) / np.sqrt(np.maximum((rd * rd).sum(-1, keepdims=True, dtype=np.float32),
                                                    np.float32(1e-20))))
    flat = lambda a: np.ascontiguousarray(a.reshape(-1, *a.shape[2:]), dtype=np.float32)  # noqa: E731
    return [
        ("camera", flat(cam_o), flat(dirs), None),
        ("bounce-cosine", flat(bo), flat(bd), None),
        ("shadow", flat(bo), flat(sd), flat(sdist[..., 0])),
        ("random", flat(ro), flat(rd), None),
    ]


def rays_on(o, d, t_max, dev):
    """A population's rays as V3 lanes (and t_max) on ``dev``."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (V3(to(o[:, 0]), to(o[:, 1]), to(o[:, 2])), V3(to(d[:, 0]), to(d[:, 1]), to(d[:, 2])),
            None if t_max is None else to(t_max))


def page_masks(o: V3, d: V3, boxes, t_max=None, best_t=BIG_T):
    """bool[P, N]: the pages each ray enters before ``best_t`` (and not after
    ``t_max``), by the port's own page-entry test (``ops/bvh.py``, the
    walk's step 1 bit for bit)."""
    inv = (1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    best = torch.full_like(o.x, best_t)
    return bvh_mod._page_wants((o.x, o.y, o.z), inv, boxes, T_MIN, best, t_max, None)


def page_entry_t0(o: V3, d: V3, boxes):
    """f32[P, N]: the least slab entry t0 over the page's boxes that the ray
    enters (the same test as :func:`page_masks` with no far limits), +inf
    where it enters none."""
    inv = (1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    out = []
    for p0 in range(0, boxes.shape[0], 16):
        b = boxes[p0:p0 + 16, :, :, None]
        t1x, t2x = (b[:, :, 0] - o.x) * inv[0], (b[:, :, 3] - o.x) * inv[0]
        t1y, t2y = (b[:, :, 1] - o.y) * inv[1], (b[:, :, 4] - o.y) * inv[1]
        t1z, t2z = (b[:, :, 2] - o.z) * inv[2], (b[:, :, 5] - o.z) * inv[2]
        t0 = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z))
        t1 = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z))
        w = (t1 >= t0) & (t1 >= T_MIN) & (t0 < BIG_T)
        out.append(torch.where(w, t0, float("inf")).amin(dim=1))
    return torch.cat(out)


def parse_sizes(text: str):
    """``n_lat x n_lon`` pairs, comma-separated."""
    return [tuple(int(x) for x in s.split("x")) for s in text.split(",") if s]


def k_stats(k) -> dict:
    """Mean, p95 and max: the JAX union_stats' ``k/lane`` columns (pages a
    ray enters), and the same of a warp's union."""
    k = np.asarray(k)
    return {"mean": float(k.mean()), "p95": float(np.percentile(k, 95)), "max": int(k.max())}


def warp_model(masks, n_sub: int = bvh_mod.N_SUB_BOXES) -> dict:
    """What the warp sweep does on these masks (bool[P, N], rays in warps of
    32 consecutive ones, the last possibly short): per warp the union of its
    rays' pages (``union``), and summed over warps the counting build's
    counts: ``sets``, ``pages_visited``, ``want_sum`` (the rays that want
    each visited page), ``lane_slots`` (``ceil(128 / s)`` rounds of the
    warp's lanes a page, ``s = width // nw``), ``pairs`` (``128 nw``) and
    ``box_tests`` (every ray tests every page's boxes); the histogram of nw
    over visited pages (``nw_hist[nw]``) and the slots' efficiency
    (``pairs / lane_slots``)."""
    m = masks.to(torch.int64)
    n_pages, n = m.shape
    n_warps = -(-n // WARP)
    pad = n_warps * WARP - n
    nw = torch.nn.functional.pad(m, (0, pad)).reshape(n_pages, n_warps, WARP).sum(-1)  # [P, warps]
    width = torch.full((n_warps,), WARP, dtype=torch.int64, device=m.device)
    width[-1] = WARP - pad
    visited = nw > 0
    s = torch.div(width[None, :], nw.clamp_min(1), rounding_mode="floor")
    rounds = torch.div(bvh_mod.PAGE_TRIS + s - 1, s, rounding_mode="floor")
    slots = torch.where(visited, rounds * width[None, :], 0)
    hist = torch.bincount(nw[visited], minlength=WARP + 1)
    union = visited.sum(0)
    out = {
        "sets": n_warps,
        "pages_visited": int(visited.sum()),
        "want_sum": int(nw.sum()),
        "lane_slots": int(slots.sum()),
        "pairs": int(nw.sum()) * bvh_mod.PAGE_TRIS,
        "box_tests": n * n_pages * n_sub,
    }
    out["slot_efficiency"] = out["pairs"] / max(out["lane_slots"], 1)
    out["union"] = union.cpu().numpy()
    out["nw_hist"] = hist.cpu().numpy().tolist()
    return out


# the counts that the counting build and the model must give alike (closest hit)
CHECKED = ("sets", "pages_visited", "want_sum", "lane_slots", "pairs", "box_tests")


def check_model(o: V3, d: V3, t_max, pack, model: dict):
    """The counting build's sweep counts for the closest-hit walk alone on
    these rays (best_t = 3e38, the masks' own) against the model's: (equal,
    the build's counts).  Only on the card."""
    from ...ops import cuda_trace

    counted = cuda_trace.paged_count_split(o, d, pack, T_MIN, best_t=torch.full_like(o.x, BIG_T), t_max=t_max)
    return all(counted[k] == model[k] for k in CHECKED), counted
