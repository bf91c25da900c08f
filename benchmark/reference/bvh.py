"""Triangle meshes behind a BVH: the host builds and the two walks.

Torch counterpart of ``path_trace_golang_tpu/ops/bvh.py``:

* **Host build** (:func:`build_bvh`): a median-split BVH over triangle
  centroids (NumPy), flattened in DFS order with escape links, so that
  ``miss[i] == i + subtree_size(i)``.
* **Lockstep walk** (:func:`traverse_triangles`): every node's slab test
  and every leaf's Moller-Trumbore test run for all lanes in DFS order,
  lanes that miss an internal node skipping its subtree.  Meshes up to
  ``STATIC_TRI_MAX`` triangles take this walk.
* **Paged build** (:func:`build_paged_bvh`): larger meshes are cut into
  pages of at most ``PAGE_TRIS`` triangles, each triangle stored in plane
  form (unit normal, plane offset, the two barycentric duals) in a
  f32[P, 128, 32] tile table, each page bounded by ``N_SUB_BOXES`` boxes.
* **Paged walk** (:func:`traverse_triangles_paged`,
  :func:`occluded_triangles_paged`): a lane slab-tests every page's boxes
  against the distance it came in with, and tests all 128 rows of each
  page it enters, in ascending page order.  The page loop carries one
  winner key per lane: the f32 bits of the hit distance with the low 7
  bits replaced by the row's slot, so the least key is the closest hit
  and ties inside one 2^-16 bucket go to the lower slot.  The winner's
  exact distance and normal are recomputed from its row afterwards.

  This is the contract of the JAX package's per-lane walk
  (``_traverse_gather`` / ``_occluded_gather``): a lane tests only the
  pages its own ray enters.  The JAX dense sweep
  (``traverse_triangles_paged`` there) lets every lane test every page
  that any lane entered; the two agree unless a ray hits a triangle
  outside its page's float32-rounded boxes.  What is not carried over is
  how the TPU loads a lane's page (``build_gather_table`` and the one-hot
  matrix product of ``_gather_sel``), its near-to-far buckets and its
  early stop: here a lane indexes its page directly, and the CUDA kernel
  ``csrc/paged_walk.cuh`` does the same with one thread per lane.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .vec import V3

__all__ = [
    "BvhTopology",
    "PagedBvh",
    "PagedHit",
    "build_bvh",
    "build_paged_bvh",
    "page_boxes_table",
    "traverse_triangles",
    "traverse_triangles_paged",
    "occluded_triangles_paged",
    "use_dynamic_walk",
    "PAGE_TRIS",
    "MASK_BITS",
    "N_PAGE_ATTRS",
    "N_SUB_BOXES",
    "tri_normal",
    "OBJ_TRIANGLE",
    "LEAF_SIZE",
    "STATIC_TRI_MAX",
]

OBJ_TRIANGLE = 3  # extends the reference's OBJ_* codes (gpu.go:435-437)
LEAF_SIZE = 4
STATIC_TRI_MAX = 128
_f = np.float32


def use_dynamic_walk(n_triangles: int) -> bool:
    """Whether a mesh of this size takes the paged walk."""
    return n_triangles > STATIC_TRI_MAX


@dataclasses.dataclass(frozen=True)
class BvhTopology:
    """Static tree structure: per node (miss, first, count); ``count == 0``
    marks an internal node, leaves own ``tris[first:first+count]`` in BVH
    order; ``order`` maps BVH order to the original triangle index."""

    miss: Tuple[int, ...]
    first: Tuple[int, ...]
    count: Tuple[int, ...]
    order: Tuple[int, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.miss)


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Median-split BVH build (host NumPy), identical to the JAX package's.

    v0/e1/e2: f64[T,3] triangle origin and edge vectors.
    Returns (topology: BvhTopology, bounds: f32[B, 6]).
    """
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    centroid = (lo + hi) * 0.5

    nodes = []  # [lo3, hi3, first, count] with count=0 for internal
    leaf_members: list = []

    def emit(idxs):
        my = len(nodes)
        nodes.append([lo[idxs].min(axis=0), hi[idxs].max(axis=0), 0, 0])
        if len(idxs) <= LEAF_SIZE:
            nodes[my][2] = -1
            nodes[my][3] = len(idxs)
            leaf_members.append((my, list(idxs)))
            return
        c = centroid[idxs]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idxs) // 2
        emit([idxs[i] for i in order[:half]])
        emit([idxs[i] for i in order[half:]])

    emit(list(range(v0.shape[0])))

    order = []
    for node_i, members in leaf_members:
        nodes[node_i][2] = len(order)
        order.extend(members)

    b = len(nodes)
    size = [0] * b

    def compute_size(i):
        if nodes[i][3] > 0:
            size[i] = 1
            return 1
        ls = compute_size(i + 1)
        rs = compute_size(i + 1 + ls)
        size[i] = 1 + ls + rs
        return size[i]

    compute_size(0)
    miss = [0] * b

    def fill(i, escape):
        miss[i] = escape
        if nodes[i][3] > 0:
            return
        right = i + 1 + size[i + 1]
        fill(i + 1, right)
        fill(right, escape)

    fill(0, b)

    bounds = np.zeros((b, 6), np.float32)
    for i, (nlo, nhi, _f0, _c) in enumerate(nodes):
        bounds[i, 0:3] = nlo
        bounds[i, 3:6] = nhi
    topo = BvhTopology(
        miss=tuple(miss),
        first=tuple(n[2] for n in nodes),
        count=tuple(n[3] for n in nodes),
        order=tuple(order),
    )
    return topo, bounds


def tri_normal(row: np.ndarray, u, v):
    """Shading normal of one triangle row (f32[24] NumPy) at barycentrics
    (u, v): interpolated vertex normals when smooth, else the normalized
    geometric normal e1 x e2 (both as the JAX walk computes them)."""
    if row[11] != 0:
        w0 = 1.0 - u - v
        nx = w0 * _f(row[12]) + u * _f(row[15]) + v * _f(row[18])
        ny = w0 * _f(row[13]) + u * _f(row[16]) + v * _f(row[19])
        nz = w0 * _f(row[14]) + u * _f(row[17]) + v * _f(row[20])
        nlen = torch.sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30))
        return nx / nlen, ny / nlen, nz / nlen
    e1x, e1y, e1z, e2x, e2y, e2z = (_f(x) for x in row[3:9])
    gnx = e1y * e2z - e1z * e2y
    gny = e1z * e2x - e1x * e2z
    gnz = e1x * e2y - e1y * e2x
    glen = np.sqrt(max(gnx * gnx + gny * gny + gnz * gnz, _f(1e-30)), dtype=np.float32)
    return gnx / glen, gny / glen, gnz / glen


def traverse_triangles(o: V3, d: V3, pack, t_min, best_t, update_fn, exclude_obj=None):
    """Lockstep BVH walk over the pack's triangles (bvh.py:195-293).

    ``update_fn(tri_obj_idx, bvh_i, t, ok, normal)`` is called once per
    leaf triangle with its candidate hit and shading normal (a triple of
    scalars, or of lane tensors for smooth triangles); the caller owns the
    winner chain.
    ``best_t()`` returns the running best distance, which prunes box
    visits.
    """
    topo: BvhTopology = pack.bvh
    if topo is None or topo.n_nodes == 0:
        return
    bounds = pack.host("bvh_bounds")
    tri = pack.host("tri")

    inv_dx = 1.0 / d.x
    inv_dy = 1.0 / d.y
    inv_dz = 1.0 / d.z
    skip = torch.zeros_like(o.x, dtype=torch.int32)

    for n in range(topo.n_nodes):
        active = skip <= n
        bn = bounds[n]
        t1x = (bn[0] - o.x) * inv_dx
        t2x = (bn[3] - o.x) * inv_dx
        t1y = (bn[1] - o.y) * inv_dy
        t2y = (bn[4] - o.y) * inv_dy
        t1z = (bn[2] - o.z) * inv_dz
        t2z = (bn[5] - o.z) * inv_dz
        t0 = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
            torch.minimum(t1z, t2z),
        )
        t1 = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
            torch.maximum(t1z, t2z),
        )
        box_hit = active & (t1 >= t0) & (t1 >= t_min) & (t0 < best_t())

        if topo.count[n] > 0:
            for k in range(topo.count[n]):
                bvh_i = topo.first[n] + k
                row = tri[bvh_i]
                v0x, v0y, v0z = row[0], row[1], row[2]
                e1x, e1y, e1z = row[3], row[4], row[5]
                e2x, e2y, e2z = row[6], row[7], row[8]
                px = d.y * e2z - d.z * e2y
                py = d.z * e2x - d.x * e2z
                pz = d.x * e2y - d.y * e2x
                det = e1x * px + e1y * py + e1z * pz
                ok = torch.abs(det) > 1e-9
                inv_det = 1.0 / torch.where(ok, det, 1.0)
                tvx, tvy, tvz = o.x - v0x, o.y - v0y, o.z - v0z
                u = (tvx * px + tvy * py + tvz * pz) * inv_det
                qx = tvy * e1z - tvz * e1y
                qy = tvz * e1x - tvx * e1z
                qz = tvx * e1y - tvy * e1x
                v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
                t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
                ok = ok & box_hit & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= t_min)
                tri_obj_idx = int(row[10])
                if exclude_obj is not None:
                    ok = ok & (exclude_obj != tri_obj_idx)
                update_fn(tri_obj_idx, bvh_i, t, ok, tri_normal(row, u, v))
        else:
            skip = torch.where(active & ~box_hit, topo.miss[n], skip)


# ---------------------------------------------------------------------------
# Paged layout for meshes above STATIC_TRI_MAX
# ---------------------------------------------------------------------------

PAGE_TRIS = 128  # triangle slots per page; the winner key's slot field is its mask
MASK_BITS = 30  # pages per mask word of the JAX walk (PagedBvh.mask_words)
N_PAGE_ATTRS = 32  # page tile columns:
# 0-2 unit geometric normal n | 3 d_plane = n.v0 | 4-6 m1 | 7 c1 |
# 8-10 m2 | 11 c2 | 12 mat | 13 obj | 14 smooth | 15 valid |
# 16-18 vn0 | 19-21 vn1 | 22-24 vn2 | 25-31 pad
# where m1 = e2 x n_raw / |n_raw|^2 and m2 = n_raw x e1 / |n_raw|^2 are the
# barycentric duals (u = m1.h + c1, v = m2.h + c2 at plane point h),
# c1 = -m1.v0, c2 = -m2.v0.
N_SUB_BOXES = 2  # boxes per page that the entry test uses
_KEY_SLOT_MASK = PAGE_TRIS - 1
_BIG_T = 3e38
_BIG_KEY = struct.unpack("<i", struct.pack("<f", _BIG_T))[0] | _KEY_SLOT_MASK
_PREPASS_ELEMS = 1 << 24  # entry-test temporaries hold at most this many floats


@dataclasses.dataclass(frozen=True)
class PagedBvh:
    """Static metadata of the paged layout (the JAX package's fields).

    ``page_bounds``: one (lox,loy,loz,hix,hiy,hiz) per page, float64.
    ``sub_bounds``: per page the ``N_SUB_BOXES`` boxes of the entry test,
    flattened to 6*k floats; a page of 128 triangles is a long curved
    shell whose single box is loose, and every triangle lies inside one
    sub-box.  Pages are sorted by box centre along ``sort_axis``;
    ``sort_margin`` and ``center_fit`` describe that order (the JAX walk's
    early stop reads them; this package only carries them)."""

    n_pages: int
    any_smooth: bool
    page_bounds: Tuple[Tuple[float, float, float, float, float, float], ...]
    sort_axis: int = 0
    sort_margin: float = 0.0
    sub_bounds: Tuple[Tuple[float, ...], ...] = ()
    center_fit: Tuple[Tuple[int, float, float, float], ...] = ()

    @property
    def mask_words(self) -> int:
        return -(-self.n_pages // MASK_BITS)


def tri_bounds(v0, e1, e2):
    """(lo, hi, centroid) f64[T, 3] of each triangle's box."""
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    return lo, hi, (lo + hi) * 0.5


def aligned_median_pages(centroid):
    """The paged build's partition: median splits along the longest centroid
    axis, aligned to the page capacity so that the leaves come out (almost
    all) full pages.  Returns lists of triangle indices, one a page."""

    def split(idxs):
        c = centroid[idxs]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        n = len(idxs)
        half = round(n / 2 / PAGE_TRIS) * PAGE_TRIS
        half = max(PAGE_TRIS, min(half, n - 1))
        if n - half < PAGE_TRIS and n > 2 * PAGE_TRIS:
            half = n - PAGE_TRIS
        return [idxs[i] for i in order[:half]], [idxs[i] for i in order[half:]]

    pages = []

    def emit(idxs):
        if len(idxs) <= PAGE_TRIS:
            pages.append(list(idxs))
            return
        left, right = split(idxs)
        emit(left)
        emit(right)

    emit(list(range(len(centroid))))
    return pages


def sort_pages(pages, lo, hi, centroid):
    """Pages (lists of triangle indices) as the paged build lays them out:
    sorted along the axis of largest page-centre spread, each with its
    ``N_SUB_BOXES`` entry boxes (its members split into runs along its
    longest centroid axis).  Returns (pages, sort_axis, sort_margin,
    sub_bounds)."""
    n_pages = len(pages)
    pcent = np.array([(lo[m].min(axis=0) + hi[m].max(axis=0)) * 0.5 for m in pages])
    sort_axis = int(np.argmax(pcent.max(axis=0) - pcent.min(axis=0))) if n_pages > 1 else 0
    pages = [pages[i] for i in np.argsort(pcent[:, sort_axis], kind="stable")]
    sort_margin = 0.0
    for m in pages:
        blo, bhi = lo[m].min(axis=0), hi[m].max(axis=0)
        c = (blo[sort_axis] + bhi[sort_axis]) * 0.5
        sort_margin = max(sort_margin, c - blo[sort_axis], bhi[sort_axis] - c)

    sub_list = []
    for m in pages:
        c = centroid[m]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        runs = np.array_split(np.asarray(m)[order], min(N_SUB_BOXES, len(m)))
        flat = []
        for run in runs:
            if len(run) == 0:
                run = runs[0][:1]
            blo, bhi = lo[run].min(axis=0), hi[run].max(axis=0)
            flat += [float(x) for x in blo] + [float(x) for x in bhi]
        while len(flat) < 6 * N_SUB_BOXES:  # tiny pages repeat their last box
            flat += flat[-6:]
        sub_list.append(tuple(flat))
    return pages, sort_axis, sort_margin, tuple(sub_list)


def build_paged_bvh(v0, e1, e2, tri_mat, tri_obj, tri_smooth, tri_vn):
    """Median-split paged build (host NumPy, float64 precompute), identical
    to the JAX package's.

    v0/e1/e2: f64[T,3]; tri_mat/tri_obj: per-triangle material index and
    global object id; tri_smooth: per-triangle bool; tri_vn: per-triangle
    (n0,n1,n2) vertex normals or None.

    Returns (paged: PagedBvh,
             page_tiles f32[P, PAGE_TRIS, N_PAGE_ATTRS],
             page_bbox  f32[P, 8]   [lo3, hi3, count, pad])
    """
    t = v0.shape[0]
    lo, hi, centroid = tri_bounds(v0, e1, e2)
    pages, sort_axis, sort_margin, sub_bounds = sort_pages(aligned_median_pages(centroid), lo, hi, centroid)
    n_pages = len(pages)

    # piecewise-linear fit of the sorted page centres (chord per
    # equal-count segment, with the largest residual)
    pcent_sorted = np.array(
        [np.float32((lo[m].min(axis=0)[sort_axis] + hi[m].max(axis=0)[sort_axis]) * 0.5) for m in pages],
        np.float64,
    )
    n_seg = min(4, n_pages)
    fit = []
    edges = np.linspace(0, n_pages, n_seg + 1).astype(int)
    for s in range(n_seg):
        lo_i, hi_i = int(edges[s]), int(edges[s + 1]) - 1
        if hi_i <= lo_i:
            a_s, b_s = 0.0, float(pcent_sorted[lo_i])
        else:
            a_s = float((pcent_sorted[hi_i] - pcent_sorted[lo_i]) / (hi_i - lo_i))
            b_s = float(pcent_sorted[lo_i] - a_s * lo_i)
        idx = np.arange(lo_i, hi_i + 1)
        dev = float(np.abs(pcent_sorted[lo_i : hi_i + 1] - (a_s * idx + b_s)).max())
        fit.append((hi_i, float(np.float32(a_s)), float(np.float32(b_s)),
                    float(np.float32(dev * (1 + 1e-5) + 1e-7))))
    center_fit = tuple(fit)

    # per-triangle plane form (float64)
    tri_mat = np.asarray(tri_mat, np.float64)
    tri_obj = np.asarray(tri_obj, np.float64)
    tri_smooth = np.asarray(tri_smooth, bool)
    n_raw = np.cross(e1, e2)
    nn = np.einsum("ij,ij->i", n_raw, n_raw)
    ok = nn > 1e-30
    safe = np.where(ok, nn, 1.0)
    n_hat = n_raw / np.sqrt(safe)[:, None]
    m1 = np.cross(e2, n_raw) / safe[:, None]
    m2 = np.cross(n_raw, e1) / safe[:, None]
    rows = np.zeros((t, N_PAGE_ATTRS), np.float64)
    rows[:, 0:3] = n_hat
    rows[:, 3] = np.einsum("ij,ij->i", n_hat, v0)
    rows[:, 4:7] = m1
    rows[:, 7] = -np.einsum("ij,ij->i", m1, v0)
    rows[:, 8:11] = m2
    rows[:, 11] = -np.einsum("ij,ij->i", m2, v0)
    rows[:, 12] = tri_mat
    rows[:, 13] = tri_obj
    rows[:, 14] = tri_smooth.astype(np.float64)
    rows[:, 15] = 1.0
    any_smooth = bool((tri_smooth & ok).any())
    if any_smooth and tri_vn is not None:
        vn = np.asarray(tri_vn, np.float64)  # (T, 3 verts, 3)
        rows[:, 16:25] = np.where(tri_smooth[:, None], vn.reshape(t, 9), 0.0)
    rows[~ok] = 0.0  # degenerate: all-zero row, valid stays 0

    tiles = np.zeros((n_pages, PAGE_TRIS, N_PAGE_ATTRS), np.float64)
    page_bbox = np.zeros((n_pages, 8), np.float32)
    bounds = []
    for p, members in enumerate(pages):
        blo = lo[members].min(axis=0)
        bhi = hi[members].max(axis=0)
        page_bbox[p, 0:3] = blo
        page_bbox[p, 3:6] = bhi
        page_bbox[p, 6] = len(members)
        bounds.append(tuple(float(x) for x in blo) + tuple(float(x) for x in bhi))
        tiles[p, : len(members)] = rows[members]

    paged = PagedBvh(
        n_pages=n_pages,
        any_smooth=any_smooth,
        page_bounds=tuple(bounds),
        sort_axis=sort_axis,
        sort_margin=float(np.float32(sort_margin * (1 + 1e-6))),
        sub_bounds=sub_bounds,
        center_fit=center_fit,
    )
    return paged, tiles.astype(np.float32), page_bbox


def page_boxes_table(paged) -> np.ndarray:
    """f32[P, k, 6] entry-test boxes of every page: the sub-boxes when the
    build made them, else the page box.  The JAX package bakes these
    float64 bounds into its traced code as float32 immediates; this is the
    same float64 -> float32 rounding, done once.  A page with fewer
    distinct boxes than ``k`` repeats one, which cannot change an OR."""
    if paged.sub_bounds:
        flat = np.asarray(paged.sub_bounds, np.float64)
    else:
        flat = np.asarray(paged.page_bounds, np.float64)
    return flat.reshape(paged.n_pages, -1, 6).astype(np.float32)


class PagedHit(NamedTuple):
    """Mesh winner of the closest-hit paged walk, per lane.  Lanes without
    a hit carry their start key, page -1, t = 3e38 and zeros."""

    hit: torch.Tensor  # bool: a triangle beat the incoming best_t's key
    key: torch.Tensor  # i32 winner key
    page: torch.Tensor  # i32 winner page, -1 = none
    t: torch.Tensor  # f32 exact distance from the winner's plane
    nx: torch.Tensor  # shading normal (not yet flipped)
    ny: torch.Tensor
    nz: torch.Tensor
    mat: torch.Tensor  # f32 material index of the winner
    obj: torch.Tensor  # f32 object id of the winner
    visits: int  # pages swept by some lane


def _lanes(x, like):
    """A scalar or lane tensor as a flat lane vector shaped like ``like``
    (float32 when it is floating point)."""
    t = torch.as_tensor(x, device=like.device)
    return t.to(torch.float32 if t.is_floating_point() else t.dtype).broadcast_to(like.shape).reshape(-1)


def _page_wants(o, inv, boxes, t_min, best_t, t_max, skip):
    """bool[P, N]: page p's boxes are entered by lane n's ray before
    ``best_t`` (and not after ``t_max``); ``skip`` lanes want nothing."""
    n_pages, n_sub, _ = boxes.shape
    n = o[0].numel()
    block = max(1, _PREPASS_ELEMS // max(1, n_sub * n))
    out = []
    for p0 in range(0, n_pages, block):
        b = boxes[p0 : p0 + block, :, :, None]  # (B, k, 6, 1)
        t1x = (b[:, :, 0] - o[0]) * inv[0]
        t2x = (b[:, :, 3] - o[0]) * inv[0]
        t1y = (b[:, :, 1] - o[1]) * inv[1]
        t2y = (b[:, :, 4] - o[1]) * inv[1]
        t1z = (b[:, :, 2] - o[2]) * inv[2]
        t2z = (b[:, :, 5] - o[2]) * inv[2]
        t0 = torch.maximum(
            torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)), torch.minimum(t1z, t2z)
        )
        t1 = torch.minimum(
            torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)), torch.maximum(t1z, t2z)
        )
        w = (t1 >= t0) & (t1 >= t_min) & (t0 < best_t)
        if t_max is not None:
            w = w & (t0 <= t_max)
        out.append(w.any(dim=1))
    want = torch.cat(out)
    if skip is not None:
        want = want & ~skip
    return want


def _mt_key(tile, o, d, t_min, t_upper, t_max, excl):
    """Plane-form triangle test of one page tile (128, 32) against N rays:
    every intermediate is the (128, N) cross.  Returns the per-pair winner
    key (f32 bits of t with the slot in the low bits, else the big key)."""
    col = lambda c: tile[:, c : c + 1]  # noqa: E731
    ox, oy, oz = o
    dx, dy, dz = d
    nx, ny, nz = col(0), col(1), col(2)
    denom = nx * dx + ny * dy + nz * dz
    t_num = col(3) - (nx * ox + ny * oy + nz * oz)
    ok = (col(15) > 0.5) & (torch.abs(denom) > 1e-12)
    rcp = 1.0 / torch.where(ok, denom, 1.0)
    tt = t_num * rcp
    hx = ox + tt * dx
    hy = oy + tt * dy
    hz = oz + tt * dz
    u = col(4) * hx + col(5) * hy + col(6) * hz + col(7)
    v = col(8) * hx + col(9) * hy + col(10) * hz + col(11)
    ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1.0) & (tt >= t_min) & (tt < t_upper)
    if t_max is not None:
        ok = ok & (tt <= t_max)
    if excl is not None:
        ok = ok & (col(13) != excl)
    slot = torch.arange(PAGE_TRIS, dtype=torch.int32, device=tile.device)[:, None]
    key = (tt.contiguous().view(torch.int32) & ~_KEY_SLOT_MASK) | slot
    return torch.where(ok, key, _BIG_KEY)


def _key_upper_t(key):
    """f32 >= the true winner t of a packed key (slot bits filled)."""
    return (key | _KEY_SLOT_MASK).view(torch.float32)


def _winner_math(o, d, hit, row):
    """Exact hit t and shading normal from the winner's row (N, 32):
    t = (d_plane - n.o) / (n.d) by a true division; smooth rows
    interpolate their vertex normals at the exact hit point."""
    ox, oy, oz = o
    dx, dy, dz = d
    c = lambda i: row[:, i]  # noqa: E731
    gnx, gny, gnz, d_plane = c(0), c(1), c(2), c(3)
    denom = gnx * dx + gny * dy + gnz * dz
    safe = torch.abs(denom) > 1e-12
    t_exact = (d_plane - (gnx * ox + gny * oy + gnz * oz)) / torch.where(safe, denom, 1.0)
    t_exact = torch.where(hit & safe, t_exact, _BIG_T)
    hx = ox + t_exact * dx
    hy = oy + t_exact * dy
    hz = oz + t_exact * dz
    u = c(4) * hx + c(5) * hy + c(6) * hz + c(7)
    v = c(8) * hx + c(9) * hy + c(10) * hz + c(11)
    w0 = 1.0 - u - v
    sx = w0 * c(16) + u * c(19) + v * c(22)
    sy = w0 * c(17) + u * c(20) + v * c(23)
    sz = w0 * c(18) + u * c(21) + v * c(24)
    slen = torch.sqrt(torch.clamp_min(sx * sx + sy * sy + sz * sz, 1e-30))
    use = c(14) > 0.5
    nx = torch.where(use, sx / slen, gnx)
    ny = torch.where(use, sy / slen, gny)
    nz = torch.where(use, sz / slen, gnz)
    return t_exact, nx, ny, nz


def _flat_rays(o: V3, d: V3):
    of = tuple(c.reshape(-1) for c in (o.x, o.y, o.z))
    df = tuple(c.broadcast_to(o.x.shape).reshape(-1) for c in (d.x, d.y, d.z))
    inv = tuple(1.0 / c for c in df)
    return of, df, inv


def traverse_triangles_paged(o: V3, d: V3, pack, t_min, best_t, exclude_obj=None, t_max=None, skip=None) -> PagedHit:
    """Closest-hit paged walk: the plain version of the CUDA walk.

    ``best_t``: the distance each lane came in with (the object sweep's
    winner); a triangle wins only by beating it.  ``exclude_obj``: object
    id per lane that may not be hit (-1 = none).  ``t_max``: optional far
    limit.  ``skip``: lanes whose result the caller discards enter no page.
    The caller merges the winner under ``hit & (t < best_t)``."""
    shape = o.x.shape
    of, df, inv = _flat_rays(o, d)
    t_min = _f(t_min)
    best_t = _lanes(best_t, o.x)
    t_max = None if t_max is None else _lanes(t_max, o.x)
    skip = None if skip is None else _lanes(skip, o.x)
    excl = None if exclude_obj is None else _lanes(exclude_obj, o.x).to(torch.float32)
    tiles = pack.page_tiles

    want = _page_wants(of, inv, pack.page_boxes, t_min, best_t, t_max, skip)
    best_key = (best_t + of[0] * 0.0).view(torch.int32) | _KEY_SLOT_MASK
    key0 = best_key
    best_page = torch.full_like(best_key, -1)
    pages = torch.nonzero(want.any(dim=1)).reshape(-1).tolist()
    for p in pages:
        keys = _mt_key(tiles[p], of, df, t_min, _key_upper_t(best_key), t_max, excl)
        page_key = torch.where(want[p], keys.min(dim=0).values, _BIG_KEY)
        new_key = torch.minimum(best_key, page_key)
        best_page = torch.where(new_key < best_key, p, best_page)
        best_key = new_key

    hit = best_page >= 0
    slot = (best_key & _KEY_SLOT_MASK).to(torch.int64)
    row = tiles[best_page.clamp_min(0).to(torch.int64), slot]
    row = torch.where(hit[:, None], row, 0.0)
    t_exact, nx, ny, nz = _winner_math(of, df, hit, row)
    out = (hit, torch.where(hit, best_key, key0), best_page, t_exact, nx, ny, nz, row[:, 12], row[:, 13])
    return PagedHit(*(x.reshape(shape) for x in out), visits=len(pages))


def occluded_triangles_paged(o: V3, d: V3, pack, t_min, t_max, blocked):
    """Any-hit paged walk for shadow rays: ``blocked`` OR a triangle hit in
    [t_min, t_max].  Lanes that come in blocked enter no page, and a lane
    stops at its first hit."""
    shape = o.x.shape
    of, df, inv = _flat_rays(o, d)
    t_min = _f(t_min)
    t_max = _lanes(t_max, o.x)
    blocked = _lanes(blocked, o.x)
    tiles = pack.page_tiles
    big_t = torch.full_like(of[0], _BIG_T)

    want = _page_wants(of, inv, pack.page_boxes, t_min, big_t, t_max, blocked)
    t_upper = _key_upper_t(big_t.view(torch.int32))
    for p in torch.nonzero(want.any(dim=1)).reshape(-1).tolist():
        live = want[p] & ~blocked
        if not bool(live.any()):
            continue
        keys = _mt_key(tiles[p], of, df, t_min, t_upper, t_max, None)
        blocked = blocked | (live & (keys.min(dim=0).values < _BIG_KEY))
    return blocked.reshape(shape)
