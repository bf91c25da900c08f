"""Ray-primitive intersection on lane tensors.

Torch counterpart of ``path_trace_golang_tpu/ops/geometry.py``: a linear
scan over the (static) object list keeping the closest hit with a strict
``t < best_t`` test, then the mesh: the lockstep BVH walk up to
``STATIC_TRI_MAX`` triangles, the paged walk above (``ops/bvh.py``).
The JAX package carries the winner's material constants through select
chains; here the winner's object and material indices are kept and the
constants are gathered from the tables once at the end, which yields the
same values for every lane that hits.

Epsilons follow the GPU shader (PHYSICS.md Q6): sphere disc reject 1e-8,
plane denom 1e-6, box-face epsilon 1e-4, t_min 0.001.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .soa import MAT_EMISSIVE, OBJ_PLANE, OBJ_SPHERE, ScenePack
from . import bvh as bvh_mod
from .vec import V3

__all__ = [
    "Hit",
    "intersect_world",
    "occluded",
    "box_exit_t",
    "sphere_exit_t",
    "BIG_T",
]

BIG_T = 1e20
_f = np.float32


class Hit(NamedTuple):
    """Closest-hit record (shader Hit struct gpu.go:465-472) plus the
    winning object's material constants, all as lane tensors."""

    hit: torch.Tensor  # bool
    t: torch.Tensor  # f32 (BIG_T when miss)
    p: V3
    normal: V3  # flipped toward the ray origin side
    front_face: torch.Tensor  # bool
    obj_idx: torch.Tensor  # i32
    obj_type: torch.Tensor  # i32
    obj_pos: V3
    obj_size: V3
    mat_idx: torch.Tensor  # i32
    mtyp: torch.Tensor  # i32
    rough: torch.Tensor
    ior: torch.Tensor
    smoothness: torch.Tensor
    reflectivity: torch.Tensor
    abs_scale: torch.Tensor
    albedo: V3
    emit: V3
    absorption: V3
    tint: V3


def _object_candidates(o: V3, d: V3, pack: ScenePack, t_min):
    """Per-object candidate distances: yields (m, t, ok) lane tensors."""
    a = d.dot(d)
    inv_a = 1.0 / a
    inv_dx = 1.0 / d.x  # IEEE inf on zero components, like GLSL
    inv_dy = 1.0 / d.y
    inv_dz = 1.0 / d.z
    obj = pack.host("obj")

    for m in range(pack.n_objects):
        typ = pack.obj_types[m]
        cx, cy, cz = obj[m, 4], obj[m, 5], obj[m, 6]
        sx, sy, sz = obj[m, 8], obj[m, 9], obj[m, 10]
        if typ == OBJ_SPHERE:
            ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
            half_b = ocx * d.x + ocy * d.y + ocz * d.z
            c = ocx * ocx + ocy * ocy + ocz * ocz - sx * sx
            disc = half_b * half_b - a * c
            ok = disc >= 1e-8
            sqrt_d = torch.sqrt(torch.clamp_min(disc, 0.0))
            root_near = (-half_b - sqrt_d) * inv_a
            root_far = (-half_b + sqrt_d) * inv_a
            t = torch.where(root_near >= t_min, root_near, root_far)
            ok = ok & (t >= t_min)
        elif typ == OBJ_PLANE:
            ok = torch.abs(d.y) >= 1e-6
            t = (cy - o.y) * inv_dy
            ok = ok & (t >= t_min)
        else:  # OBJ_BOX: slab test, entry t0 (gpu.go:587-647)
            hx, hy, hz = sx * _f(0.5), sy * _f(0.5), sz * _f(0.5)
            n1x = (cx - hx - o.x) * inv_dx
            n2x = (cx + hx - o.x) * inv_dx
            n1y = (cy - hy - o.y) * inv_dy
            n2y = (cy + hy - o.y) * inv_dy
            n1z = (cz - hz - o.z) * inv_dz
            n2z = (cz + hz - o.z) * inv_dz
            t0 = torch.maximum(
                torch.maximum(torch.minimum(n1x, n2x), torch.minimum(n1y, n2y)),
                torch.clamp_min(torch.minimum(n1z, n2z), t_min),
            )
            t1 = torch.minimum(
                torch.minimum(torch.maximum(n1x, n2x), torch.maximum(n1y, n2y)),
                torch.maximum(n1z, n2z),
            )
            ok = t1 > t0
            t = t0
        yield m, t, ok


def intersect_world(
    o: V3,
    d: V3,
    pack: ScenePack,
    t_min=0.001,
    exclude_obj: Optional[torch.Tensor] = None,
    lite: bool = False,
    skip: Optional[torch.Tensor] = None,
    prof: tuple = (),
) -> Hit:
    """Closest hit over all objects, then the triangles (shader hitWorld).

    ``exclude_obj``: i32 lane tensor of the object index to skip (-1 =
    none), the bounce loop's current-glass-object rule (gpu.go:1353-1357).
    ``lite``: the caller reads only hit, t, normal, mtyp and emit, and acts
    only on emissive winners (the rough-metal specular-NEE ray,
    gpu.go:1474-1496).  On a paged mesh without emissive triangles the
    mesh can then only occlude the object sweep's winner, so, like the JAX
    package, an any-hit walk bounded by that winner's t takes the place of
    the closest-hit walk: lanes whose object winner is not emissive walk
    nothing, and a blocked lane comes back with mtyp 0 and no emission.
    Everywhere else ``lite`` finds the same winner as the full query.
    ``skip``: bool lanes whose result the caller discards; they enter no
    page of the paged walk (work pruning only) and may come back with an
    object-only record.
    ``prof`` (``TraceConfig.prof_no_mesh``, for profiling only): with
    "hit" the mesh is left out of the query, with "lite" out of a lite
    query of a paged mesh, before its emissive skip (JAX
    ops/geometry.py:215, :226); the record is then the objects' alone.
    """
    best_t = torch.full_like(o.x, BIG_T)
    best_m = torch.zeros_like(o.x, dtype=torch.int64)  # winning object index
    best_mat = torch.zeros_like(best_m)

    for m, t, ok in _object_candidates(o, d, pack, t_min):
        if exclude_obj is not None:
            ok = ok & (exclude_obj != m)
        better = ok & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_m = torch.where(better, m, best_m)
        best_mat = torch.where(better, pack.obj_mats[m], best_mat)
    best_obj = best_m
    obj_hit = best_t < BIG_T
    is_tri = torch.zeros_like(o.x, dtype=torch.bool)
    tri_n = [torch.zeros_like(o.x)] * 3

    mesh = bool(pack.n_triangles) and "hit" not in prof
    if mesh and pack.paged is not None and not (lite and "lite" in prof):
        if lite and not pack.tri_any_emissive:
            obj_mtyp = pack.mat[best_mat, 0].to(torch.int32)
            skip_l = ~(obj_hit & (obj_mtyp == MAT_EMISSIVE))
            if skip is not None:
                skip_l = skip_l | skip
            blocked = bvh_mod.occluded_triangles_paged(o, d, pack, t_min, best_t, skip_l)
            h = _finish_hit(o, d, pack, best_t, best_m, best_obj, obj_hit, best_mat, is_tri, tri_n)
            zero = torch.zeros_like(h.emit.x)
            return h._replace(
                mtyp=torch.where(blocked, 0, h.mtyp),
                emit=V3.where(blocked, V3(zero, zero, zero), h.emit),
            )
        w = bvh_mod.traverse_triangles_paged(
            o, d, pack, t_min, best_t, exclude_obj=exclude_obj, skip=skip
        )
        improved = w.hit & (w.t < best_t)
        best_t = torch.where(improved, w.t, best_t)
        best_m = torch.where(improved, w.obj.to(torch.int64), best_m)
        best_mat = torch.where(improved, w.mat.to(torch.int64), best_mat)
        is_tri = improved
        tri_n = [w.nx, w.ny, w.nz]
    elif mesh and pack.paged is None:
        tri = pack.host("tri")
        state = dict(best_t=best_t, best_m=best_m, best_mat=best_mat, is_tri=is_tri, n=tri_n)

        def update(tri_obj_idx, bvh_i, t, ok, nrm):
            better = ok & (t < state["best_t"])
            state["best_t"] = torch.where(better, t, state["best_t"])
            state["best_m"] = torch.where(better, tri_obj_idx, state["best_m"])
            state["best_mat"] = torch.where(better, int(tri[bvh_i, 9]), state["best_mat"])
            state["is_tri"] = state["is_tri"] | better
            state["n"] = [torch.where(better, nc, prev) for nc, prev in zip(nrm, state["n"])]

        bvh_mod.traverse_triangles(
            o, d, pack, t_min, lambda: state["best_t"], update, exclude_obj
        )
        best_t, best_m, best_mat = state["best_t"], state["best_m"], state["best_mat"]
        is_tri, tri_n = state["is_tri"], state["n"]

    return _finish_hit(o, d, pack, best_t, best_m, best_obj, obj_hit, best_mat, is_tri, tri_n)


def _finish_hit(o: V3, d: V3, pack: ScenePack, best_t, best_m, best_obj, obj_hit, best_mat, is_tri, tri_n) -> Hit:
    """Assemble the Hit record: per-type outward normal, setFaceNormal
    flip (gpu.go:484-487), winner constants gathered from the tables."""
    hit = best_t < BIG_T
    t_safe = torch.where(hit, best_t, 0.0)
    p = o + d * t_safe

    orow = pack.obj[best_obj]
    b_c = V3(orow[..., 4], orow[..., 5], orow[..., 6])
    b_s = V3(orow[..., 8], orow[..., 9], orow[..., 10])
    obj_type = torch.where(is_tri, bvh_mod.OBJ_TRIANGLE, orow[..., 0].to(torch.int32))
    # lanes that no object hit carry zeros, as the JAX select chain does
    b_c = V3.where(obj_hit, b_c, V3.zeros_like(o.x))
    b_s = V3.where(obj_hit, b_s, V3.zeros_like(o.x))

    is_sphere = obj_type == OBJ_SPHERE
    is_plane = obj_type == OBJ_PLANE

    inv_r = 1.0 / torch.where(b_s.x != 0, b_s.x, 1.0)
    ns = (p - b_c) * inv_r

    l = p - b_c
    on_x = torch.abs(torch.abs(l.x) - b_s.x * 0.5) < 1e-4
    on_y = torch.abs(torch.abs(l.y) - b_s.y * 0.5) < 1e-4
    nbx = torch.where(on_x, torch.sign(l.x), 0.0)
    nby = torch.where(~on_x & on_y, torch.sign(l.y), 0.0)
    nbz = torch.where(~on_x & ~on_y, torch.sign(l.z), 0.0)

    nx = torch.where(is_sphere, ns.x, torch.where(is_plane, 0.0, nbx))
    ny = torch.where(is_sphere, ns.y, torch.where(is_plane, 1.0, nby))
    nz = torch.where(is_sphere, ns.z, torch.where(is_plane, 0.0, nbz))
    nx = torch.where(is_tri, tri_n[0], nx)
    ny = torch.where(is_tri, tri_n[1], ny)
    nz = torch.where(is_tri, tri_n[2], nz)

    front_face = (d.x * nx + d.y * ny + d.z * nz) < 0
    sgn = torch.where(front_face, 1.0, -1.0)
    normal = V3(nx * sgn, ny * sgn, nz * sgn)

    mrow = pack.mat[best_mat]
    col = lambda c: mrow[..., c]  # noqa: E731
    zero_i = torch.zeros_like(best_m, dtype=torch.int32)
    return Hit(
        hit=hit,
        t=torch.where(hit, best_t, BIG_T),
        p=p,
        normal=normal,
        front_face=front_face,
        obj_idx=torch.where(hit, best_m.to(torch.int32), zero_i),
        obj_type=torch.where(hit, obj_type, zero_i),
        obj_pos=b_c,
        obj_size=b_s,
        mat_idx=torch.where(hit, best_mat.to(torch.int32), zero_i),
        mtyp=torch.where(hit, col(0).to(torch.int32), zero_i),
        rough=col(1),
        ior=col(2),
        smoothness=col(3),
        reflectivity=col(7),
        abs_scale=col(15),
        albedo=V3(col(4), col(5), col(6)),
        emit=V3(col(8), col(9), col(10)),
        absorption=V3(col(12), col(13), col(14)),
        tint=V3(col(16), col(17), col(18)),
    )


def occluded(o: V3, d: V3, pack: ScenePack, t_min, t_max, skip=None, prof: tuple = ()):
    """Any-hit test for shadow rays (hitWorld with tMax = dist - 0.002).

    ``skip``: bool lanes whose result the caller discards (shadow rays
    already ruled out by their cosine or distance terms); they enter no
    page of the paged mesh walk.  ``prof`` with "occl" (for profiling
    only): the mesh blocks nothing (JAX ops/geometry.py:384)."""
    blocked = torch.zeros_like(o.x, dtype=torch.bool)
    for _m, t, ok in _object_candidates(o, d, pack, t_min):
        blocked = blocked | (ok & (t <= t_max))
    if not pack.n_triangles or "occl" in prof:
        return blocked
    if pack.paged is not None:
        return bvh_mod.occluded_triangles_paged(
            o, d, pack, t_min, t_max, blocked if skip is None else (blocked | skip)
        )
    state = dict(blocked=blocked)

    def update(_oi, _bvh_i, t, ok, _nrm):
        state["blocked"] = state["blocked"] | (ok & (t <= t_max))

    big = torch.full_like(o.x, BIG_T)
    # prune box visits once a lane is already occluded
    bvh_mod.traverse_triangles(
        o, d, pack, t_min,
        lambda: torch.where(state["blocked"], _f(t_min), big), update,
    )
    return state["blocked"]


def box_exit_t(o: V3, d: V3, bmin: V3, bmax: V3, t_min=0.001):
    """Slab-test exit distance t1 (hitBox with findExit=true, gpu.go:1559-1564)."""
    inv = V3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    t_near = (bmin - o) * inv
    t_far = (bmax - o) * inv
    t0 = torch.maximum(
        torch.maximum(torch.minimum(t_near.x, t_far.x), torch.minimum(t_near.y, t_far.y)),
        torch.clamp_min(torch.minimum(t_near.z, t_far.z), t_min),
    )
    t1 = torch.minimum(
        torch.minimum(torch.maximum(t_near.x, t_far.x), torch.maximum(t_near.y, t_far.y)),
        torch.maximum(t_near.z, t_far.z),
    )
    valid = (t1 > t0) & (t1 >= t_min)
    return valid, t1


def sphere_exit_t(o: V3, d: V3, center: V3, radius, t_min=0.001):
    """Far-root distance out of a sphere (gpu.go:1566-1591); ``d`` unit."""
    oc = o - center
    half_b = oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = half_b * half_b - c
    ok = disc > 0
    sqrt_d = torch.sqrt(torch.clamp_min(disc, 0.0))
    exit_t = -half_b + sqrt_d
    valid = ok & (exit_t > t_min)
    return valid, exit_t

