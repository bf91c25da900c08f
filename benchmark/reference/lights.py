"""Next-event estimation over the emissive-light list (gpu.go:875-1070).

Torch counterpart of ``path_trace_golang_tpu/ops/lights.py``: uniform
sphere-area light sampling, an offset shadow ray, the geometry term, the
500-luminance firefly clamp, and the estimator over all lights when there
are at most eight, else over a per-lane random contiguous window of eight
(PHYSICS.md D11).  Every light slot draws two uniforms for every lane.
"""

from __future__ import annotations

import numpy as np
import torch

from .soa import OBJ_SPHERE, ScenePack
from . import geometry, sampling
from .rng import LaneRng
from .vec import V3

__all__ = ["estimate_direct_light", "MAX_LIGHTS_TO_SAMPLE", "PI", "luminance_clamp"]

_f = np.float32
PI = 3.14159265359
INV_PI = 1.0 / 3.14159265359
MAX_LIGHTS_TO_SAMPLE = 8  # gpu.go:1019


def luminance_clamp(contrib: V3, max_lum=500.0) -> V3:
    """Soft firefly clamp at luminance 500 (gpu.go:986-996)."""
    lum = contrib.x * 0.2126 + contrib.y * 0.7152 + contrib.z * 0.0722
    scale = torch.where(
        lum > max_lum, torch.full_like(lum, max_lum) / torch.clamp_min(lum, 1e-6), 1.0
    )
    return contrib * scale


def _direct_single(p: V3, n: V3, albedo: V3, pack: ScenePack, rng: LaneRng, light, gathered: bool, skip=None,
                   prof: tuple = ()) -> V3:
    """estimateDirectLightSingle (gpu.go:923-999) for one light.

    ``light`` is (cx, cy, cz, radius, ex, ey, ez, is_sphere): float32
    scalars for a static light, or lane tensors for a window slot
    (``gathered``).  The two forms keep the JAX package's two operand
    orders for the light's area.  ``skip``: lanes whose contribution the
    caller drops; with the lanes that the cosine and distance terms rule
    out, they enter no page of the paged shadow walk.
    """
    cx, cy, cz, radius, ex, ey, ez, is_sphere = light
    light_n = sampling.sphere_surface(rng.next(), rng.next())
    light_pos = V3(cx + radius * light_n.x, cy + radius * light_n.y, cz + radius * light_n.z)
    if gathered:
        inv_pdf = torch.clamp_min(_f(4.0) * _f(PI) * (radius * radius), 1e-20)
        pdf_cap = torch.clamp_max(inv_pdf, 1e6)
    else:
        inv_pdf = max(_f(4.0) * _f(PI) * radius * radius, _f(1e-20))
        pdf_cap = min(inv_pdf, _f(1e6))

    to_light = light_pos - p
    dist_sq = to_light.dot(to_light)
    valid = (dist_sq > 1e-6) & is_sphere
    dist = torch.sqrt(torch.clamp_min(dist_sq, 1e-20))
    wi = to_light * (1.0 / dist)

    cos_surf = torch.clamp_min(n.dot(wi), 0.0)
    cos_light = torch.clamp_min(-(light_n.dot(wi)), 0.0)
    valid = valid & (cos_surf > 0) & (cos_light > 0)

    shadow_orig = p + n * 0.001
    no_need = ~valid if skip is None else (~valid | skip)
    blocked = geometry.occluded(shadow_orig, wi, pack, 0.001, dist - 0.002, skip=no_need, prof=prof)
    valid = valid & ~blocked

    inv_dist_sq = 1.0 / torch.clamp_min(dist_sq, 1e-6)
    w = cos_surf * cos_light * inv_dist_sq * pdf_cap
    contrib = V3(albedo.x * ex, albedo.y * ey, albedo.z * ez) * (w * INV_PI)
    contrib = luminance_clamp(contrib)
    return V3.where(valid, contrib, V3.zeros_like(w))


def _static_light(pack: ScenePack, lo: int):
    obj, mat = pack.host("obj"), pack.host("mat")
    mi = pack.obj_mats[lo]
    return (obj[lo, 4], obj[lo, 5], obj[lo, 6], obj[lo, 8],
            mat[mi, 8], mat[mi, 9], mat[mi, 10], True)


def _gathered_light(pack: ScenePack, idx_l: torch.Tensor):
    """Per-lane constants of light ``idx_l`` (an index into the light list),
    zeros and is_sphere False for a light that cannot be area-sampled."""
    lights = torch.as_tensor(pack.light_objs, device=idx_l.device, dtype=torch.int64)
    lo = lights[idx_l.to(torch.int64)]
    orow = pack.obj[lo]
    mrow = pack.mat[pack.obj[lo, 1].to(torch.int64)]
    is_sphere = orow[..., 0].to(torch.int32) == OBJ_SPHERE
    z = torch.zeros_like(orow[..., 0])
    pick = lambda v: torch.where(is_sphere, v, z)  # noqa: E731
    return (pick(orow[..., 4]), pick(orow[..., 5]), pick(orow[..., 6]), pick(orow[..., 8]),
            pick(mrow[..., 8]), pick(mrow[..., 9]), pick(mrow[..., 10]), is_sphere)


def estimate_direct_light(p: V3, n: V3, albedo: V3, pack: ScenePack, rng: LaneRng, skip=None,
                          prof: tuple = ()) -> V3:
    """estimateDirectLight (gpu.go:1004-1070): NEE over all lights.

    Every light when there are <= 8, otherwise a random contiguous window
    of 8 per lane scaled by count/8; the sum times 1/light_count.
    ``skip``: lanes whose result the caller discards (shadow-walk work
    pruning only); ``prof``: the profiling knobs (geometry.occluded).
    """
    count = pack.n_lights
    total = V3.zeros_like(p.x)
    if count == 0:
        return total
    if count > MAX_LIGHTS_TO_SAMPLE:
        start = (rng.next() * float(count)).to(torch.int32) % count
        for j in range(MAX_LIGHTS_TO_SAMPLE):
            idx_l = (start + j) % count
            total = total + _direct_single(
                p, n, albedo, pack, rng, _gathered_light(pack, idx_l), gathered=True, skip=skip, prof=prof
            )
        total = total * (count / MAX_LIGHTS_TO_SAMPLE)
    else:
        for i in range(count):
            lo = pack.light_objs[i]
            if pack.obj_types[lo] != OBJ_SPHERE:
                rng.next()  # draws still advance to keep the schedule fixed
                rng.next()
                continue
            total = total + _direct_single(
                p, n, albedo, pack, rng, _static_light(pack, lo), gathered=False, skip=skip, prof=prof
            )
    return total * (1.0 / count)
