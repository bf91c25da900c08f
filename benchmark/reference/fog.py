"""Volumetric fog: Henyey-Greenstein phase, hash noise, single scattering.

Torch counterpart of ``path_trace_golang_tpu/ops/fog.py`` (shader fog
stack, gpu.go:1125-1341).  The fog block's scalars are read once from the
host copy of the pack and combined in float32, as the JAX package
combines its traced scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from .soa import OBJ_SPHERE, ScenePack
from . import geometry, sampling
from .lights import PI, luminance_clamp
from .rng import LaneRng
from .vec import V3

__all__ = [
    "phase_hg",
    "hash31",
    "volume_noise",
    "medium_coeffs",
    "apply_legacy_fog",
    "estimate_volume_light",
    "FOG_MARCH_STEPS",
    "FOG_MARCH_TMAX",
]

_f = np.float32
FOG_MARCH_STEPS = 24  # gpu.go:1319
FOG_MARCH_TMAX = 40.0  # gpu.go:1314


def _clip(x, lo, hi):
    return min(max(x, _f(lo)), _f(hi))


def phase_hg(cos_theta, g):
    """Henyey-Greenstein phase function (gpu.go:1139-1143); g a float32 scalar."""
    gg = g * g
    denom = (_f(1.0) + gg) - (_f(2.0) * g) * cos_theta
    den = _f(4.0) * _f(PI) * denom * torch.sqrt(torch.clamp_min(denom, 1e-6))
    return torch.full_like(den, _f(1.0) - gg) / den


def hash31(p: V3):
    """3D hash noise (gpu.go:1146-1153): fract(sin(sum of dots)*43758.5453)."""
    qx = p.x * 127.1 + p.y * 311.7 + p.z * 74.7
    qy = p.x * 269.5 + p.y * 183.3 + p.z * 246.1
    qz = p.x * 113.5 + p.y * 271.9 + p.z * 124.6
    s = torch.sin(qx + qy + qz) * 43758.5453
    return s - torch.floor(s)


def volume_noise(p: V3, fog_block: np.ndarray):
    """Fractal hash noise, 1-5 octaves (gpu.go:1156-1171)."""
    octaves = _clip(_f(fog_block[13]), 1.0, 5.0)
    amp = _f(1.0)
    freq = _f(fog_block[12])
    total = torch.zeros_like(p.x)
    norm = _f(0.0)
    for i in range(5):
        if _f(i) < octaves:
            total = total + hash31(p * freq) * amp
            norm = norm + amp
        amp = amp * _f(0.5)
        freq = freq * _f(2.0)
    if norm > 0:
        # a tensor divisor: CUDA divides by a Python scalar as a product
        # with its reciprocal, which can differ by an ulp
        return total / torch.full_like(total, max(norm, _f(1e-20)))
    return torch.ones_like(p.x)


def medium_coeffs(pos: V3, fog_block: np.ndarray):
    """Local (sigma_s, sigma_a, sigma_t) with hetero noise (gpu.go:1174-1203).

    ``fog_block`` is the host copy (f32[16]) of the pack's fog block."""
    base_s = max(_f(fog_block[8]), _f(0.0))
    base_a = max(_f(fog_block[9]), _f(0.0))
    density = _f(fog_block[0])
    scatter = _clip(_f(fog_block[1]), 0.0, 1.0)
    if base_s <= 0 and base_a <= 0 and density > 0:
        sigma_s = density * scatter
        sigma_a = max(density - sigma_s, _f(0.0))
    else:
        sigma_s, sigma_a = base_s, base_a
    if sigma_s + sigma_a <= 0:
        sigma_s = sigma_a = _f(0.0)

    hetero = _f(fog_block[11])
    k = _clip(hetero, 0.0, 1.0)
    n = volume_noise(pos, fog_block)
    if hetero > 0:
        scale = (_f(1.0) - k) * (1.0 - n) + (_f(1.0) + k) * n
    else:
        scale = torch.ones_like(n)
    sigma_s = sigma_s * scale
    sigma_a = sigma_a * scale
    return sigma_s, sigma_a, sigma_s + sigma_a


def apply_legacy_fog(radiance: V3, distance, fog_block: np.ndarray) -> V3:
    """Exponential fog blend toward the fog colour (applyFog, gpu.go:1125-1133)."""
    density = _f(fog_block[0])
    if not (density > 0 and distance > 0):
        return radiance
    att = np.exp(-density * _f(distance), dtype=np.float32)
    one_m = _f(1.0) - att
    return V3(
        radiance.x * att + _f(fog_block[4]) * one_m,
        radiance.y * att + _f(fog_block[5]) * one_m,
        radiance.z * att + _f(fog_block[6]) * one_m,
    )


def estimate_volume_light(pos: V3, view_dir: V3, pack: ScenePack, rng: LaneRng, prof: tuple = ()) -> V3:
    """Single-scatter in-fog lighting at ``pos`` (gpu.go:1208-1297): per
    sphere light an un-offset shadow ray and the HG phase, summed,
    doubled (gpu.go:1283) and luminance-clamped.  Two draws per light.
    ``prof``: the profiling knobs (geometry.occluded)."""
    fog_block = pack.host("fog")
    obj, mat = pack.host("obj"), pack.host("mat")
    g = _f(fog_block[10])
    out = V3.zeros_like(pos.x)
    for i in range(pack.n_lights):
        lo = pack.light_objs[i]
        u1 = rng.next()
        u2 = rng.next()
        if pack.obj_types[lo] != OBJ_SPHERE:
            continue
        cx, cy, cz, radius = obj[lo, 4], obj[lo, 5], obj[lo, 6], obj[lo, 8]
        mi = pack.obj_mats[lo]
        ex, ey, ez = mat[mi, 8], mat[mi, 9], mat[mi, 10]

        light_n = sampling.sphere_surface(u1, u2)
        light_pos = V3(cx + radius * light_n.x, cy + radius * light_n.y, cz + radius * light_n.z)
        area = _f(4.0) * _f(PI) * radius * radius
        inv_pdf = min(max(area, _f(1e-20)), _f(1e6))

        to_light = light_pos - pos
        dist_sq = to_light.dot(to_light)
        valid = dist_sq > 1e-6
        dist = torch.sqrt(torch.clamp_min(dist_sq, 1e-20))
        wi = to_light * (1.0 / dist)

        blocked = geometry.occluded(pos, wi, pack, 0.001, dist - 0.002, prof=prof)
        valid = valid & ~blocked

        cos_light = torch.clamp_min(-(light_n.dot(wi)), 0.0)
        valid = valid & (cos_light > 0)

        cos_theta = -(wi.dot(view_dir))
        phase = phase_hg(cos_theta, g)

        geom = cos_light / torch.clamp_min(dist_sq, 1e-6)
        w = geom * phase * inv_pdf
        contrib = V3(w * ex, w * ey, w * ez)
        out = out + V3.where(valid, contrib, V3.zeros_like(w))

    out = luminance_clamp(out * 2.0)
    if _f(fog_block[1]) > 0:
        return out
    return V3.zeros_like(pos.x)
