"""Reflection / refraction / Fresnel (shader gpu.go:823-867), component-wise."""

from __future__ import annotations

import torch

from .vec import V3

__all__ = ["reflect", "refract", "schlick"]


def reflect(v: V3, n: V3) -> V3:
    """v - 2(v.n)n  (reflectVec, gpu.go:824-828)."""
    return v - n * (2.0 * v.dot(n))


def refract(v: V3, n: V3, eta) -> V3:
    """Snell refraction with the reference's TIR fallback (gpu.go:832-852)."""
    cos_theta = torch.clamp_max((-v).dot(n), 1.0)
    sin2 = 1.0 - cos_theta * cos_theta
    tir = (eta * eta * sin2) > 1.0

    r_perp = (v + n * cos_theta) * eta
    r_perp_len2 = r_perp.dot(r_perp)
    par_len = torch.sqrt(torch.clamp_min(1.0 - torch.clamp_max(r_perp_len2, 1.0), 0.0))
    refracted = r_perp - n * par_len
    return V3.where(tir, reflect(v, n), refracted)


def schlick(cosine, rel_ior):
    """Schlick reflectance (gpu.go:855-867); rel_ior = n2/n1."""
    r0 = (rel_ior - 1.0) / (rel_ior + 1.0)
    r0 = r0 * r0
    x = 1.0 - cosine
    x5 = x * x * x * x * x
    return r0 + (1.0 - r0) * x5
