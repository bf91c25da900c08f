"""Direction sampling (closed-form, rejection-free), component-wise.

Torch counterpart of ``path_trace_golang_tpu/ops/sampling.py``: every
sampler consumes a fixed number of uniforms, and ``sincos_2pi`` keeps the
quarter-wave minimax polynomials (PHYSICS.md D13) instead of library
sin/cos so that the CUDA kernel and this module compute the same values.
"""

from __future__ import annotations

import torch

from .vec import V3

__all__ = [
    "sincos_2pi",
    "unit_ball",
    "unit_disk",
    "cosine_direction",
    "cosine_direction_onb",
    "sphere_surface",
    "sample_ggx",
]

# Quarter-wave minimax coefficients (Cephes sinf/cosf on [-pi/4, pi/4]).
_S1, _S2, _S3 = -1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4
_C1, _C2, _C3 = 4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5


def sincos_2pi(u):
    """(sin 2*pi*u, cos 2*pi*u) via quarter-wave minimax polynomials."""
    t = u * 4.0
    kf = torch.round(t)  # half to even, like jnp.round
    r = (t - kf) * 1.5707963267948966
    r2 = r * r
    sin_r = r + r * r2 * (_S1 + r2 * (_S2 + r2 * _S3))
    cos_r = 1.0 - 0.5 * r2 + r2 * r2 * (_C1 + r2 * (_C2 + r2 * _C3))
    k = kf.to(torch.int32)
    swap = (k & 1) != 0
    s = torch.where(swap, cos_r, sin_r)
    c = torch.where(swap, sin_r, cos_r)
    k2 = (k & 2) != 0
    s = torch.where(k2, -s, s)
    c = torch.where(k2 ^ swap, -c, c)
    return s, c


def unit_ball(u1, u2, u3) -> V3:
    """Uniform point in the unit ball: z = 1-2u, phi = 2 pi u, r = u^(1/3)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    sin_phi, cos_phi = sincos_2pi(u2)
    rad = torch.exp(torch.log(torch.clamp_min(u3, 1e-30)) * (1.0 / 3.0))
    return V3(r * cos_phi * rad, r * sin_phi * rad, z * rad)


def unit_disk(u1, u2) -> V3:
    """Uniform point on the unit disk (z = 0): r = sqrt(u)."""
    r = torch.sqrt(u1)
    sin_phi, cos_phi = sincos_2pi(u2)
    return V3(r * cos_phi, r * sin_phi, torch.zeros_like(u1))


def _axis_frame(normal: V3, use_first, first, second):
    """Select one of two constant unit axes per lane as a V3 of 0/1 lanes."""
    one = torch.ones_like(normal.x)
    zero = torch.zeros_like(normal.x)
    pick = [torch.where(use_first, one if a else zero, one if b else zero)
            for a, b in zip(first, second)]
    return V3(*pick)


def cosine_direction(normal: V3, u1, u2) -> V3:
    """Cosine-weighted hemisphere direction around ``normal`` with the
    shader's skewed frame (gpu.go:752-774, PHYSICS.md Q3)."""
    sin_phi, cos_phi = sincos_2pi(u1)
    cos_theta = torch.sqrt(u2)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))

    use_y = torch.abs(normal.x) > 0.9
    axis = _axis_frame(normal, use_y, (0, 1, 0), (1, 0, 0))
    v = normal.cross(axis).normalize()

    lx = sin_theta * cos_phi
    ly = sin_theta * sin_phi
    d = axis * lx + v * ly + normal * cos_theta
    return d.normalize()


def cosine_direction_onb(normal: V3, u1, u2) -> V3:
    """Cosine-weighted hemisphere direction around ``normal`` with a proper
    orthonormal frame (v = n x axis normalized, u = v x n), the cpu
    contract's sampler (math.go:94-131); not re-normalized."""
    sin_phi, cos_phi = sincos_2pi(u1)
    cos_theta = torch.sqrt(u2)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))

    use_y = torch.abs(normal.x) > 0.9
    axis = _axis_frame(normal, use_y, (0, 1, 0), (1, 0, 0))
    v = normal.cross(axis).normalize()
    u = v.cross(normal)
    return u * (sin_theta * cos_phi) + v * (sin_theta * sin_phi) + normal * cos_theta


def sphere_surface(u1, u2) -> V3:
    """Uniform direction on the unit sphere (sampleLightGeometry, gpu.go:900-911)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    sin_phi, cos_phi = sincos_2pi(u2)
    return V3(r * cos_phi, r * sin_phi, z)


def sample_ggx(incident: V3, normal: V3, roughness, u1, u2) -> V3:
    """GGX importance-sampled reflection (gpu.go:778-821, PHYSICS.md D3)."""
    alpha = roughness * roughness
    alpha2 = alpha * alpha

    cos_theta = torch.sqrt(
        torch.clamp_min((1.0 - u2) / (1.0 + (alpha2 - 1.0) * u2), 0.0)
    )
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    sin_phi, cos_phi = sincos_2pi(u1)

    use_x = torch.abs(normal.z) >= 0.999
    up = _axis_frame(normal, use_x, (1, 0, 0), (0, 0, 1))
    tangent = up.cross(normal).normalize()
    bitangent = normal.cross(tangent)

    h = (
        tangent * (sin_theta * cos_phi)
        + bitangent * (sin_theta * sin_phi)
        + normal * cos_theta
    ).normalize()

    refl = incident - h * (2.0 * incident.dot(h))
    below = refl.dot(normal) <= 0
    mirror = incident - normal * (2.0 * incident.dot(normal))
    return V3.where(below, mirror, refl).normalize()
