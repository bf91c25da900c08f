"""Thin-lens look-at camera ray generation, component-wise.

Mirrors ``path_trace_golang_tpu/ops/camera.py`` (shader buildCamera,
gpu.go:1091-1123).  The per-launch camera scalars are computed once by
:func:`camera_basis`, in float32 on the pack's device; the CUDA kernel is
handed the same numbers, so both build identical primary rays.
"""

from __future__ import annotations


import torch

from . import sampling
from .rng import LaneRng
from .vec import V3

__all__ = ["camera_rays", "camera_basis"]


def camera_basis(cam_block: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The camera's derived scalars as a float32 vector of 19: origin (0-2),
    lower-left corner (3-5), horizontal (6-8), vertical (9-11), the unit
    u (12-14) and v (15-17) axes, and the lens radius (18).  The kernel
    reads this layout (csrc/render_pass.cu, BASIS_LEN)."""
    c = cam_block
    # both operands as tensors: a CUDA tensor divided by a Python scalar is
    # computed as a product with its reciprocal, which can differ by an ulp;
    # made by a fill on the device, not copied from the host (a copy from
    # pageable memory synchronises the stream)
    wh = torch.full((), float(width), dtype=torch.float32, device=c.device) / torch.full(
        (), float(height), dtype=torch.float32, device=c.device
    )
    aspect = torch.where(c[15] != 0, c[15], wh)
    theta = c[12] * (3.14159265359 / 180.0)
    h = torch.tan(theta * 0.5)
    viewport_h = 2.0 * h
    viewport_w = aspect * viewport_h

    ox, oy, oz = c[0], c[1], c[2]
    tx, ty, tz = c[4], c[5], c[6]
    ux, uy, uz = c[8], c[9], c[10]

    wx, wy, wz = ox - tx, oy - ty, oz - tz
    wlen = torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-20))
    wx, wy, wz = wx / wlen, wy / wlen, wz / wlen
    cux, cuy, cuz = uy * wz - uz * wy, uz * wx - ux * wz, ux * wy - uy * wx
    culen = torch.sqrt(torch.clamp_min(cux * cux + cuy * cuy + cuz * cuz, 1e-20))
    cux, cuy, cuz = cux / culen, cuy / culen, cuz / culen
    cvx, cvy, cvz = wy * cuz - wz * cuy, wz * cux - wx * cuz, wx * cuy - wy * cux

    focus = torch.where(c[14] != 0, c[14], wlen)
    hw = viewport_w * focus
    hv = viewport_h * focus
    llx = ox - 0.5 * hw * cux - 0.5 * hv * cvx - wx * focus
    lly = oy - 0.5 * hw * cuy - 0.5 * hv * cvy - wy * focus
    llz = oz - 0.5 * hw * cuz - 0.5 * hv * cvz - wz * focus
    vals = (
        ox, oy, oz, llx, lly, llz, hw * cux, hw * cuy, hw * cuz,
        hv * cvx, hv * cvy, hv * cvz, cux, cuy, cuz, cvx, cvy, cvz, c[13] * 0.5,
    )
    return torch.stack([v.reshape(()) for v in vals]).to(torch.float32)


def camera_rays(
    u, v, cam_block, width, height, rng: LaneRng, has_aperture: bool,
    lens_disk: bool = False, basis: torch.Tensor | None = None,
):
    """Primary rays for viewport coords u, v in [0,1] (lane tensors).

    ``has_aperture`` is static: apertureless scenes draw no lens uniforms.
    Both lens models draw three uniforms (the disk ignores the third).
    ``basis`` may carry a precomputed :func:`camera_basis`.
    Returns (orig V3, dir V3 unit).
    """
    b = camera_basis(cam_block, width, height) if basis is None else basis
    ox, oy, oz = b[0], b[1], b[2]
    dx = b[3] + u * b[6] + v * b[9] - ox
    dy = b[4] + u * b[7] + v * b[10] - oy
    dz = b[5] + u * b[8] + v * b[11] - oz
    cux, cuy, cuz, cvx, cvy, cvz = b[12], b[13], b[14], b[15], b[16], b[17]

    if has_aperture:
        lens_radius = b[18]
        if lens_disk:
            u1, u2, _u3 = rng.next3()
            rd = sampling.unit_disk(u1, u2) * lens_radius
        else:
            rd = sampling.unit_ball(*rng.next3()) * lens_radius
        offx = rd.x * cux + rd.y * cvx
        offy = rd.x * cuy + rd.y * cvy
        offz = rd.x * cuz + rd.y * cvz
        orig = V3(ox + offx, oy + offy, oz + offz)
        dirv = V3(dx - offx, dy - offy, dz - offz).normalize()
    else:
        orig = V3.broadcast_scalars(u, ox, oy, oz)
        dirv = V3(dx, dy, dz).normalize()
    return orig, dirv


