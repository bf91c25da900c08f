"""Sky / background evaluation (shader backgroundColor, gpu.go:1073-1088)."""

from __future__ import annotations

import torch

from .vec import V3

__all__ = ["background_color"]


def background_color(unit_dir: V3, sky_block) -> V3:
    """Evaluate the sky for unit directions.

    sky_block layout (soa.py): [0]=type (0 legacy background / 1 solid /
    2 gradient), [4:7]=color, [8:11]=horizon, [12:15]=zenith.
    """
    is_gradient = torch.round(sky_block[0]).to(torch.int32) == 2
    t = torch.clamp((unit_dir.y + 1.0) * 0.5, 0.0, 1.0)
    one_m = 1.0 - t
    gx = sky_block[8] * one_m + sky_block[12] * t
    gy = sky_block[9] * one_m + sky_block[13] * t
    gz = sky_block[10] * one_m + sky_block[14] * t
    flat = V3.broadcast_scalars(t, sky_block[4], sky_block[5], sky_block[6])
    return V3.where(is_gradient, V3(gx, gy, gz), flat)
