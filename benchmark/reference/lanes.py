"""The benchmark's plain reference: a render's passes traced lane by lane.

A lane here is one pixel in one pass: (px, py, frame seed).  Every pass
reseeds its lanes from ``seed_lanes(px, py, seed + pass)`` and its
radiance does not depend on any other lane or pass, so a sample of pixels
over all of a render's passes gives exactly the radiance that those
pixels' passes add into the renderer's accumulator; only the order in
which the passes are summed is the reference's own (pass order, one pass
at a time).

Nothing here imports the port: the scene is parsed, packed and, for a
mesh, paged again from the scene's own JSON.
"""

from __future__ import annotations

import numpy as np
import torch

from .camera import camera_basis, camera_rays
from .integrator import fog_prepass_grid, pass_regen_gpu, trace_config_for_scene, trace_cpu
from .post import _div, finalize_cpu_contract, finalize_gpu_contract
from .rng import MASK32, LaneRng, seed_lanes
from .scene_model import Scene
from .soa import camera_block, pack_scene
from .vec import V3

__all__ = ["load_scene", "Frame", "trace_lane_passes", "accumulate", "tonemap_rows", "denoise_centres",
           "FOG_STREAM_XOR"]

_f = np.float32
FOG_STREAM_XOR = 0x9E3779B9  # the fog estimate's own counter stream (PHYSICS.md D6)


def load_scene(scene_json: dict) -> Scene:
    return Scene.from_json(scene_json)


class Frame:
    """One frame's scene, size, contract and depth, packed on ``device``."""

    def __init__(self, scene: Scene, contract: str, width: int, height: int, depth: int, device):
        self.scene, self.contract, self.width, self.height = scene, contract, width, height
        self.pack = pack_scene(scene, width, height, device=device)
        self.tcfg = trace_config_for_scene(self.pack, scene, depth, contract)
        self.has_aperture = scene.camera.aperture > 0

    def basis(self, camera=None) -> torch.Tensor:
        """The camera's f32[19] basis: the scene's own camera, or another
        (an editor frame's) on the same scene."""
        cam = self.pack.cam if camera is None else torch.from_numpy(
            camera_block(camera, self.width, self.height)).to(self.pack.device)
        return camera_basis(cam, self.width, self.height)


def trace_lane_passes(frame: Frame, px, py, frame_seed, basis=None):
    """The radiance and segments of one pass a lane.

    ``px``, ``py``: int32 lane tensors; ``frame_seed``: int64 lanes, the
    pass's seed (render seed + pass index, mod 2**32); ``basis``: None for
    the scene's camera, else f32[19, N], one camera a lane.  Under the gpu
    contract a pass is 16 stratified samples with path regeneration and
    the fog estimated once on its own stream; under the cpu contract one
    sample of the classic bounce loop.  Returns (f32[N, 3], int64[N])."""
    pack, tcfg, w, h = frame.pack, frame.tcfg, frame.width, frame.height
    fs = frame_seed.to(torch.int64) & MASK32
    if basis is None:
        basis = frame.basis()
    inv_w = _f(1.0) / _f(w - 1 if w > 1 else 1)
    inv_h = _f(1.0) / _f(h - 1 if h > 1 else 1)
    fy = _f(h - 1) - py.to(torch.float32)
    pxf = px.to(torch.float32)
    state0 = seed_lanes(px, py, fs)
    col = V3.zeros_like(pxf)
    if tcfg.contract == "gpu":
        samples = 16
        if tcfg.enable_fog_march:
            rng0 = LaneRng(seed_lanes(px, py, fs ^ FOG_STREAM_XOR))
            jx = rng0.next()
            jy = rng0.next()
            fog_o, fog_d = camera_rays((pxf + jx) * inv_w, (fy + jy) * inv_h, rng0, frame.has_aperture,
                                       pack.lens_disk, basis)
            fog_rad, _ = fog_prepass_grid(fog_o, fog_d, rng0.state, pack)
            col = col + fog_rad * _f(samples)
        col, _state, segs = pass_regen_gpu(
            pack, px, py, state0, cfg=tcfg, basis=basis, width=w, height=h, n_strata=4, samples=samples,
            has_aperture=frame.has_aperture, col_init=col,
        )
    else:
        rng = LaneRng(state0)
        jx = rng.next()
        jy = rng.next()
        orig, dirv = camera_rays((pxf + jx) * inv_w, (fy + jy) * inv_h, rng, frame.has_aperture, pack.lens_disk,
                                 basis)
        rad, _state, segs = trace_cpu(orig, dirv, rng.state, pack, tcfg)
        col = col + rad
    return col.to_rows(), segs


def accumulate(cols: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """f32[pixels, passes, 3] -> the accumulator rows f32[pixels, 3]: the
    passes added in pass order, in ``dtype`` (float32 as the renderer
    states; bfloat16 for the control, which then holds each pass's
    radiance and the sum in bfloat16)."""
    acc = torch.zeros(cols.shape[0], 3, dtype=dtype, device=cols.device)
    for p in range(cols.shape[1]):
        acc = acc + cols[:, p].to(dtype)
    return acc.to(torch.float32)


def tonemap_rows(accum, count: int, contract: str):
    """u8[N, 3] of accumulator rows after ``count`` passes, as a frame's
    progress image shows them (no denoise)."""
    if contract == "gpu":
        return finalize_gpu_contract(accum, count, denoise=False)
    return finalize_cpu_contract(accum, count)


def denoise_centres(u8_patches, valid, sigma_s=1.0, sigma_r=0.15):
    """The 3x3 bilateral denoise (gpu.go:2355-2439, ``post.bilateral_denoise``)
    at the centres of u8[N, 3, 3, 3] patches (row, column, channel; the
    centre at [1, 1]), ``valid`` bool[N, 3, 3] the patch pixels inside the
    frame.  The arithmetic is the whole-image filter's, element for
    element, so the bytes are the same as the filter run on the image."""
    img = _div(u8_patches.to(torch.float32), 255.0)
    c = img[:, 1, 1]
    two_ss2 = torch.tensor(2.0 * sigma_s * sigma_s, dtype=torch.float32)
    two_sr2 = 2.0 * sigma_r * sigma_r
    sum_c = torch.zeros_like(c)
    sum_w = torch.zeros(c.shape[:1], dtype=torch.float32, device=c.device)
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            # the whole-image filter's neighbour at (ky, kx) is the pixel at (y - ky, x - kx)
            ok = valid[:, 1 - ky, 1 - kx]
            nb = torch.where(ok[:, None], img[:, 1 - ky, 1 - kx], 0.0)
            ds2 = torch.tensor(float(kx * kx + ky * ky), dtype=torch.float32)
            diff = c - nb
            dr2 = torch.sum(diff * diff, dim=-1)
            w = float(torch.exp(-ds2 / two_ss2)) * torch.exp(_div(-dr2, two_sr2))
            w = torch.where(ok, w, 0.0)
            sum_w = sum_w + w
            sum_c = sum_c + nb * w[..., None]
    out = torch.where(sum_w[..., None] > 0, sum_c / torch.clamp_min(sum_w, 1e-20)[..., None], c)
    out = torch.clamp(out, 0.0, 1.0)
    return (out * 255.0 + 0.5).to(torch.uint8)
