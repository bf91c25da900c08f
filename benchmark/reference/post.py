"""Post-processing: tonemap, gamma, denoise, smooth (torch, any device).

Counterpart of ``path_trace_golang_tpu/post.py``: ACES per channel
(gpu.go:22-47), sqrt gamma with +0.5 byte rounding (gpu.go:2262-2284),
the 3x3 bilateral denoise in byte-sRGB space (gpu.go:2355-2439) and the
optional box blur (gpu.go:2441-2520), with the same boundary handling;
for the cpu contract sqrt gamma and truncation of v * 255.999
(renderer.go:189-221).
"""

from __future__ import annotations

import torch

__all__ = [
    "aces_tonemap",
    "gamma_encode",
    "tonemap_to_u8",
    "bilateral_denoise",
    "box_smooth",
    "finalize_gpu_contract",
    "finalize_cpu_contract",
]


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as a true division (a same-device 0-d divisor: CUDA computes
    a division by a Python scalar as a product with its reciprocal)."""
    return t / t.new_full((), c)


def aces_tonemap(x):
    """ACES approximation x(ax+b)/(x(cx+d)+e), clamped to [0,1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    x = torch.clamp_min(x, 0.0)
    num = x * (a * x + b)
    den = x * (c * x + d) + e
    return torch.clamp(num / torch.clamp_min(den, 1e-20), 0.0, 1.0)


def gamma_encode(x):
    """gamma 2.0 (sqrt), clamped."""
    return torch.clamp(torch.sqrt(torch.clamp_min(x, 0.0)), 0.0, 1.0)


def tonemap_to_u8(linear, use_aces: bool):
    """Linear HDR [H,W,3] -> u8 [H,W,3].

    gpu contract (``use_aces``): ACES, sqrt gamma, round via +0.5
    (gpu.go:2262-2284).  cpu contract: sqrt gamma, then v * 255.999
    clipped and truncated (renderer.go:196-221)."""
    if use_aces:
        v = gamma_encode(aces_tonemap(linear))
        return (v * 255.0 + 0.5).to(torch.uint8)
    v = gamma_encode(linear)
    return torch.clamp(v * 255.999, 0.0, 255.999).to(torch.uint8)


def _shift2d(img, dy, dx):
    """Shift with zero padding; also returns the validity mask."""
    h, w = img.shape[0], img.shape[1]
    shifted = torch.roll(img, (dy, dx), dims=(0, 1))
    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    valid = (row - dy >= 0) & (row - dy < h) & (col - dx >= 0) & (col - dx < w)
    return torch.where(valid[..., None], shifted, 0.0), valid


def bilateral_denoise(u8_img, sigma_s=1.0, sigma_r=0.15):
    """3x3 bilateral filter in byte-sRGB space; out-of-bounds neighbours
    get zero weight, like the reference."""
    img = _div(u8_img.to(torch.float32), 255.0)
    two_ss2 = torch.tensor(2.0 * sigma_s * sigma_s, dtype=torch.float32)
    two_sr2 = 2.0 * sigma_r * sigma_r

    sum_c = torch.zeros_like(img)
    sum_w = torch.zeros(img.shape[:2], dtype=torch.float32, device=img.device)
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            nb, valid = _shift2d(img, ky, kx)
            ds2 = torch.tensor(float(kx * kx + ky * ky), dtype=torch.float32)
            diff = img - nb
            dr2 = torch.sum(diff * diff, dim=-1)
            w = float(torch.exp(-ds2 / two_ss2)) * torch.exp(_div(-dr2, two_sr2))
            w = torch.where(valid, w, 0.0)
            sum_w = sum_w + w
            sum_c = sum_c + nb * w[..., None]
    out = torch.where(
        sum_w[..., None] > 0, sum_c / torch.clamp_min(sum_w, 1e-20)[..., None], img
    )
    out = torch.clamp(out, 0.0, 1.0)
    return (out * 255.0 + 0.5).to(torch.uint8)


def box_smooth(u8_img, radius: int, strength: float):
    """Box blur blended with the original by ``strength``; boundary pixels
    average over the in-bounds window only."""
    radius = max(1, min(5, int(radius)))
    strength = min(1.0, max(0.0, float(strength)))
    img = u8_img.to(torch.float32)
    sum_c = torch.zeros_like(img)
    count = torch.zeros(img.shape[:2], dtype=torch.float32, device=img.device)
    for ky in range(-radius, radius + 1):
        for kx in range(-radius, radius + 1):
            nb, valid = _shift2d(img, ky, kx)
            sum_c = sum_c + nb
            count = count + valid.to(torch.float32)
    avg = sum_c / torch.clamp_min(count, 1.0)[..., None]
    out = img * (1.0 - strength) + avg * strength
    out = torch.clamp(out, 0.0, 255.0)
    return (out + 0.5).to(torch.uint8)


def finalize_gpu_contract(accum, sample_count: int, denoise=True, denoise_sigma_s=1.0, denoise_sigma_r=0.15):
    """Accumulation buffer f32[H,W,3] -> display bytes u8[H,W,3]
    (gpu.go:1742-1747 averaging + readback processing)."""
    mean = _div(accum, float(max(sample_count, 1)))
    u8 = tonemap_to_u8(mean, use_aces=True)
    if denoise:
        u8 = bilateral_denoise(u8, denoise_sigma_s, denoise_sigma_r)
    return u8


def finalize_cpu_contract(accum, sample_count: int):
    """cpu-contract display path: average, sqrt gamma, truncation
    (renderer.go:189-221)."""
    return tonemap_to_u8(_div(accum, float(max(sample_count, 1))), use_aces=False)
