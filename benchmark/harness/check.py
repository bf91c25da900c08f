"""Whether the timed path's images are correct: the port against the plain
reference (``benchmark/reference``), once the window has closed.

The reference traces a sample of the compared render's pixels, drawn from
the run's seed, over all of its passes, and works their bytes out again.
The compared numbers:

* ``bytes_off``: the bytes that differ from the reference's, among those of
  the render's last progress frame (the whole accumulator tonemapped, no
  denoise) at every sampled pixel, and, under the gpu contract, those of
  the finished image (ACES and the bilateral denoise) at the centre of each
  sampled 3x3 patch (the denoise mixes neighbours, so the reference traces
  the whole patch);
* ``segments_gap``: the render's segment count against the reference's
  estimate from random (lane, pass) pairs of the frame, |ratio - 1|;
* ``nonfinite``: the largest non-finite count of the window's renders;
* ``plain_calls``: the plain versions' calls in the window (the card only).

The reference sums a pixel's passes in pass order, one at a time; the
renderer may group them (a window of passes in one launch), which moves a
sum by rounding only, so a sound render leaves a byte off now and then,
where a value sits on a rounding edge.  The limits (``limits/<cell>.json``)
were set from the port's readings over many seeds and the control's: the
reference with each pass's radiance and the sum in bfloat16, which
``compare`` puts in the program's place when it is given ``control``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..reference import lanes
from .stats import sub_seed

__all__ = ["Sample", "draw_sample", "patch_sample", "trace_samples", "sample_bytes", "program_bytes", "bytes_off",
           "plan", "readings", "compare", "verdict", "MAX_BATCH"]

MAX_BATCH = 1 << 18  # lanes a reference call traces at once
CHUNK = 1 << 18  # the renderer's chunk: a frame's lanes are traced in whole chunks, the last one padded


@dataclasses.dataclass
class Sample:
    """Pixels of one render to trace: ``pix`` (py, px) rows, ``valid`` (inside
    the frame), and for the gpu contract ``patches`` (a 3x3 patch's rows of
    ``pix``, its centre at [1, 1])."""

    pix: np.ndarray  # int[n, 2] (py, px)
    valid: np.ndarray  # bool[n]
    patches: Optional[np.ndarray]  # int[P, 3, 3] index into pix, or None


def draw_sample(rng, contract: str, w: int, h: int, n: int) -> Sample:
    """``n`` pixels (cpu contract) or 3x3 patches around ``n`` centres (gpu
    contract), uniform over the frame."""
    cy = rng.integers(0, h, size=n)
    cx = rng.integers(0, w, size=n)
    if contract != "gpu":
        return Sample(np.stack([cy, cx], 1), np.ones(n, bool), None)
    return patch_sample(cy, cx, w, h)


def patch_sample(cy, cx, w: int, h: int) -> Sample:
    """The 3x3 patches around centres (cy, cx) of a w x h frame."""
    n = len(cy)
    dy, dx = np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing="ij")
    py = cy[:, None, None] + dy[None]
    px = cx[:, None, None] + dx[None]
    valid = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    pix = np.stack([np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)], -1).reshape(-1, 2)
    return Sample(pix, valid.reshape(-1), np.arange(n * 9).reshape(n, 3, 3))


def _trace(frame, px, py, seeds, basis_idx, bases, device):
    cols, segs = [], []
    for a in range(0, len(px), MAX_BATCH):
        sl = slice(a, a + MAX_BATCH)
        t = lambda x, dt: torch.as_tensor(x[sl], dtype=dt, device=device)  # noqa: E731
        basis = None if bases is None else bases[:, t(basis_idx, torch.int64)]
        c, s = lanes.trace_lane_passes(frame, t(px, torch.int32), t(py, torch.int32), t(seeds, torch.int64), basis)
        cols.append(c)
        segs.append(s)
    return torch.cat(cols), torch.cat(segs)


def trace_samples(frame, passes: int, render_seed: int, samples: list, cameras, seg_lanes: int, rng, device,
                  chunk: int = CHUNK):
    """Trace ``samples`` (one :class:`Sample` a compared frame, ``cameras``
    its camera or None for the scene's own) over all ``passes`` passes of a
    render seeded ``render_seed``, and ``seg_lanes`` random (lane, pass)
    pairs of the frame's traced lanes (its pixels padded to whole chunks of
    ``chunk`` lanes, the renderer's)
    for the segment estimate.  Returns (per sample its valid pixels'
    radiance f32[k, passes, 3]; the estimated segments of the render, or
    None)."""
    w, h = frame.width, frame.height
    px, py, seeds, bidx = [], [], [], []
    p = np.arange(passes)
    for i, s in enumerate(samples):
        keep = s.pix[s.valid]
        px.append(np.repeat(keep[:, 1], passes))
        py.append(np.repeat(keep[:, 0], passes))
        seeds.append(np.tile((render_seed + p) & 0xFFFFFFFF, len(keep)))
        bidx.append(np.full(len(keep) * passes, i))
    n_img = sum(len(x) for x in px)
    chunk = min(chunk, w * h)
    n_pad = -(-(w * h) // chunk) * chunk
    if seg_lanes:
        lane = rng.integers(0, n_pad, size=seg_lanes)
        pq = rng.integers(0, passes, size=seg_lanes)
        px.append(lane % w)
        py.append(lane // w)
        seeds.append((render_seed + pq) & 0xFFFFFFFF)
        bidx.append(np.zeros(seg_lanes, int))
    bases = None if cameras is None else torch.stack([frame.basis(c) for c in cameras], 1)
    cols, segs = _trace(frame, np.concatenate(px), np.concatenate(py), np.concatenate(seeds),
                        np.concatenate(bidx), bases, device)
    est = float(segs[n_img:].to(torch.float64).mean()) * n_pad * passes if seg_lanes else None
    out, at = [], 0
    for s in samples:
        k = int(s.valid.sum())
        out.append(cols[at:at + k * passes].reshape(k, passes, 3))
        at += k * passes
    return out, est


def sample_bytes(sample: Sample, cols, contract: str, dtype=torch.float32):
    """A sample's bytes from its traced radiance, the passes summed in
    ``dtype``: the tonemapped u8[n, 3] of its pixels (zeros outside the
    frame) and, for patches, the denoised u8[P, 3] of their centres."""
    passes = cols.shape[1]
    acc = lanes.accumulate(cols, dtype)
    dev = cols.device
    tone = torch.zeros(len(sample.pix), 3, dtype=torch.uint8, device=dev)
    tone[torch.as_tensor(sample.valid, device=dev)] = lanes.tonemap_rows(acc, passes, contract)
    den = None
    if sample.patches is not None:
        patch = tone[torch.as_tensor(sample.patches.reshape(-1), device=dev)].reshape(-1, 3, 3, 3)
        den = lanes.denoise_centres(patch, torch.as_tensor(sample.valid[sample.patches], device=dev))
        den = den.cpu().numpy()
    return tone.cpu().numpy(), den


def _off(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a.astype(np.int16) != b.astype(np.int16)))


def program_bytes(render, sample: Sample, contract: str):
    """The same bytes of the port's render: its last progress frame at the
    sample's pixels (the finished image under the cpu contract, which has
    no denoise) and its finished image at the patches' centres."""
    src = render.progress if contract == "gpu" else render.image
    tone = np.zeros((len(sample.pix), 3), np.uint8)
    v = sample.valid
    tone[v] = src[sample.pix[v, 0], sample.pix[v, 1]]
    den = None
    if sample.patches is not None:
        c = sample.pix[sample.patches[:, 1, 1]]
        den = render.image[c[:, 0], c[:, 1]]
    return tone, den


def bytes_off(a, b) -> int:
    """The bytes that differ between two sides' bytes of one sample (the
    tonemapped ones and the denoised ones)."""
    return _off(a[0], b[0]) + (0 if a[1] is None else _off(a[1], b[1]))


def plan(window, traffic: dict, settings: dict, scene_json: dict, seed: int, device, loop):
    """What the check traces: the renders, cameras and segment lanes that
    the cell's loop module ``compared`` names, a sample of each render
    drawn from the seed.  Returns (frame, order, samples, cameras, segment
    lanes, rng)."""
    contract, ck = traffic["contract"], traffic["check"]
    w, h = settings["width"], settings["height"]
    rng = np.random.default_rng(sub_seed(seed, 3))
    frame = lanes.Frame(lanes.load_scene(scene_json), contract, w, h, settings["depth"], device)
    order, cameras, seg_lanes = loop.compared(window, traffic, scene_json, rng)
    n = ck.get("patches", ck.get("pixels"))
    samples = [draw_sample(rng, contract, w, h, n) for _ in order]
    return frame, order, samples, cameras, seg_lanes, rng


def readings(window, traffic: dict, settings: dict, scene_json: dict, seed: int, device, loop, sides=(None,)):
    """The compared numbers of a window (see the module docstring), once
    for each of ``sides``: None for the program, a torch dtype for the
    control, the reference summed in that dtype in the program's place.
    The reference is traced once for all sides."""
    contract, chunk = traffic["contract"], traffic.get("renderer", {}).get("chunk", CHUNK)
    frame, order, samples, cameras, seg_lanes, rng = plan(window, traffic, settings, scene_json, seed, device, loop)
    renders = window.renders
    cols, est = trace_samples(frame, settings["passes"], renders[order[0]].seed, samples, cameras, seg_lanes, rng,
                              device, chunk)
    refs = [sample_bytes(s, c, contract) for s, c in zip(samples, cols)]
    out = []
    for side in sides:
        if side is None:
            got = [program_bytes(renders[i], s, contract) for i, s in zip(order, samples)]
        else:
            got = [sample_bytes(s, c, contract, side) for s, c in zip(samples, cols)]
        numbers = {"bytes_off": sum(bytes_off(g, r) for g, r in zip(got, refs))}
        if side is None:
            if est is not None:
                numbers["segments_gap"] = abs(renders[order[0]].segments / est - 1.0)
            numbers["nonfinite"] = max(r.nonfinite for r in renders)
        out.append(numbers)
    return out


def compare(window, traffic: dict, settings: dict, scene_json: dict, seed: int, device, loop, control=None) -> dict:
    """The compared numbers of a window: the program's, or with ``control``
    (a torch dtype) the control's."""
    return readings(window, traffic, settings, scene_json, seed, device, loop, (control,))[0]


def verdict(numbers: dict, limits: dict, failed: int):
    """Whether a run is correct: no render failed and every compared number
    is within its limit.  Returns (correct, {name: (value, limit)})."""
    checks = {k: (v, limits[k]["limit"]) for k, v in numbers.items()}
    return failed == 0 and all(v <= lim for v, lim in checks.values()), checks
