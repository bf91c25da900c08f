"""Render orchestration: progressive passes, accumulation, streaming.

Counterpart of ``path_trace_golang_tpu/render.py`` for both physics
contracts.  Under the gpu contract one pass takes the shader's 16
stratified samples per pixel and adds their SUM to the accumulator,
counted as one sample (PHYSICS.md Q1); ``normalize_pass=True`` gives a
physically normalized render instead.  Several passes run in one kernel
launch (a pass window, default 8), each lane reseeding at every pass
boundary, so a window render equals the pass-by-pass render.  Faithful
fog (``faithful_fog=True``), the cpu contract (one sample a pass, the
default backend) and the gpu contract under ``PATHTRACER_NO_REGEN=1`` run
the classic per-sample loop: on the card the cpu contract renders a window
of passes in one launch (``PATHTRACER_PASS_WINDOW``, default 8; ``=1`` gives
one pass a launch) and the gpu contract two launches a sample over all
chunks, one pass a window, as the JAX Renderer dispatches it; on the CPU
they go pass by pass and chunk by chunk.

The renderer runs on the card (``device="cuda"``) unless the caller asks
for the CPU; with no card it raises instead of falling back.  A failure
of the gpu contract raises too: the JAX package's fallback to the cpu
contract is not ported (it would hide a kernel's failure).

Checkpointing (``checkpoint_path``, ``PATHTRACER_CHECKPOINT``) saves the
accumulator at every update interval and resumes from it bit for bit
(``utils/checkpoint.py``); the metrics log (``metrics_sink``,
``PATHTRACER_METRICS``) records every interval (``utils/metrics.py``).
Both fall on the JAX Renderer's pass indices: under checkpointing the
window is capped at the update cadence, and the cpu contract's windows
end at every interval pass whenever an interval is observed.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .integrator import (
    TraceConfig,
    _trace_cpu,
    _trace_gpu,
    fog_prepass_grid,
    pass_regen_gpu,
    regen_enabled,
    trace_config_for_scene,
)
from .ops import cuda_trace
from .ops.camera import camera_basis, camera_rays
from .ops.rng import MASK32, LaneRng, seed_lanes
from .ops.vec import V3
from .post import box_smooth, finalize_cpu_contract, finalize_gpu_contract
from .scene.model import RenderSettings, Scene
from .soa import ScenePack, pack_scene, resolve_device
from .utils import checkpoint as ckpt_mod
from .utils import config as env_config
from .utils import metrics as metrics_mod

__all__ = [
    "RenderConfig",
    "RenderStats",
    "Renderer",
    "render_into",
    "render_scene",
    "render_settings_for_mode",
    "pass_body_grid",
    "fog_pass_terms",
    "trace_pass_lanes",
    "accum_image",
    "set_backend",
    "get_backend",
    "BACKEND_CPU",
    "BACKEND_GPU",
    "FOG_STREAM_XOR",
    "phase_table",
]

_f = np.float32

# Backend switch parity (internal/engine/backend.go:5-28): the names select
# the physics contract.
BACKEND_CPU = "cpu"
BACKEND_GPU = "gpu"
_backend = BACKEND_CPU

# Decorrelation constant for the fog estimate's own counter stream.
FOG_STREAM_XOR = 0x9E3779B9


def set_backend(b: str) -> None:
    global _backend
    if b not in (BACKEND_CPU, BACKEND_GPU):
        raise ValueError(f"unknown backend {b!r}")
    _backend = b


def get_backend() -> str:
    return _backend


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Internal render parameters (engine.RenderConfig, renderer.go:17-22)."""

    width: int
    height: int
    samples_per_px: int
    max_depth: int


@dataclasses.dataclass
class RenderStats:
    passes: int = 0
    samples_per_pixel: int = 0
    ray_segments: int = 0
    wall_seconds: float = 0.0
    nonfinite: int = 0  # non-finite accumulator entries at the end
    resumed_from: int = 0  # passes restored from a checkpoint

    @property
    def mrays_per_sec(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.ray_segments / self.wall_seconds / 1e6


def render_settings_for_mode(mode: str) -> RenderSettings:
    """Mode presets (util.go:25-42): final 1920x1080/1000spp/depth 80,
    preview 400x225/20spp/depth 20."""
    if mode == "final":
        return RenderSettings(width=1920, height=1080, samples_per_px=1000, max_depth=80)
    return RenderSettings(width=400, height=225, samples_per_px=20, max_depth=20)


# ---------------------------------------------------------------------------
# One pass window on pixel lanes (the kernel's plain version)
# ---------------------------------------------------------------------------


def pass_body_grid(
    pack: ScenePack,
    frame_seed: int,
    px,
    py,
    *,
    tcfg: TraceConfig,
    width: int,
    height: int,
    n_strata: int,
    samples: int,
    has_aperture: bool,
    normalize_pass: bool,
    n_passes: int = 1,
):
    """A window of ``n_passes`` progressive passes on pixel-coordinate lanes
    (render.py:194): the fog estimate once per pass on its own counter
    stream (``frame_seed ^ FOG_STREAM_XOR``, PHYSICS.md D6) where the
    config asks for it, then the merged sample+bounce loop, or, for the cpu
    contract and faithful fog, the classic loop (render.py:296-322): per
    sample two jitter draws, the stratum, the camera ray, and the bounce
    loop over all the given lanes, whose returned state starts the next
    sample.  Returns (col V3, segments)."""
    state0 = seed_lanes(px, py, frame_seed)
    inv_w = _f(1.0) / _f(width - 1 if width > 1 else 1)
    inv_h = _f(1.0) / _f(height - 1 if height > 1 else 1)
    fy = _f(height - 1) - py.to(torch.float32)
    pxf = px.to(torch.float32)
    basis = camera_basis(pack.cam, width, height)

    col = V3.zeros_like(pxf)
    if tcfg.enable_fog_march and not tcfg.fog_in_trace:
        for term in fog_pass_terms(pack, frame_seed, px, py, width=width, height=height, samples=samples,
                                   has_aperture=has_aperture, n_passes=n_passes, prof=tcfg.prof_no_mesh):
            col = col + term

    if regen_enabled(tcfg):
        col, _state, segs = pass_regen_gpu(
            pack, px, py, state0, cfg=tcfg, width=width, height=height, n_strata=n_strata,
            samples=samples, has_aperture=has_aperture, frame_seed=frame_seed,
            n_passes=n_passes, col_init=col,
        )
    else:
        if n_passes != 1:
            raise ValueError("n_passes > 1 requires the regeneration loop (gpu contract)")
        trace = _trace_cpu if tcfg.contract == BACKEND_CPU else _trace_gpu
        inv_strata = _f(1.0 / n_strata)
        state, segs = state0, torch.zeros((), dtype=torch.int64, device=px.device)
        for s in range(samples):
            rng = LaneRng(state)
            jx = rng.next()
            jy = rng.next()
            if n_strata > 1:
                su = (jx + float(s % n_strata)) * inv_strata
                sv = (jy + float(s // n_strata)) * inv_strata
            else:
                su, sv = jx, jy
            orig, dirv = camera_rays(
                (pxf + su) * inv_w, (fy + sv) * inv_h, pack.cam, width, height, rng,
                has_aperture, pack.lens_disk, basis=basis,
            )
            rad, state, seg = trace(orig, dirv, rng.state, pack, tcfg)
            col = col + rad
            segs = segs + seg
    if normalize_pass:
        col = col * _f(1.0 / samples)
    return col, segs


def fog_pass_terms(pack: ScenePack, frame_seed: int, px, py, *, width: int, height: int, samples: int,
                   has_aperture: bool, n_passes: int = 1, prof: tuple = ()):
    """The fog estimate once per pass of a window (render.py:232-266), each
    on its own counter stream (``(frame_seed + p) ^ FOG_STREAM_XOR``,
    PHYSICS.md D6): jitter, camera ray and the gated march, times the pass's
    samples.  Returns one V3 a pass, which :func:`pass_body_grid` adds to a
    lane's color in pass order (the fog kernel's plain version).  ``prof``:
    the profiling knobs (``TraceConfig.prof_no_mesh``)."""
    inv_w = _f(1.0) / _f(width - 1 if width > 1 else 1)
    inv_h = _f(1.0) / _f(height - 1 if height > 1 else 1)
    fy = _f(height - 1) - py.to(torch.float32)
    pxf = px.to(torch.float32)
    basis = camera_basis(pack.cam, width, height)
    terms = []
    for p in range(n_passes):
        fs = (int(frame_seed) + p) & MASK32
        rng0 = LaneRng(seed_lanes(px, py, fs ^ FOG_STREAM_XOR))
        jx = rng0.next()
        jy = rng0.next()
        fog_o, fog_d = camera_rays(
            (pxf + jx) * inv_w, (fy + jy) * inv_h, pack.cam, width, height, rng0,
            has_aperture, pack.lens_disk, basis=basis,
        )
        fog_rad, _ = fog_prepass_grid(fog_o, fog_d, rng0.state, pack, prof)
        terms.append(fog_rad * _f(samples))
    return terms


def trace_pass_lanes(
    pack: ScenePack,
    frame_seed: int,
    idx,
    *,
    tcfg: TraceConfig,
    width: int,
    height: int,
    n_strata: int,
    samples: int,
    has_aperture: bool,
    normalize_pass: bool,
    n_passes: int = 1,
):
    """One pass window for flat pixel indices ``idx`` (int[N]).

    Runs the whole-pass kernel on a CUDA device and its plain version on
    the CPU (ops/cuda_trace.py).  Lanes stay flat: no (rows, 128) padding.
    Returns (col f32[N,3], segments int64 0-d tensor).
    """
    idx = idx.to(torch.int32)
    px = idx % width
    py = torch.div(idx, width, rounding_mode="floor")
    col, segs = cuda_trace.render_pass(
        pack, frame_seed, px, py, tcfg=tcfg, width=width, height=height,
        n_strata=n_strata, samples=samples, has_aperture=has_aperture,
        normalize_pass=normalize_pass, n_passes=n_passes,
    )
    return col.to_rows(), segs


def accum_image(accum, w: int, h: int, count: int, gpu: bool, denoise: bool):
    """The u8 image (a tensor) of the first ``w*h`` rows of an accumulator
    after ``count`` passes: the gpu contract's chain (ACES; with ``denoise``
    the bilateral denoise and the box smooth where they are configured,
    which progress frames skip, gpu.go:2291-2293) or the cpu contract's.
    Both the Renderer and the mesh renderer finish their images here."""
    flat = accum[: w * h].reshape(h, w, 3)
    if not gpu:
        return finalize_cpu_contract(flat, count)
    dn = env_config.get_denoise_config()
    u8 = finalize_gpu_contract(
        flat, count, denoise=denoise and dn.enabled,
        denoise_sigma_s=dn.sigma_s, denoise_sigma_r=dn.sigma_r,
    )
    sm = env_config.get_smooth_config()
    if denoise and sm.enabled and sm.radius > 0 and sm.strength > 0:
        u8 = box_smooth(u8, sm.radius, sm.strength)
    return u8


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------


class Renderer:
    """Progressive path-trace renderer.

    ``contract`` None follows the global backend switch ("cpu" unless
    :func:`set_backend` says otherwise).  ``progress`` callbacks receive
    ``(pass_index, u8_image[H,W,3])`` about every 10% of passes under the
    gpu contract (gpu.go:2209-2212), every 5% under the cpu contract
    (renderer.go:226-235); ``cancel()`` returning True stops after the
    current pass window.  ``checkpoint_path`` (or ``PATHTRACER_CHECKPOINT``)
    saves the accumulator at those intervals, keeping ``checkpoint_keep``
    (``PATHTRACER_CHECKPOINT_KEEP``) older generations, and resumes a render
    of the same scene and settings from it; ``metrics_sink`` receives each
    interval's :class:`~.utils.metrics.PassRecord`, and ``metrics`` holds the
    last render's log.  ``spans`` holds the last render's spans and
    ``counters`` its counts (``syncs``: each wait of the host on the card
    outside the phase table's own; ``readback_bytes``), replaced by each
    render.
    """

    def __init__(
        self,
        contract: Optional[str] = None,
        chunk: Optional[int] = None,
        normalize_pass: bool = False,
        seed: int = 1,
        faithful_fog: Optional[bool] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_keep: Optional[int] = None,
        metrics_sink=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.contract = contract
        self.chunk = chunk or env_config.get_chunk_size()
        self.normalize_pass = normalize_pass
        self.seed = seed
        if faithful_fog is None:
            faithful_fog = os.environ.get("PATHTRACER_FAITHFUL_FOG", "") in ("1", "true", "on")
        self.faithful_fog = faithful_fog
        self.checkpoint_path = checkpoint_path or os.environ.get("PATHTRACER_CHECKPOINT", "") or None
        if checkpoint_keep is None:
            checkpoint_keep = int(os.environ.get("PATHTRACER_CHECKPOINT_KEEP", "0") or 0)
        self.checkpoint_keep = checkpoint_keep
        self.metrics_sink = metrics_sink
        self.metrics: Optional[metrics_mod.MetricsLog] = None
        self.spans: list = []  # the last render's spans (utils/metrics.py), its own span first
        self.counters: dict = {}  # the last render's counts: syncs, readback_bytes
        self.stats = RenderStats()

    def render(
        self,
        sc: Scene,
        cfg: RenderConfig,
        progress: Optional[Callable[[int, np.ndarray], None]] = None,
        cancel: Optional[Callable[[], bool]] = None,
    ) -> np.ndarray:
        contract = self.contract or get_backend()
        if contract not in (BACKEND_CPU, BACKEND_GPU):
            raise ValueError(f"unknown contract {contract!r}")
        return self._render(sc, cfg, contract, progress, cancel)

    def _render(self, sc, cfg, contract, progress, cancel) -> np.ndarray:
        # PATHTRACER_TIME_PHASES=1: a table of the render's phases on stderr, each timed to its end (JAX
        # render.py:538-549, 738-744), read from the render's spans (_PHASES); the ends of accum_init and of each
        # pass window synchronise the card first (a ``phase_sync`` span), so the phases add up to slightly more
        # than a render without them.  Off, it adds nothing.
        timed_phases = os.environ.get("PATHTRACER_TIME_PHASES", "") in ("1", "true", "on")
        with metrics_mod.request("render") as rq:
            img = self._passes(sc, cfg, contract, progress, cancel, rq.span, timed_phases)
        self.spans = rq.spans()
        self.counters = rq.counters()
        if timed_phases:
            for name, ms in phase_table(self.spans):
                print(f"  phase {name:<18} {ms:8.1f} ms", file=sys.stderr)
        return img

    def _passes(self, sc, cfg, contract, progress, cancel, root, timed_phases) -> np.ndarray:
        dev = self.device
        span, to_host = metrics_mod.span, metrics_mod.to_host

        def phase_sync():
            if timed_phases:
                with span("phase_sync"):
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)

        def image(count, denoise):  # the u8 image on the host; the card's copy is freed on return
            with span("post.image"):
                u8 = accum_image(accum, w, h, count, gpu, denoise=denoise)
            return to_host(u8, "readback").numpy()

        w, h = cfg.width, cfg.height
        n = w * h
        # as the JAX Renderer: every chunk traces ``chunk`` lanes, the last
        # one too; its lanes past w*h are off-frame pixel rows (py >= h) that
        # trace like real ones, count their segments and, under the classic
        # loop, take part in the chunk's longest path, but never reach the
        # image
        chunk = min(self.chunk, max(n, 1))
        n_pad = -(-n // chunk) * chunk

        with span("render.pack"):
            pack = pack_scene(sc, w, h, device=dev)
        with span("render.config"):
            tcfg = trace_config_for_scene(pack, sc, cfg.max_depth, contract, faithful_fog=self.faithful_fog)
        has_aperture = sc.camera.aperture > 0
        gpu = contract == BACKEND_GPU
        # the shader's strata arithmetic at 1 spp a pass; one sample under the cpu contract
        n_strata, samples = (4, 16) if gpu else (1, 1)

        passes = max(1, cfg.samples_per_px)
        update_every = max(1, passes // (10 if gpu else 20))
        regen = regen_enabled(tcfg)

        # checkpoint / exact resume: a checkpoint of this digest and seed, of
        # this accumulator's shape and short of the passes asked for (JAX
        # render.py:588-611); else a fresh start.  The digest serializes the
        # whole scene (a mesh's every triangle), so it is made only here.
        with span("render.accum_init"):
            digest = None
            start_pass = 0
            accum = None
            if self.checkpoint_path:
                digest = ckpt_mod.scene_digest(sc, cfg, contract, self.normalize_pass, samples)
                ck = ckpt_mod.load_checkpoint(self.checkpoint_path, keep=self.checkpoint_keep)
                if (
                    ck is not None
                    and ck.digest == digest
                    and ck.seed == self.seed
                    and ck.accum.shape == (n_pad, 3)
                    and ck.passes < passes
                ):
                    accum = torch.from_numpy(ck.accum).to(dev)
                    start_pass = ck.passes
            if accum is None:
                accum = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
            total_segs = torch.zeros((), dtype=torch.int64, device=dev)
            phase_sync()
        metrics = metrics_mod.MetricsLog(sink=self.metrics_sink)
        # each interval's record costs a read of the card (the non-finite count and the segments); where
        # nothing observes intervals, the render ends with one record instead (JAX render.py:662-671)
        observed = metrics.observed or bool(self.checkpoint_path) or progress is not None

        # a window of passes: under the regeneration loop as the JAX Renderer's, capped at the update cadence
        # when a callback is given or checkpoints are saved; under the classic loop with one sample a pass (the
        # cpu contract) the window ends at every interval pass that is observed, and is one pass when cancel is
        # given, as the JAX Renderer checks it after every classic pass; the classic loop of the gpu contract
        # (faithful fog, PATHTRACER_NO_REGEN) renders one pass at a time
        window = max(1, int(os.environ.get("PATHTRACER_PASS_WINDOW", "8")))
        if regen:
            if progress is not None or cancel is not None or self.checkpoint_path:
                window = min(window, update_every)
        elif samples > 1 or cancel is not None:
            window = 1

        kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples, has_aperture=has_aperture,
                  normalize_pass=self.normalize_pass)
        # on the card a window's lanes, made once a render, go to the kernels
        # whole: the regeneration instance's in one launch (its blocks take
        # lanes as they go), the classic instance's with their chunks; the
        # lanes, and so the image and the segments, are the same as chunk by chunk
        card = dev.type == "cuda"
        if card:
            idx = torch.arange(n_pad, dtype=torch.int32, device=dev)
            cpx, cpy = idx % w, torch.div(idx, w, rounding_mode="floor")
            del idx
        nonfinite = 0
        p = start_pass
        while p < passes:
            nw = min(window, passes - p)
            if not regen and observed:
                nw = min(nw, update_every - p % update_every)
            frame_seed = (self.seed + p) & MASK32
            with span("render.window", p + nw):
                if card and not regen:
                    total_segs = total_segs + cuda_trace.classic_render(
                        accum, pack, frame_seed, cpx, cpy, chunk=chunk, n_passes=nw, **kw)
                elif card:
                    col, segs = cuda_trace.render_pass(pack, frame_seed, cpx, cpy, n_passes=nw, **kw)
                    accum += col.to_rows()
                    total_segs = total_segs + segs
                    del col  # its buffer is not held through the interval's reads and the progress frame
                else:
                    # on the CPU the regeneration loop takes a window in one call a chunk, the classic loop a pass
                    for q in range(1 if regen else nw):
                        for start in range(0, n_pad, chunk):
                            idx = torch.arange(start, start + chunk, dtype=torch.int32, device=dev)
                            col, segs = trace_pass_lanes(
                                pack, (frame_seed + q) & MASK32, idx, n_passes=nw if regen else 1, **kw)
                            accum[start:start + chunk] += col
                            total_segs = total_segs + segs
                phase_sync()
            p += nw
            if observed and ((p % update_every) < nw or p == passes):
                with span("render.interval", p):
                    # padding lanes too, as the JAX Renderer's
                    nonfinite = to_host(metrics_mod.nonfinite_count(accum))
                    metrics.interval(p, to_host(total_segs), nonfinite)
                if self.checkpoint_path:
                    with span("render.checkpoint", p):
                        ckpt_mod.save_checkpoint(
                            self.checkpoint_path,
                            ckpt_mod.Checkpoint(accum=to_host(accum, "readback").numpy(), passes=p, seed=self.seed,
                                                digest=digest, width=w, height=h),
                            keep=self.checkpoint_keep,
                        )
                if progress is not None:
                    with span("render.progress", p):
                        frame = image(p, denoise=False)  # progress frames skip denoise/smooth (gpu.go:2291-2293)
                        with span("callback"):
                            progress(p, frame)
            if cancel is not None and cancel():
                break

        cpx = cpy = None  # the finish's image does not hold the lanes' memory
        with span("render.finish"):
            img = image(p, denoise=True)
            segs_total = to_host(total_segs)
            if not observed:
                nonfinite = to_host(metrics_mod.nonfinite_count(accum))
                metrics.interval(p, segs_total, nonfinite)
        self.stats = RenderStats(
            passes=p,
            samples_per_pixel=p * samples,
            ray_segments=segs_total,
            wall_seconds=(time.perf_counter_ns() - root.start_ns) / 1e9,
            nonfinite=nonfinite,
            resumed_from=start_pass,
        )
        self.metrics = metrics
        return img


# the phase table (PATHTRACER_TIME_PHASES): each phase ends where its span, a child of the render's, ends
_PHASES = {"render.pack": "pack_scene", "render.config": "trace_config", "render.accum_init": "accum_init",
           "render.window": "pass_window@{}", "render.interval": "interval@{}", "render.finish": "final_fetch"}


def phase_table(spans) -> list:
    """The phase table of one render's spans (the render's span first): (name,
    ms from the previous phase's end, or the render's start, to its own)."""
    root = spans[0]
    rows, t = [], root.start_ns
    for sp in spans:
        if sp.parent is root and sp.name in _PHASES:
            rows.append((_PHASES[sp.name].format(sp.arg), (sp.end_ns - t) / 1e6))
            t = sp.end_ns
    return rows


# ---------------------------------------------------------------------------
# Facade API (engine/util.go parity)
# ---------------------------------------------------------------------------


def render_into(
    sc: Scene,
    cfg: RenderConfig,
    progress: Optional[Callable[[int, np.ndarray], None]] = None,
    device="cuda",
) -> np.ndarray:
    """RenderInto analog (renderer.go:34-41): honors the backend switch."""
    return Renderer(device=device).render(sc, cfg, progress=progress)


def render_scene(sc: Scene, settings: RenderSettings, device="cuda") -> np.ndarray:
    """RenderScene analog (util.go:13-22)."""
    cfg = RenderConfig(
        width=settings.width,
        height=settings.height,
        samples_per_px=settings.samples_per_px,
        max_depth=settings.max_depth,
    )
    return render_into(sc, cfg, device=device)
