"""Multi-GPU scale-out: a ("px", "spp") device mesh on ``torch.distributed``.

Counterpart of ``path_trace_golang_tpu/parallel/mesh.py``.  The reference's
only parallelism is data-parallel pixels plus progressive passes; the mesh
maps them onto devices:

* **px axis**: pixels split across ranks.  No collective during a pass
  (pixels are independent); each rank keeps its block of the accumulator.
* **spp axis**: passes split across ranks.  Each spp rank renders the same
  pixels with a different counter seed, and one ``all_reduce`` over the
  "spp" group merges the per-pass sums into the accumulator.

Both axes compose: a (P, S) mesh renders P pixel blocks x S pass windows a
dispatch.  It is SPMD, one process a rank (``torchrun``, or
:func:`.launch.run_world`): every rank calls :meth:`MeshRenderer.render`
with the same arguments and gets the same image.  On the card each rank
renders its lanes with the port's kernels (``ops/cuda_trace.py``), on the
CPU with their plain versions.

Collectives: NCCL with one card a rank (the default on ``cuda``); gloo on
the CPU and where several ranks share one card (NCCL refuses two ranks on
one GPU).  Only ``all_reduce`` and ``broadcast`` are used, the two
collectives gloo runs on CUDA tensors.  The backend is the caller's: a
failed initialisation or collective raises, and nothing changes backend or
device behind the caller's back.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..integrator import regen_enabled, trace_config_for_scene
from ..ops import cuda_trace
from ..ops.rng import MASK32
from ..render import RenderConfig, RenderStats, accum_image, trace_pass_lanes
from ..scene.model import Scene
from ..soa import ScenePack, pack_scene, resolve_device
from ..utils import checkpoint as ckpt_mod
from ..utils import metrics as metrics_mod

__all__ = ["make_mesh", "MeshRenderer"]

DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_px: Optional[int] = None, n_spp: int = 1, device="cuda", backend: Optional[str] = None) -> DeviceMesh:
    """Build a ("px", "spp") mesh over the first ``n_px * n_spp`` ranks of
    the world; ``n_px`` None puts all ranks on "px".  Rank r sits at
    ``(r // n_spp, r % n_spp)``, as the JAX mesh's ``reshape(n_px, n_spp)``.

    Every rank of the world calls it (the groups are made collectively).
    Where no process group exists yet, it initialises one from the
    ``torchrun`` environment (``env://``) with ``backend`` (default NCCL on
    ``cuda``, gloo on the CPU); an existing group must have that backend.
    On ``cuda`` it selects the rank's card: the one asked for, else
    ``LOCAL_RANK`` (or the global rank) modulo the cards present, so that
    ranks beyond the cards share them (over gloo)."""
    dev = resolve_device(device)
    if dev.type not in DEFAULT_BACKEND:
        raise ValueError(f"make_mesh: no mesh for device {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend or DEFAULT_BACKEND[dev.type], init_method="env://")
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"make_mesh: the process group runs {dist.get_backend()!r}, not {backend!r}")
    world = dist.get_world_size()
    if n_px is None:
        n_px = world // n_spp
    if n_px < 1 or n_spp < 1 or n_px * n_spp > world:
        raise ValueError(f"mesh {n_px}x{n_spp} needs {n_px * n_spp} ranks, have {world}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(index % torch.cuda.device_count())
    ranks = torch.arange(n_px * n_spp, dtype=torch.int32).reshape(n_px, n_spp)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("px", "spp"))


def _mesh_sum(t: torch.Tensor, mesh: DeviceMesh) -> None:
    """All-reduce ``t`` (an integer tensor: the sum is exact in any order)
    over the whole mesh, in place: over "spp", then over "px"."""
    dist.all_reduce(t, group=mesh.get_group("spp"))
    dist.all_reduce(t, group=mesh.get_group("px"))


def _mesh_broadcast(t: torch.Tensor, mesh: DeviceMesh) -> None:
    """Broadcast ``t`` from the mesh's rank (0, 0) to every rank of the
    mesh, in place: along (0, *)'s "spp" group, then along each "px" group."""
    ip, isp = mesh.get_coordinate()
    ranks = mesh.mesh
    if ip == 0:
        dist.broadcast(t, src=int(ranks[0, 0]), group=mesh.get_group("spp"))
    dist.broadcast(t, src=int(ranks[0, isp]), group=mesh.get_group("px"))


def _gather(accum_blk: torch.Tensor, n_pad: int, mesh: DeviceMesh) -> torch.Tensor:
    """The whole accumulator f32[n_pad, 3] on every rank: each rank's px
    block placed in a zeroed buffer and the buffers all-reduced over "px"
    (an all_reduce, not an all_gather, since gloo gathers no CUDA tensors;
    x + 0 is x, so the blocks arrive bit for bit)."""
    ip = mesh.get_coordinate()[0]
    block = accum_blk.shape[0]
    full = torch.zeros((n_pad, 3), dtype=accum_blk.dtype, device=accum_blk.device)
    full[ip * block:(ip + 1) * block] = accum_blk
    dist.all_reduce(full, group=mesh.get_group("px"))
    return full


def _sharded_pass(
    accum_blk: torch.Tensor,
    pack: ScenePack,
    base_seed: int,
    pass_base: int,
    *,
    mesh: DeviceMesh,
    tcfg,
    width: int,
    height: int,
    n_strata: int,
    samples: int,
    has_aperture: bool,
    normalize_pass: bool,
    n_pad: int,
    n_passes: int = 1,
    chunk: int = 0,
):
    """One dispatch on this rank: its pixel block (lanes ``[ip*block,
    (ip+1)*block)``, ``block = n_pad // n_px``) for its own window of
    ``n_passes`` passes (frame seed ``base_seed + pass_base + isp *
    n_passes``), the window's sums all-reduced over "spp" and then added
    into ``accum_blk`` (f32[block, 3], in place), as JAX ``mesh.py:135-137``.
    ``chunk`` (0 = the whole block) cuts the block into chunks, the last one
    short: the regeneration loop traces them one call each (on the card the
    whole block is one launch when ``chunk`` is 0); the classic loop takes
    them as its chunks, whose longest paths advance their lanes' states
    (PHYSICS.md D7).  Returns (accum_blk, this rank's segments, int64)."""
    ip, isp = mesh.get_coordinate()
    block = n_pad // mesh.size(0)
    frame_seed = (base_seed + pass_base + isp * n_passes) & MASK32
    col, segs = render_block(pack, frame_seed, ip * block, block, tcfg=tcfg, width=width, height=height,
                             n_strata=n_strata, samples=samples, has_aperture=has_aperture,
                             normalize_pass=normalize_pass, n_passes=n_passes, chunk=chunk)
    dist.all_reduce(col, group=mesh.get_group("spp"))  # merge the simultaneous pass windows
    accum_blk += col
    return accum_blk, segs


def render_block(pack: ScenePack, frame_seed: int, lo0: int, block: int, *, tcfg, width: int, height: int,
                 n_strata: int, samples: int, has_aperture: bool, normalize_pass: bool, n_passes: int = 1,
                 chunk: int = 0):
    """A rank's work in one dispatch, without its collective: the pass window
    ``n_passes`` from ``frame_seed`` on the lanes ``[lo0, lo0 + block)``, cut
    into chunks of ``chunk`` lanes (0 = the whole block).  Returns (col
    f32[block, 3], segments int64)."""
    csize = block if chunk <= 0 else min(chunk, block)
    kw = dict(tcfg=tcfg, width=width, height=height, n_strata=n_strata, samples=samples, has_aperture=has_aperture,
              normalize_pass=normalize_pass)
    dev = pack.device
    if regen_enabled(tcfg):
        cols = []
        segs = torch.zeros((), dtype=torch.int64, device=dev)
        for lo in range(0, block, csize):
            idx = torch.arange(lo0 + lo, lo0 + min(lo + csize, block), dtype=torch.int32, device=dev)
            col_c, seg_c = trace_pass_lanes(pack, frame_seed, idx, n_passes=n_passes, **kw)
            cols.append(col_c)
            segs = segs + seg_c
        col = cols[0] if len(cols) == 1 else torch.cat(cols)
    else:
        idx = torch.arange(lo0, lo0 + block, dtype=torch.int32, device=dev)
        col = torch.zeros((block, 3), dtype=torch.float32, device=dev)
        px, py = idx % width, torch.div(idx, width, rounding_mode="floor")
        segs = cuda_trace.classic_render(col, pack, frame_seed, px, py, chunk=csize, n_passes=n_passes, **kw)
    return col, segs


def dispatch_plan(tcfg, passes: int, n_spp: int, interactive: bool = False):
    """(window, dispatches) of a render of ``passes`` passes: the JAX MeshRenderer's windows (mesh.py:219-234).
    A dispatch advances ``n_spp * window`` passes, the passes rounded up to whole dispatches; the window is
    capped at the update cadence where the render is ``interactive`` (callbacks or checkpointing)."""
    window = 1
    if regen_enabled(tcfg):
        window = max(1, int(os.environ.get("PATHTRACER_PASS_WINDOW", "8")))
    window = max(1, min(window, -(-passes // n_spp)))
    if interactive:
        window = max(1, min(window, passes // max(1, 10 * n_spp)))
    return window, -(-passes // (n_spp * window))


class MeshRenderer:
    """Progressive renderer over a ("px", "spp") mesh of ranks.

    Each dispatch advances ``n_spp`` pass windows at once (one a spp rank);
    pixel lanes are split over "px".  The lane RNG is keyed by (x, y, pass),
    not by rank, so the sample set is the single Renderer's.  Where the
    lanes, chunks and windows are the same, a px-only mesh gives the single
    Renderer's bits; an spp mesh adds the same samples in another order.
    Re-running the same mesh with the same seed is bit-stable.

    SPMD: every rank of the mesh calls :meth:`render` with the same
    arguments.  ``cancel()`` is asked on rank (0, 0) after each dispatch and
    its answer broadcast, so that every rank leaves the loop at the same
    dispatch; ``progress`` is called and checkpoints are saved there too (a
    checkpoint is loaded there and broadcast).  Every rank returns the whole
    image.  Windows, dispatches, the checkpoint digest and the resume rules
    are the JAX MeshRenderer's, so that checkpoints load across the
    packages; its dispatch cap for the TPU (``max_chunk_lanes``) is not
    ported, and segments are summed exactly in int64.
    """

    def __init__(
        self,
        mesh: Optional[DeviceMesh] = None,
        contract: str = "gpu",
        normalize_pass: bool = False,
        seed: int = 1,
        faithful_fog: bool = False,
        chunk: int = 0,
        checkpoint_path: Optional[str] = None,
        checkpoint_keep: Optional[int] = None,
        device="cuda",
    ):
        device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        if self.mesh.device_type != device.type or self.mesh.mesh_dim_names != ("px", "spp"):
            raise ValueError(f"MeshRenderer: a ('px', 'spp') mesh of {device.type} devices is needed, got {self.mesh}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        if contract not in ("cpu", "gpu"):
            raise ValueError(f"unknown contract {contract!r}")
        self.contract = contract
        self.normalize_pass = normalize_pass
        self.seed = seed
        self.faithful_fog = faithful_fog
        self.chunk = chunk
        self.checkpoint_path = checkpoint_path or os.environ.get("PATHTRACER_CHECKPOINT", "") or None
        if checkpoint_keep is None:
            checkpoint_keep = int(os.environ.get("PATHTRACER_CHECKPOINT_KEEP", "0") or 0)
        self.checkpoint_keep = checkpoint_keep
        self.stats = RenderStats()

    def render(
        self,
        sc: Scene,
        cfg: RenderConfig,
        progress: Optional[Callable[[int, np.ndarray], None]] = None,
        cancel: Optional[Callable[[], bool]] = None,
    ) -> np.ndarray:
        t0 = time.perf_counter()
        mesh, dev = self.mesh, self.device
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"MeshRenderer.render: rank {dist.get_rank()} is not in the mesh")
        ip, isp = coord
        lead = ip == 0 and isp == 0
        w, h = cfg.width, cfg.height
        n = w * h
        n_px, n_spp = mesh.size(0), mesh.size(1)
        n_pad = -(-n // n_px) * n_px
        block = n_pad // n_px

        pack = pack_scene(sc, w, h, device=dev)
        tcfg = trace_config_for_scene(pack, sc, cfg.max_depth, self.contract, faithful_fog=self.faithful_fog)
        has_aperture = sc.camera.aperture > 0
        gpu = self.contract == "gpu"
        n_strata, samples = (4, 16) if gpu else (1, 1)

        passes = max(1, cfg.samples_per_px)
        window, dispatches = dispatch_plan(
            tcfg, passes, n_spp, progress is not None or cancel is not None or bool(self.checkpoint_path))
        per_dispatch = n_spp * window
        update_every = max(1, dispatches // 10)
        total_passes = dispatches * per_dispatch

        # checkpoint / resume (JAX mesh.py:244-263): loaded on rank (0, 0) and broadcast
        digest = None
        start_dispatch = 0
        accum_blk = None
        if self.checkpoint_path:
            digest = (ckpt_mod.scene_digest(sc, cfg, self.contract, self.normalize_pass, samples)
                      + f":mesh{n_px}x{n_spp}w{window}")
            head = torch.zeros(2, dtype=torch.int64, device=dev)  # resumable, passes
            full = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
            if lead:
                ck = ckpt_mod.load_checkpoint(self.checkpoint_path, keep=self.checkpoint_keep)
                if (
                    ck is not None
                    and ck.compatible_with(digest)
                    and ck.seed == self.seed
                    and ck.accum.shape == (n_pad, 3)
                    and ck.passes % per_dispatch == 0
                    and ck.passes < total_passes
                ):
                    head[0], head[1] = 1, ck.passes
                    full.copy_(torch.from_numpy(ck.accum))
            _mesh_broadcast(head, mesh)
            if int(head[0]):
                _mesh_broadcast(full, mesh)
                accum_blk = full[ip * block:(ip + 1) * block].clone()
                start_dispatch = int(head[1]) // per_dispatch
        if accum_blk is None:
            accum_blk = torch.zeros((block, 3), dtype=torch.float32, device=dev)
        total_segs = torch.zeros(1, dtype=torch.int64, device=dev)

        kw = dict(mesh=mesh, tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
                  has_aperture=has_aperture, normalize_pass=self.normalize_pass, n_pad=n_pad, n_passes=window,
                  chunk=self.chunk)
        full = None  # the gathered accumulator, while it is current
        completed = start_dispatch
        for d in range(start_dispatch, dispatches):
            accum_blk, segs = _sharded_pass(accum_blk, pack, self.seed, d * per_dispatch, **kw)
            total_segs += segs
            completed = d + 1
            full = None
            if ((d % update_every) == update_every - 1 or d == dispatches - 1) and (
                    self.checkpoint_path or progress is not None):
                full = _gather(accum_blk, n_pad, mesh)
                done_passes = completed * per_dispatch
                if lead and self.checkpoint_path:
                    ckpt_mod.save_checkpoint(
                        self.checkpoint_path,
                        ckpt_mod.Checkpoint(accum=full.cpu().numpy(), passes=done_passes, seed=self.seed,
                                            digest=digest, width=w, height=h),
                        keep=self.checkpoint_keep,
                    )
                if lead and progress is not None:
                    progress(done_passes, accum_image(full, w, h, done_passes, gpu, denoise=False).cpu().numpy())
            if cancel is not None:
                stop = torch.tensor([int(lead and bool(cancel()))], dtype=torch.int32, device=dev)
                _mesh_broadcast(stop, mesh)
                if int(stop):
                    break

        done_passes = completed * per_dispatch
        if full is None:
            full = _gather(accum_blk, n_pad, mesh)
        img = accum_image(full, w, h, max(done_passes, 1), gpu, denoise=True).cpu().numpy()
        _mesh_sum(total_segs, mesh)
        self.stats = RenderStats(
            passes=done_passes,
            samples_per_pixel=done_passes * samples,
            ray_segments=int(total_segs),
            wall_seconds=time.perf_counter() - t0,
            nonfinite=int(metrics_mod.nonfinite_count(full)),  # padding lanes too, as the JAX MeshRenderer's
            resumed_from=start_dispatch * per_dispatch,
        )
        return img
