"""The CUDA kernels and their wrappers: CUDA C++ on the card, the plain
PyTorch versions on the CPU.

Counterpart of ``path_trace_golang_tpu/ops/pallas_trace.py``
(``render_pass_pallas`` and ``trace_grid_pallas``) and of the per-lane
paged walk that runs inside them (``ops/bvh.py::_traverse_gather`` /
``_occluded_gather``).

:func:`render_pass` runs one progressive pass, or a window of ``n_passes``
passes, for flat pixel lanes:

* on CUDA tensors it launches the whole-pass kernel (a lane's loop in
  registers, the scene tables in shared memory; for a mesh above 128
  triangles the paged walk of ``csrc/paged_walk.cuh`` over page tiles in
  device memory): for the gpu contract the fog kernel of
  ``csrc/render_pass.cu`` (where the fog is marched once a pass; see
  :func:`fog_pass`) and then its regeneration instance, one launch for all
  the given lanes (with pages, persistent blocks whose threads take lanes
  as they go);
  for the classic loop (the cpu contract, faithful fog, and the gpu
  contract under ``PATHTRACER_NO_REGEN``) the classic instance of
  ``csrc/classic.cu`` on the lanes as one chunk; or it raises;
* on CPU tensors it runs :func:`render_pass_plain`, the torch
  ``render.pass_body_grid``, which the kernel is held to.

:func:`classic_render` runs the classic instance as the Renderer launches
it on the card: a window of passes over all of a frame's lanes in chunks,
added into the Renderer's accumulator (under the cpu contract one launch a
window, else two launches a sample over all chunks); on CPU
tensors its plain version, ``pass_body_grid`` pass by pass and chunk by
chunk.

:func:`trace_grid` traces given rays with the classic loop: kernel B3 of
``csrc/classic.cu`` on CUDA tensors, the torch ``integrator._trace_cpu`` /
``_trace_gpu`` on CPU tensors.

:func:`paged_traverse` and :func:`paged_occluded` run the paged walk alone
for given rays: on CUDA tensors the same device functions through their
own entry point, on CPU tensors ``ops/bvh.py``'s plain versions.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` beside the package, one library for each source
(``render_pass``, ``classic``; ``probes``, the perf probes, and ``repro``,
the Mosaic repros, whose entry points ``ops/probes.py`` and ``ops/repro.py``
bind), and bound with ``ctypes``.  Besides the shipped build each source
has its counting build (``-DPT_COUNT_OPS``, the bounds and splits) and, for
a render whose config sets a profiling knob (``PATHTRACER_PROF_NO_MESH_*``,
``PATHTRACER_NO_WALK_SKIP``), a profiling build of the render libraries with
the knobs as the macro ``PT_PROF`` (:func:`prof_bits`), compiled at its
first use; a config that sets none runs the shipped build.  ``LAUNCHES``
counts launches of the whole-pass kernel, ``PAGED_LAUNCHES`` those of them
that carried pages (the walk ran inside them), ``CLASSIC_LAUNCHES`` those of
them of the classic instance, ``FOG_LAUNCHES`` launches of the fog kernel,
``MARCH_LAUNCHES`` those of the classic instance's march kernel (faithful
fog: the first of a sample's two launches; ``CLASSIC_LAUNCHES`` counts the
second), ``TRACE_LAUNCHES`` calls that launched kernel B3, ``WALK_LAUNCHES``
launches of the walk alone; ``PLAIN_CALLS``, ``FOG_PLAIN_CALLS``,
``TRACE_PLAIN_CALLS`` and ``WALK_PLAIN_CALLS`` count calls of the plain
versions.  A library's first load in a render is its span ``kernels.load``,
the build inside it ``kernels.build``, which the render's ``kernel_builds``
counts.  The camera basis and the scene arguments of a frame size are made
once a pack, which the render's ``camera_basis_builds`` counts: a window's
host work is its launches and their output buffers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..soa import ScenePack
from ..utils.metrics import count, span
from . import bvh as bvh_mod
from ._launch import raise_on
from .camera import camera_basis
from .rng import MASK32
from .vec import V3

__all__ = [
    "render_pass", "render_pass_plain", "render_pass_cuda", "count_ops", "count_ops_split", "build",
    "fog_pass", "fog_count_ops", "b1_split", "split_line", "classic_split", "classic_split_line", "trace_split",
    "trace_split_line", "march_split",
    "march_split_line", "N_COUNTERS",
    "classic_render", "classic_render_plain", "classic_render_cuda", "classic_count_split",
    "trace_grid", "trace_grid_plain", "trace_grid_cuda", "trace_count_ops",
    "paged_traverse", "paged_occluded", "paged_count_ops", "paged_count_split", "prof_bits",
    "LAUNCHES", "FOG_LAUNCHES", "MARCH_LAUNCHES", "PAGED_LAUNCHES", "CLASSIC_LAUNCHES", "TRACE_LAUNCHES",
    "WALK_LAUNCHES",
    "PLAIN_CALLS", "FOG_PLAIN_CALLS", "TRACE_PLAIN_CALLS", "WALK_PLAIN_CALLS",
]

LAUNCHES = 0
FOG_LAUNCHES = 0
MARCH_LAUNCHES = 0
PAGED_LAUNCHES = 0
CLASSIC_LAUNCHES = 0
TRACE_LAUNCHES = 0
WALK_LAUNCHES = 0
PLAIN_CALLS = 0
FOG_PLAIN_CALLS = 0
TRACE_PLAIN_CALLS = 0
WALK_PLAIN_CALLS = 0
BUILD_LOG: dict = {}  # source name -> nvcc's -Xptxas -v report of its last normal build

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"render_pass": CSRC / "render_pass.cu", "classic": CSRC / "classic.cu", "probes": CSRC / "probes.cu",
           "repro": CSRC / "repro.cu"}
HEADERS = (CSRC / "common.cuh", CSRC / "paged_walk.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# flag bits (must match csrc/common.cuh)
FLAG_APERTURE, FLAG_LENS_DISK, FLAG_ROUGH_METAL, FLAG_DIELECTRIC = 1, 2, 4, 8
FLAG_FOG_ONCE, FLAG_NORMALIZE, FLAG_NEE, FLAG_TRI_EMISSIVE = 16, 32, 64, 128
FLAG_CPU, FLAG_FOG_TRACE = 256, 512
# PATHTRACER_BVH_DROP's walks (integrator.TraceConfig.debug_drop), skipped on a paged mesh
FLAG_DROP = {"closest": 1024, "shadow": 2048, "spec": 4096}
# the profiling build's PT_PROF bits (must match csrc/common.cuh): TraceConfig.prof_no_mesh's queries, and
# PATHTRACER_NO_WALK_SKIP (TraceConfig.walk_skip off)
PROF_BITS = {"hit": 1, "lite": 2, "occl": 4}
PROF_WALK_ALL = 8

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")


def prof_bits(tcfg) -> int:
    """The profiling build that a config runs: its PT_PROF bits, 0 for the shipped build."""
    return sum(PROF_BITS[k] for k in tcfg.prof_no_mesh) | (0 if tcfg.walk_skip else PROF_WALK_ALL)


def build(count_ops: bool = False, source: str = "render_pass", prof: int = 0) -> Path:
    """Compile one source (once per source and flag set) and return the .so
    path.  ``count_ops`` builds the operation-counting variant
    (-DPT_COUNT_OPS), used only to compute the kernels' bounds and B1's
    split; ``prof`` the profiling build of :func:`prof_bits`'s bits
    (-DPT_PROF=bits).  Builds of other sources or variants may run at the
    same time from other threads; a build that fails raises."""
    flags = NVCC_FLAGS + (("-DPT_COUNT_OPS",) if count_ops else ()) + ((f"-DPT_PROF={prof}",) if prof else ())
    src = SOURCES[source].read_bytes() + b"".join(h.read_bytes() for h in HEADERS)
    tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"{source}_{'count_' if count_ops else ''}{f'prof{prof}_' if prof else ''}{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *flags, "-o", tmp, str(SOURCES[source])]
    with span("kernels.build"):
        res = subprocess.run(cmd, capture_output=True, text=True)
    count("kernel_builds")
    log = res.stdout + res.stderr
    if not count_ops and not prof:
        BUILD_LOG[source] = log
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n{log}")
    os.replace(tmp, so)
    return so


# ctypes argument types of the scene arguments that every entry point takes first
_P, _I = ctypes.c_void_p, ctypes.c_int
_SCENE_ARGTYPES = [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I]


def _lib(count_ops: bool = False, source: str = "render_pass", prof: int = 0):
    key = (count_ops, source, prof)
    if key not in _LIBS:
        with span("kernels.load"):
            lib = ctypes.CDLL(str(build(count_ops, source, prof)))
            p, i, u = _P, _I, ctypes.c_uint
            if source == "render_pass":
                lib.pt_render_pass.argtypes = _SCENE_ARGTYPES + [p, p, i, u, i, i, i, i, i, i, i, i, p, p, p, p]
                lib.pt_render_pass.restype = i
                lib.pt_fog_pass.argtypes = _SCENE_ARGTYPES + [p, p, i, u, i, i, i, i, i, p, p, p]
                lib.pt_fog_pass.restype = i
                lib.pt_paged_walk.argtypes = [p, p, i, i, p, p, p, i, ctypes.c_float, i, p, p, p, p, p]
                lib.pt_paged_walk.restype = i
            elif source == "classic":
                lib.pt_trace_grid.argtypes = _SCENE_ARGTYPES + [p, p, p, i, p, p, p, i, p, p, i, i, i, i, p, i, i,
                                                                p, p, p, p, p, p]
                lib.pt_trace_grid.restype = i
                lib.pt_classic_window.argtypes = _SCENE_ARGTYPES + [p, p, i, u, i, i, i, i, i, i, i, p, p, p]
                lib.pt_classic_window.restype = i
                lib.pt_classic_samples.argtypes = _SCENE_ARGTYPES + [p, p, i, i, u, i, i, i, i, i, i, i, i, i,
                                                                     p, p, p, p, p, p, p, p, p]
                lib.pt_classic_samples.restype = i
            lib.pt_error_string.argtypes = [i]
            lib.pt_error_string.restype = ctypes.c_char_p
            _LIBS[key] = lib
    return _LIBS[key]


def _device_tables(pack: ScenePack):
    """The kernel's int32 tables (light list, BVH topology), cached on the pack."""
    key = "_cuda_tables"
    if key not in pack._host:
        dev = pack.device
        topo = pack.bvh
        if topo is None:
            topo_t = torch.zeros(1, dtype=torch.int32, device=dev)
            n_nodes = 0
        else:
            flat = list(topo.miss) + list(topo.first) + list(topo.count)
            topo_t = torch.tensor(flat, dtype=torch.int32, device=dev)
            n_nodes = topo.n_nodes
        lights = torch.tensor(list(pack.light_objs) or [0], dtype=torch.int32, device=dev)
        tri_rows = pack.tri.shape[0] if n_nodes else 0
        pack._host[key] = (lights, topo_t, n_nodes, tri_rows)
    return pack._host[key]


def render_pass(pack: ScenePack, frame_seed: int, px, py, **kw):
    """One pass window for flat lanes ``px``/``py`` (int32).

    Keyword arguments as :func:`render_pass_plain`.  Returns
    (col V3 of f32[N], segments int64 0-d tensor).  CUDA tensors go to the
    kernel, CPU tensors to the plain version; nothing falls back.
    """
    if px.is_cuda:
        return render_pass_cuda(pack, frame_seed, px, py, **kw)
    if px.device.type == "cpu":
        return render_pass_plain(pack, frame_seed, px, py, **kw)
    raise NotImplementedError(f"render_pass: no kernel for device {px.device}")


def render_pass_plain(pack: ScenePack, frame_seed: int, px, py, **kw):
    """The plain version: the torch ``render.pass_body_grid``."""
    global PLAIN_CALLS
    from ..render import pass_body_grid

    PLAIN_CALLS += 1
    return pass_body_grid(pack, frame_seed, px, py, **kw)


def render_pass_cuda(
    pack: ScenePack,
    frame_seed: int,
    px,
    py,
    *,
    tcfg,
    width: int,
    height: int,
    n_strata: int,
    samples: int,
    has_aperture: bool,
    normalize_pass: bool,
    n_passes: int = 1,
    fog_terms=None,
):
    """Launch the whole-pass kernel on the current stream: the fog kernel
    (where the fog is marched once a pass) and the regeneration instance, or
    the classic instance (:func:`classic_render_cuda` on the lanes as one
    chunk, into a zeroed accumulator).  ``fog_terms``: the window's terms
    from :func:`fog_pass` on the same lanes, which the call then does not
    march again."""
    global LAUNCHES, PAGED_LAUNCHES, FOG_LAUNCHES
    kw = dict(tcfg=tcfg, width=width, height=height, n_strata=n_strata, samples=samples,
              has_aperture=has_aperture, normalize_pass=normalize_pass)
    if not _regen(tcfg):
        accum = _classic_accum(px, n_passes, fog_terms)
        segs = classic_render_cuda(accum, pack, frame_seed, px, py, chunk=px.numel(), **kw)
        return V3(accum[:, 0], accum[:, 1], accum[:, 2]), segs
    col, counters, fog_counters = _launch(False, pack, frame_seed, px, py, n_passes=n_passes, fog_terms=fog_terms,
                                          **kw)
    LAUNCHES += 1
    if pack.paged is not None:
        PAGED_LAUNCHES += 1
    FOG_LAUNCHES += fog_counters is not None
    return col, counters[0]


def count_ops(pack: ScenePack, frame_seed: int, px, py, **kw):
    """Run the operation-counting build of the kernel on the same inputs.

    Returns (segments, f32 operations) as Python ints: the work that these
    inputs need, tallied by the kernel's own code (csrc/common.cuh).
    Not a launch of the render path: ``LAUNCHES`` does not change."""
    counts = count_ops_split(pack, frame_seed, px, py, **kw)
    return counts["segments"], counts["ops"]


# the counters of a launch (csrc/common.cuh): [0] segments, the counting
# build's tallies after it, the lane cursor at 35, the warp sweep's counts of
# the walk alone after it (paged_count_split)
N_COUNTERS = 42
_COUNT_NAMES = (
    "segments", "ops", "walk_ops", "walk_cycles", "cycles",
    "fog_cycles", "isect_cycles", "nee_cycles", "lite_cycles", "loop_cycles",
    "nee_active", "nee_entries", "warp_tail_cycles", "rng_rounds",
)
# counters[21..33]: the fog march's split
_MARCH_NAMES = (
    "march_hit_cycles", "march_noise_cycles", "march_light_cycles", "march_shadow_cycles",
    "shadow_lanes", "shadow_active", "shadow_entries", "shadow_blocked", "shadow_prims", "shadow_nodes",
    "sin_calls", "sin_large", "march_tail_cycles",
)
_U64 = (1 << 64) - 1


def _count_dict(counters) -> dict:
    vals = [int(c) & _U64 for c in counters.cpu()]
    out = dict(zip(_COUNT_NAMES, vals))
    # the launch's first block start and first block end are kept bit-inverted (atomicMax keeps the least)
    out["first_start_ns"], out["first_end_ns"], out["last_end_ns"] = _U64 ^ vals[14], _U64 ^ vals[15], vals[16]
    out["last_start_ns"] = vals[17]
    out["advance_cycles"], out["camera_cycles"], out["warp_segments"] = vals[18], vals[19], vals[20]
    out.update(zip(_MARCH_NAMES, vals[21:34]))
    out["advance_rounds"] = vals[34]
    return out


def _launch_spans(c: dict):
    """(block ends' spread, span, drain) in ns of one launch's dict, or the
    sums that :func:`_merge_counts` kept for several."""
    if "launch_span_ns" in c:
        return c["launch_tail_ns"], c["launch_span_ns"], c["launch_drain_ns"]
    return (c["last_end_ns"] - c["first_end_ns"], c["last_end_ns"] - c["first_start_ns"],
            c["last_end_ns"] - c["last_start_ns"])


def _merge_counts(counted) -> dict:
    """The dicts of several launches as one: tallies summed, and each
    launch's block-time spans summed (``launch_tail_ns``, ``launch_span_ns``,
    ``launch_drain_ns``) with the number of ``launches``."""
    out = {k: sum(c[k] for c in counted) for k in counted[0] if not k.endswith("_ns")}
    spans = [_launch_spans(c) for c in counted]
    out["launch_tail_ns"], out["launch_span_ns"], out["launch_drain_ns"] = (sum(x) for x in zip(*spans))
    out["launches"] = len(counted)
    return out


def count_ops_split(pack: ScenePack, frame_seed: int, px, py, **kw) -> dict:
    """As :func:`count_ops`, with the split that the counting build tallies
    (csrc/common.cuh): ``segments``, ``ops``, ``walk_ops`` (the f32
    operations done inside the paged walk), ``walk_cycles`` and ``cycles``
    (clock cycles, summed over lanes, spent inside the walk and in all; a
    lane that waits for its warp inside the walk counts as inside); under
    the regeneration instance also the lane cycles of its stages
    (``fog_cycles``, ``isect_cycles`` for the closest hit of a bounce,
    ``nee_cycles`` for next-event estimation, ``lite_cycles`` for the
    specular-NEE ray, ``loop_cycles`` for the whole merged loop),
    ``nee_active`` and ``nee_entries`` (the lanes of a warp that enter NEE
    together, summed, and the number of such entries), ``warp_tail_cycles``,
    ``rng_rounds`` (rounds of the hash) and the launch's block times in ns
    (``first_start_ns``, ``first_end_ns``, ``last_end_ns``, ``last_start_ns``);
    under the classic instance also ``advance_cycles`` and ``camera_cycles``
    (its state advance, its jitter and camera ray), the march's cycles in
    ``fog_cycles``, and its launches' dicts merged
    (:func:`classic_count_split` on the lanes as one chunk); ``warp_segments`` counts the
    segments that the warps' loops ran for (32 times a warp's busiest
    thread's).  The fog march's own tallies (``march_*``, ``shadow_*``,
    ``sin_*``; :func:`march_split`) are those of the fog kernel under
    ``"fog"`` (None where the call marched no fog once a pass) and, under
    the classic instance, of the march kernel under ``"march"``."""
    if not _regen(kw["tcfg"]):
        accum = _classic_accum(px, kw.pop("n_passes", 1), kw.pop("fog_terms", None))
        return classic_count_split(accum, pack, frame_seed, px, py, chunk=px.numel(), **kw)
    _col, counters, fog_counters = _launch(True, pack, frame_seed, px, py, **kw)
    out = _count_dict(counters)
    out["fog"] = None if fog_counters is None else _count_dict(fog_counters)
    return out


PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores, 700 W
HASH_ROUND_SLOTS = 16.0  # FFMA slots a round of the RNG's hash costs (probe T1, PERF.md)
UNFUSED_SLOTS = 32.79e12  # FFMA slots a second of code built with --fmad=false (probe T1 ffma, full card)


def b1_split(counted) -> dict:
    """B1's split from :func:`count_ops_split`'s dicts of one frame's
    regeneration launches (one a launch): the lane cycles of each stage as
    shares of B1's (the fog kernel's own lanes' cycles against B1's), the
    NEE active-lane share, the warp tail, the launch tail (last block end
    less first block end, against the launch's span, summed over launches),
    the hash rounds and both bounds (f32 operations at 67 TFLOP/s;
    operations and hash rounds as FFMA slots at the unfused rate)."""
    tot = {k: sum(c[k] for c in counted) for k in counted[0] if not k.endswith("_ns") and k != "fog"}
    cyc = max(tot["cycles"], 1)
    inner = tot["isect_cycles"] + tot["nee_cycles"] + tot["lite_cycles"]
    spread, span, drain = (sum(x) for x in zip(*(_launch_spans(c) for c in counted)))
    slots = tot["ops"] + HASH_ROUND_SLOTS * tot["rng_rounds"]
    return {
        "launches": sum(c.get("launches", 1) for c in counted),
        "share_fog": tot["fog_cycles"] / cyc,
        "share_isect": tot["isect_cycles"] / cyc,
        "share_nee": tot["nee_cycles"] / cyc,
        "share_lite": tot["lite_cycles"] / cyc,
        "share_rest": (tot["loop_cycles"] - inner - tot["warp_tail_cycles"]) / cyc,
        "share_warp_tail": tot["warp_tail_cycles"] / cyc,
        "share_outside": (cyc - tot["loop_cycles"]) / cyc,
        "nee_active_share": tot["nee_active"] / max(32 * tot["nee_entries"], 1),
        "nee_entries": tot["nee_entries"],
        "launch_tail_ns": spread,
        "launch_drain_ns": drain,
        "launch_span_ns": span,
        "launch_tail_share": spread / max(span, 1),
        "rng_rounds": tot["rng_rounds"],
        "rng_rounds_per_segment": tot["rng_rounds"] / max(tot["segments"], 1),
        "ops": tot["ops"],
        "ops_per_segment": tot["ops"] / max(tot["segments"], 1),
        "segments": tot["segments"],
        "bound_ops_ms": tot["ops"] / PEAK_F32_FLOPS * 1e3,
        "bound_slots_ms": slots / UNFUSED_SLOTS * 1e3,
        "ffma_slots": slots,
    }


def split_line(sp: dict) -> str:
    """One line of :func:`b1_split`'s numbers."""
    return (
        f"lane cycles: fog prepass {sp['share_fog']:.2%} (its own launch, against B1's cycles), closest hit "
        f"{sp['share_isect']:.2%}, NEE {sp['share_nee']:.2%}, specular-NEE ray {sp['share_lite']:.2%}, rest of "
        f"shading and roulette {sp['share_rest']:.2%}, warp tail {sp['share_warp_tail']:.2%}, outside the loop "
        f"{sp['share_outside']:.2%}; NEE active-lane share {sp['nee_active_share']:.2%} over "
        f"{sp['nee_entries']} warp entries; block ends spread over {sp['launch_tail_ns'] / 1e6:.3f} ms of the "
        f"launches' {sp['launch_span_ns'] / 1e6:.3f} ms ({sp['launch_tail_share']:.2%}, {sp['launches']} launches), "
        f"{sp['launch_drain_ns'] / 1e6:.3f} ms from the last block start to the last end; "
        f"{sp['rng_rounds']:.6g} hash rounds ({sp['rng_rounds_per_segment']:.1f} a segment, "
        f"{HASH_ROUND_SLOTS * sp['rng_rounds_per_segment']:.0f} FFMA slots beside {sp['ops_per_segment']:.1f} "
        f"counted operations); bound {sp['bound_ops_ms']:.4f} ms (f32 operations at 67 TFLOP/s), "
        f"{sp['bound_slots_ms']:.4f} ms (operations and hash rounds as FFMA slots at 32.79 Tslots/s)"
    )


def classic_split(counted) -> dict:
    """The classic instance's split from :func:`count_ops_split`'s dicts of
    one frame's calls: the lane cycles of each stage as shares of all (the
    state advance, jitter + camera ray, the in-trace fog march, closest hit,
    NEE and the specular-NEE ray, the rest of shading and roulette, the warp
    tail), the segments the warps ran for against those traced (``simt``),
    the launch tail, the hash rounds and both bounds."""
    tot = {k: sum(c[k] for c in counted)
           for k in _COUNT_NAMES + ("advance_cycles", "camera_cycles", "warp_segments")}
    cyc = max(tot["cycles"], 1)
    inner = tot["isect_cycles"] + tot["nee_cycles"] + tot["lite_cycles"] + tot["warp_tail_cycles"]
    spread, span, drain = (sum(x) for x in zip(*(_launch_spans(c) for c in counted)))
    slots = tot["ops"] + HASH_ROUND_SLOTS * tot["rng_rounds"]
    staged = tot["advance_cycles"] + tot["camera_cycles"] + tot["fog_cycles"] + tot["loop_cycles"]
    return {
        "launches": sum(c.get("launches", 1) for c in counted),
        "share_advance": tot["advance_cycles"] / cyc,
        "share_camera": tot["camera_cycles"] / cyc,
        "share_march": tot["fog_cycles"] / cyc,
        "share_isect": tot["isect_cycles"] / cyc,
        "share_nee": tot["nee_cycles"] / cyc,
        "share_lite": tot["lite_cycles"] / cyc,
        "share_rest": (tot["loop_cycles"] - inner) / cyc,
        "share_warp_tail": tot["warp_tail_cycles"] / cyc,
        "share_outside": (cyc - staged) / cyc,
        "simt": tot["segments"] / max(tot["warp_segments"], 1),
        "launch_tail_ns": spread,
        "launch_drain_ns": drain,
        "launch_span_ns": span,
        "launch_tail_share": spread / max(span, 1),
        "rng_rounds": tot["rng_rounds"],
        "rng_rounds_per_segment": tot["rng_rounds"] / max(tot["segments"], 1),
        "ops": tot["ops"],
        "ops_per_segment": tot["ops"] / max(tot["segments"], 1),
        "segments": tot["segments"],
        "bound_ops_ms": tot["ops"] / PEAK_F32_FLOPS * 1e3,
        "bound_slots_ms": slots / UNFUSED_SLOTS * 1e3,
        "ffma_slots": slots,
    }


def classic_split_line(sp: dict) -> str:
    """One line of :func:`classic_split`'s numbers."""
    return (
        f"lane cycles: state advance {sp['share_advance']:.2%}, jitter + camera {sp['share_camera']:.2%}, fog march "
        f"{sp['share_march']:.2%}, closest hit {sp['share_isect']:.2%}, NEE {sp['share_nee']:.2%}, specular-NEE ray "
        f"{sp['share_lite']:.2%}, rest of shading and roulette {sp['share_rest']:.2%}, warp tail "
        f"{sp['share_warp_tail']:.2%}, outside {sp['share_outside']:.2%}; segments traced / segments the warps ran "
        f"for {sp['simt']:.2%}; block ends spread over {sp['launch_tail_ns'] / 1e6:.3f} ms of the launches' "
        f"{sp['launch_span_ns'] / 1e6:.3f} ms ({sp['launch_tail_share']:.2%}, {sp['launches']} launches), "
        f"{sp['launch_drain_ns'] / 1e6:.3f} ms from the last block start to the last end; "
        f"{sp['rng_rounds']:.6g} hash rounds ({sp['rng_rounds_per_segment']:.1f} a segment, "
        f"{HASH_ROUND_SLOTS * sp['rng_rounds_per_segment']:.0f} FFMA slots beside {sp['ops_per_segment']:.1f} "
        f"counted operations); bound {sp['bound_ops_ms']:.4f} ms (f32 operations at 67 TFLOP/s), "
        f"{sp['bound_slots_ms']:.4f} ms (operations and hash rounds as FFMA slots at 32.79 Tslots/s)"
    )


def trace_split(counted) -> dict:
    """Kernel B3's split from :func:`trace_count_ops`'s dicts of its calls:
    :func:`classic_split`'s numbers, with the lane time taken as the
    threads' cycles and their warp tail, and the rest of shading as the
    loop less closest hit and NEE (B3's bounces run in persistent blocks: a
    thread waits for its warp after its last ray, outside its loop and
    after its cycles were read); the march launch's cycles under
    ``share_march``; and the hash rounds of the state advance
    (``advance_kernel``: the quotas of the call's other trips) apart from
    the trace's own."""
    sp = classic_split(counted)
    tot = {k: sum(c[k] for c in counted) for k in ("cycles", "fog_cycles", "isect_cycles", "nee_cycles",
                                                  "lite_cycles", "loop_cycles", "warp_tail_cycles")}
    lane = max(tot["cycles"] + tot["warp_tail_cycles"], 1)
    inner = tot["isect_cycles"] + tot["nee_cycles"] + tot["lite_cycles"]
    sp.update(share_advance=0.0, share_camera=0.0, share_march=tot["fog_cycles"] / lane,
              share_isect=tot["isect_cycles"] / lane, share_nee=tot["nee_cycles"] / lane,
              share_lite=tot["lite_cycles"] / lane, share_rest=(tot["loop_cycles"] - inner) / lane,
              share_warp_tail=tot["warp_tail_cycles"] / lane,
              share_outside=(tot["cycles"] - tot["fog_cycles"] - tot["loop_cycles"]) / lane)
    adv = sum(c["advance_rounds"] for c in counted)
    sp["rng_rounds_advance"] = adv
    sp["rng_rounds_trace"] = sp["rng_rounds"] - adv
    sp["advance_round_share"] = adv / max(sp["rng_rounds"], 1)
    return sp


def trace_split_line(sp: dict) -> str:
    """One line of :func:`trace_split`'s numbers."""
    return (f"{classic_split_line(sp)}; of the hash rounds {sp['rng_rounds_trace']:.6g} in the trace, "
            f"{sp['rng_rounds_advance']:.6g} in the state advance ({sp['advance_round_share']:.2%})")


def march_split(counted) -> dict:
    """The fog march's split from the counting build's dicts of its
    launches (the fog kernel's, or the classic instance's march kernel's):
    the lane cycles of each stage as shares of the launches' (the primary
    hit, the noise with its sinf, light sampling, the shadow tests, the
    march's warp tail, the classic march kernel's state advance and camera
    ray, and the rest: jitter, camera ray, steps, transmittance, sums,
    stores); the share of the lanes present at a light's shadow test that
    run it, and of the lanes of the warp iterations that run one; the share
    of tests that come back blocked, the objects and triangles and the BVH
    nodes a test visits; the share of sinf arguments past 105,615; the
    launch tail; the hash rounds and both bounds."""
    tot = {k: sum(c[k] for c in counted)
           for k in _COUNT_NAMES + _MARCH_NAMES + ("advance_cycles", "camera_cycles")}
    cyc = max(tot["cycles"], 1)
    tests = max(tot["shadow_active"], 1)
    staged = (tot["march_hit_cycles"] + tot["march_noise_cycles"] + tot["march_light_cycles"]
              + tot["march_tail_cycles"] + tot["advance_cycles"] + tot["camera_cycles"])
    spread, span, drain = (sum(x) for x in zip(*(_launch_spans(c) for c in counted)))
    slots = tot["ops"] + HASH_ROUND_SLOTS * tot["rng_rounds"]
    return {
        "launches": sum(c.get("launches", 1) for c in counted),
        "share_hit": tot["march_hit_cycles"] / cyc,
        "share_noise": tot["march_noise_cycles"] / cyc,
        "share_light": (tot["march_light_cycles"] - tot["march_shadow_cycles"]) / cyc,
        "share_shadow": tot["march_shadow_cycles"] / cyc,
        "share_tail": tot["march_tail_cycles"] / cyc,
        "share_advance_camera": (tot["advance_cycles"] + tot["camera_cycles"]) / cyc,
        "share_rest": (cyc - staged) / cyc,
        "shadow_tests": tot["shadow_active"],
        "shadow_lane_share": tot["shadow_active"] / max(tot["shadow_lanes"], 1),
        "shadow_warp_share": tot["shadow_active"] / max(32 * tot["shadow_entries"], 1),
        "shadow_blocked_share": tot["shadow_blocked"] / tests,
        "prims_per_test": tot["shadow_prims"] / tests,
        "nodes_per_test": tot["shadow_nodes"] / tests,
        "sin_calls": tot["sin_calls"],
        "sin_large_share": tot["sin_large"] / max(tot["sin_calls"], 1),
        "launch_tail_ns": spread,
        "launch_drain_ns": drain,
        "launch_span_ns": span,
        "launch_tail_share": spread / max(span, 1),
        "rng_rounds": tot["rng_rounds"],
        "ops": tot["ops"],
        "bound_ops_ms": tot["ops"] / PEAK_F32_FLOPS * 1e3,
        "bound_slots_ms": slots / UNFUSED_SLOTS * 1e3,
        "ffma_slots": slots,
    }


def march_split_line(sp: dict) -> str:
    """One line of :func:`march_split`'s numbers."""
    return (
        f"lane cycles: primary hit {sp['share_hit']:.2%}, noise {sp['share_noise']:.2%}, light sampling "
        f"{sp['share_light']:.2%}, shadow tests {sp['share_shadow']:.2%}, march warp tail {sp['share_tail']:.2%}, "
        f"state advance + camera {sp['share_advance_camera']:.2%}, rest {sp['share_rest']:.2%}; "
        f"{sp['shadow_tests']:.6g} shadow tests: {sp['shadow_lane_share']:.2%} of the lanes present at a light's "
        f"test run it, {sp['shadow_warp_share']:.2%} of the lanes of the warp iterations that run one, "
        f"{sp['shadow_blocked_share']:.2%} come back blocked, {sp['prims_per_test']:.2f} objects and triangles and "
        f"{sp['nodes_per_test']:.2f} BVH nodes visited a test; {sp['sin_calls']:.6g} sinf calls, "
        f"{sp['sin_large_share']:.4%} past |x| = 105,615; block ends spread over {sp['launch_tail_ns'] / 1e6:.3f} ms "
        f"of the launches' {sp['launch_span_ns'] / 1e6:.3f} ms ({sp['launch_tail_share']:.2%}, {sp['launches']} "
        f"launches), {sp['launch_drain_ns'] / 1e6:.3f} ms from the last block start to the last end; "
        f"{sp['rng_rounds']:.6g} hash rounds; bound {sp['bound_ops_ms']:.4f} ms (f32 operations at 67 TFLOP/s), "
        f"{sp['bound_slots_ms']:.4f} ms (operations and hash rounds as FFMA slots at 32.79 Tslots/s)"
    )


def _regen(tcfg) -> bool:
    from ..integrator import regen_enabled

    return regen_enabled(tcfg)


def _check_device(what: str, pack: ScenePack, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel needs CUDA tensors, got {dev}")
    if pack.device != dev or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: the pack and every tensor must be on one device")
    if "_tables_checked" not in pack._host:  # once a pack: its tables do not change
        tables = [pack.mat, pack.obj, pack.sky, pack.fog, pack.tri, pack.bvh_bounds, pack.page_tiles,
                  pack.page_boxes]
        if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tables):
            raise ValueError(f"{what}: scene tables must be contiguous float32")
        pack._host["_tables_checked"] = True
    return dev


def _scene_args(pack: ScenePack, basis):
    """The scene arguments that every entry point takes first (PT_SCENE_PARAMS)."""
    lights, topo, n_nodes, tri_rows = _device_tables(pack)
    n_pages, n_sub = (pack.paged.n_pages, pack.page_boxes.shape[1]) if pack.paged is not None else (0, 0)
    return [
        pack.mat.data_ptr(), pack.mat.shape[0], pack.obj.data_ptr(), pack.n_objects,
        lights.data_ptr(), pack.n_lights, pack.sky.data_ptr(), pack.fog.data_ptr(),
        pack.tri.data_ptr(), tri_rows, pack.bvh_bounds.data_ptr(), topo.data_ptr(), n_nodes,
        basis.data_ptr(), pack.page_tiles.data_ptr(), pack.page_boxes.data_ptr(), n_pages, n_sub,
    ]


def _camera_scene_args(pack: ScenePack, width: int, height: int):
    """The scene arguments with the camera basis of a frame size, made once
    a pack and frame size (each build counted in ``camera_basis_builds``):
    every window of a render, its fog kernel, B1 and the classic instance,
    launches with the same basis."""
    key = ("_camera_args", width, height)
    if key not in pack._host:
        basis = camera_basis(pack.cam, width, height).contiguous()
        pack._host[key] = (basis, _scene_args(pack, basis))
        count("camera_basis_builds")
    return pack._host[key][1]


def _flags(pack: ScenePack, tcfg, has_aperture=False, normalize_pass=False) -> int:
    return (
        (FLAG_APERTURE if has_aperture else 0)
        | (FLAG_LENS_DISK if pack.lens_disk else 0)
        | (FLAG_ROUGH_METAL if tcfg.has_rough_metal else 0)
        | (FLAG_DIELECTRIC if tcfg.has_dielectric else 0)
        | (FLAG_FOG_ONCE if (tcfg.enable_fog_march and not tcfg.fog_in_trace) else 0)
        | (FLAG_NORMALIZE if normalize_pass else 0)
        | (FLAG_NEE if tcfg.enable_nee else 0)
        | (FLAG_TRI_EMISSIVE if pack.tri_any_emissive else 0)
        | (FLAG_CPU if tcfg.contract == "cpu" else 0)
        | (FLAG_FOG_TRACE if (tcfg.enable_fog_march and tcfg.fog_in_trace) else 0)
        | sum(FLAG_DROP[w] for w in tcfg.debug_drop)
    )


def fog_pass(pack: ScenePack, frame_seed: int, px, py, *, tcfg, width: int, height: int, samples: int,
             has_aperture: bool, n_passes: int = 1, **_kw):
    """The fog-once terms of a pass window for flat lanes ``px``/``py``:
    f32[n_passes, 3, N], each pass's fog estimate on its own counter stream
    times the gate and the pass's samples, which the regeneration loop adds
    to a lane's color in pass order.  CUDA tensors go to the fog kernel
    (``fog_pass_kernel`` of ``csrc/render_pass.cu``), CPU tensors to the
    plain version, the torch ``render.fog_pass_terms``; nothing falls back.
    Other keyword arguments of :func:`render_pass` are taken and ignored."""
    global FOG_LAUNCHES, FOG_PLAIN_CALLS
    if px.is_cuda:
        terms = _launch_fog(False, pack, frame_seed, px, py, tcfg=tcfg, width=width, height=height,
                            samples=samples, has_aperture=has_aperture, n_passes=n_passes)
        FOG_LAUNCHES += 1
        return terms
    if px.device.type == "cpu":
        from ..render import fog_pass_terms

        FOG_PLAIN_CALLS += 1
        terms = fog_pass_terms(pack, frame_seed, px, py, width=width, height=height, samples=samples,
                               has_aperture=has_aperture, n_passes=n_passes, prof=tcfg.prof_no_mesh)
        return torch.stack([torch.stack([t.x, t.y, t.z]) for t in terms])
    raise NotImplementedError(f"fog_pass: no kernel for device {px.device}")


def fog_count_ops(pack: ScenePack, frame_seed: int, px, py, **kw) -> dict:
    """The counting build of the fog kernel alone on the same lanes: its
    tallies as :func:`count_ops_split` names them (``ops``, ``rng_rounds``,
    ``cycles``, ``fog_cycles`` for the terms' own, and the march's split,
    :func:`march_split`).  Not a launch of the render path:
    ``FOG_LAUNCHES`` does not change."""
    counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=px.device)
    args = {k: kw[k] for k in ("tcfg", "width", "height", "samples", "has_aperture")}
    _launch_fog(True, pack, frame_seed, px, py, n_passes=kw.get("n_passes", 1), counters=counters, **args)
    return _count_dict(counters)


def _launch_fog(counting: bool, pack, frame_seed, px, py, *, tcfg, width, height, samples, has_aperture,
                n_passes, counters=None):
    dev = _check_device("fog_pass", pack, px, py)
    flags = _flags(pack, tcfg, has_aperture)
    if not flags & FLAG_FOG_ONCE:
        raise ValueError("fog_pass: the scene's config marches no fog once a pass")
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    n = px.numel()
    terms = torch.empty((n_passes, 3, n), dtype=torch.float32, device=dev)
    if counters is None:
        counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)
    scene = _camera_scene_args(pack, width, height)
    lib = _lib(counting, "render_pass", prof_bits(tcfg))
    err = lib.pt_fog_pass(
        *scene, px.data_ptr(), py.data_ptr(), n, int(frame_seed) & MASK32, width, height,
        samples, n_passes, flags, terms.data_ptr(), counters.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, lib, "fog_pass")
    return terms


def _classic_accum(px, n_passes, fog_terms):
    """The zeroed accumulator of the classic instance run by the
    whole-pass kernel's entry points on ``px``'s lanes as one chunk."""
    if n_passes != 1:
        raise ValueError("n_passes > 1 requires the regeneration loop (gpu contract)")
    if fog_terms is not None:
        raise ValueError("fog_terms belong to the regeneration loop (gpu contract)")
    return torch.zeros((px.numel(), 3), dtype=torch.float32, device=px.device)


def _launch(counting: bool, pack, frame_seed, px, py, *, tcfg, width, height, n_strata, samples,
            has_aperture, normalize_pass, n_passes=1, fog_terms=None):
    """The regeneration instance.  Returns (col V3, the counters, the fog
    kernel's counters where it launched, else None).  The counting build's
    fog kernel tallies into counters of its own, whose operations, hash
    rounds and fog-stage cycles are also added into B1's."""
    dev = _check_device("render_pass_cuda", pack, px, py)
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    n = px.numel()
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)  # segments; the counting build's tallies
    scene = _camera_scene_args(pack, width, height)
    flags = _flags(pack, tcfg, has_aperture, normalize_pass)
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed = int(frame_seed) & MASK32
    lib = _lib(counting, "render_pass", prof_bits(tcfg))
    terms = fog_terms
    if terms is not None and tuple(terms.shape) != (n_passes, 3, n):
        raise ValueError(f"render_pass_cuda: fog_terms must be f32[{n_passes}, 3, {n}]")
    fog_counters = None
    if terms is None and flags & FLAG_FOG_ONCE:
        fog_counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev) if counting else counters
        terms = _launch_fog(counting, pack, frame_seed, px, py, tcfg=tcfg, width=width, height=height,
                            samples=samples, has_aperture=has_aperture, n_passes=n_passes, counters=fog_counters)
        if counting:
            counters[[1, 5, 13]] += fog_counters[[1, 5, 13]]
    err = lib.pt_render_pass(
        *scene, px.data_ptr(), py.data_ptr(), n, seed, width, height, n_strata, samples, n_passes,
        tcfg.max_depth, tcfg.rr_threshold, flags, None if terms is None else terms.data_ptr(),
        out.data_ptr(), counters.data_ptr(), stream,
    )
    raise_on(err, lib, "render_pass")
    return V3(out[0], out[1], out[2]), counters, fog_counters


# ---------------------------------------------------------------------------
# The classic instance on a frame's lanes: a window of passes into the accumulator
# ---------------------------------------------------------------------------

def classic_render(accum, pack: ScenePack, frame_seed: int, px, py, *, chunk: int, n_passes: int = 1, **kw):
    """A window of ``n_passes`` passes of the classic loop (the cpu contract,
    faithful fog, the gpu contract under ``PATHTRACER_NO_REGEN``) for flat
    lanes ``px``/``py`` (int32[N]) in chunks of ``chunk`` lanes, pass p at
    frame seed ``frame_seed + p``, each pass's radiance added into
    ``accum`` (f32[N, 3]) in pass order, as the
    Renderer's ``accum += col``.  A chunk is the set of lanes whose longest
    path advances every lane's state between samples (PHYSICS.md D7).
    Other keyword arguments as :func:`render_pass_plain`.  Returns the
    segments (int64 0-d tensor).  CUDA tensors go to the kernels, CPU
    tensors to :func:`classic_render_plain`; nothing falls back."""
    if px.is_cuda:
        return classic_render_cuda(accum, pack, frame_seed, px, py, chunk=chunk, n_passes=n_passes, **kw)
    if px.device.type == "cpu":
        return classic_render_plain(accum, pack, frame_seed, px, py, chunk=chunk, n_passes=n_passes, **kw)
    raise NotImplementedError(f"classic_render: no kernel for device {px.device}")


def classic_render_plain(accum, pack: ScenePack, frame_seed: int, px, py, *, chunk: int, n_passes: int = 1, **kw):
    """The plain version: ``render.pass_body_grid`` pass by pass and chunk
    by chunk, each pass's colour added into ``accum``."""
    global PLAIN_CALLS
    from ..render import pass_body_grid

    PLAIN_CALLS += 1
    segs = torch.zeros((), dtype=torch.int64, device=px.device)
    for p in range(n_passes):
        for c0 in range(0, px.numel(), chunk):
            col, sg = pass_body_grid(pack, (int(frame_seed) + p) & MASK32, px[c0:c0 + chunk], py[c0:c0 + chunk],
                                     **kw)
            accum[c0:c0 + chunk] += col.to_rows()
            segs = segs + sg
    return segs


def classic_render_cuda(accum, pack: ScenePack, frame_seed: int, px, py, *, chunk: int, n_passes: int = 1, **kw):
    """Launch the classic instance on the current stream: under the cpu
    contract one launch of the window kernel for all the lanes and passes;
    else, pass by pass, two launches a sample over all the lanes (the march
    kernel, which at sample 0 also adds the pass's fog-once estimate where
    the gpu contract marches one, then the sample kernel), each lane
    reading its own chunk's longest paths."""
    global LAUNCHES, PAGED_LAUNCHES, CLASSIC_LAUNCHES, MARCH_LAUNCHES
    _c, _m, launches, march_launches = _launch_classic(False, accum, pack, frame_seed, px, py, chunk=chunk,
                                                       n_passes=n_passes, **kw)
    LAUNCHES += launches
    CLASSIC_LAUNCHES += launches
    MARCH_LAUNCHES += march_launches
    if pack.paged is not None:
        PAGED_LAUNCHES += launches
    return _c[0][0]


def classic_count_split(accum, pack: ScenePack, frame_seed: int, px, py, **kw) -> dict:
    """The counting build of :func:`classic_render_cuda` on the same
    inputs (on a copy of ``accum``): all its launches' tallies merged as in
    :func:`count_ops_split`, and under ``"march"`` those of the march
    kernel's launches alone.  Not a launch of the render path."""
    counted, marched, _n, _m = _launch_classic(True, accum.clone(), pack, frame_seed, px, py, **kw)
    out = _merge_counts([_count_dict(c) for c in counted + marched])
    out["march"] = _merge_counts([_count_dict(c) for c in marched]) if marched else None
    return out


def _launch_classic(counting: bool, accum, pack, frame_seed, px, py, *, chunk, n_passes=1, tcfg, width, height,
                    n_strata, samples, has_aperture, normalize_pass):
    """Returns (the counters of the window or bounce launches: one tensor, or
    in the counting build one a sample, in a list; those of the march
    launches likewise, empty under the cpu contract's window; launches of
    the classic instance; launches of the march)."""
    if _regen(tcfg):  # its plain version would run the regeneration loop: another sample schedule, another image
        raise ValueError("classic_render: the config runs the regeneration loop (render_pass_cuda); "
                         "PATHTRACER_NO_REGEN=1 takes the gpu contract through the classic loop")
    dev = _check_device("classic_render_cuda", pack, px, py, accum)
    n = px.numel()
    if tuple(accum.shape) != (n, 3) or accum.dtype != torch.float32 or not accum.is_contiguous():
        raise ValueError(f"classic_render_cuda: accum must be a contiguous f32[{n}, 3]")
    if int(chunk) < 1 or n_passes < 1:
        raise ValueError("classic_render_cuda: chunk and n_passes must be positive")
    px = px.to(torch.int32).contiguous()
    py = py.to(torch.int32).contiguous()
    scene = _camera_scene_args(pack, width, height)
    flags = _flags(pack, tcfg, has_aperture, normalize_pass)
    stream = torch.cuda.current_stream(dev).cuda_stream
    seed = int(frame_seed) & MASK32
    lib = _lib(counting, "classic", prof_bits(tcfg))
    new = lambda: torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)  # noqa: E731
    counters = [new()]
    if samples == 1 and flags & FLAG_CPU and not flags & FLAG_FOG_ONCE:
        err = lib.pt_classic_window(
            *scene, px.data_ptr(), py.data_ptr(), n, seed, width, height, n_strata, n_passes, tcfg.max_depth,
            tcfg.rr_threshold, flags, accum.data_ptr(), counters[0].data_ptr(), stream,
        )
        raise_on(err, lib, "classic window")
        return counters, [], 1, 0
    # state, path lengths, the running colour, the sample's ray and march, and
    # each chunk's longest paths stay on the card from one launch to the next
    col = torch.empty((3, n), dtype=torch.float32, device=dev)
    rays = torch.empty((9, n), dtype=torch.float32, device=dev)
    state = torch.empty(n, dtype=torch.int32, device=dev)
    lengths = torch.empty(n, dtype=torch.int32, device=dev)
    trips = torch.empty(-(-n // int(chunk)) * samples, dtype=torch.int32, device=dev)
    march = [counters[0]] if not counting else []
    for p in range(n_passes):
        # the counting build gives each sample's two launches their own counters
        for s0, s1 in ([(s, s + 1) for s in range(samples)] if counting else [(0, samples)]):
            if counting:
                march.append(new())
                if p or s0:
                    counters.append(new())
            err = lib.pt_classic_samples(
                *scene, px.data_ptr(), py.data_ptr(), n, int(chunk), (seed + p) & MASK32, width, height, n_strata,
                samples, s0, s1, tcfg.max_depth, tcfg.rr_threshold, flags, col.data_ptr(), rays.data_ptr(),
                state.data_ptr(), lengths.data_ptr(), trips.data_ptr(), accum.data_ptr(), march[-1].data_ptr(),
                counters[-1].data_ptr(), stream,
            )
            raise_on(err, lib, "classic samples")
    return counters, march if counting else [], n_passes * samples, n_passes * samples


# ---------------------------------------------------------------------------
# Kernel B3: the classic loop for given rays
# ---------------------------------------------------------------------------


def trace_grid(orig: V3, dirv: V3, state, pack: ScenePack, cfg, active=None, rows=False):
    """Trace given rays on flat lanes; arguments and result as
    ``integrator.trace_grid`` (with ``rows``, the radiance as f32[N, 3]
    rows, ``trace()``'s layout, instead of a V3).  CUDA tensors go to
    kernel B3, CPU tensors to the plain version; nothing falls back."""
    if orig.x.is_cuda:
        return trace_grid_cuda(orig, dirv, state, pack, cfg, active, rows)
    if orig.x.device.type == "cpu":
        rad, st, segments = trace_grid_plain(orig, dirv, state, pack, cfg, active)
        return (rad.to_rows() if rows else rad), st, segments
    raise NotImplementedError(f"trace_grid: no kernel for device {orig.x.device}")


def trace_grid_plain(orig: V3, dirv: V3, state, pack: ScenePack, cfg, active=None):
    """The plain version: the torch ``integrator._trace_cpu`` / ``_trace_gpu``
    over all the given lanes as one batch."""
    global TRACE_PLAIN_CALLS
    from .. import integrator

    TRACE_PLAIN_CALLS += 1
    trace = integrator._trace_cpu if cfg.contract == "cpu" else integrator._trace_gpu
    return trace(orig, dirv, state.to(torch.int64) & MASK32, pack, cfg, active)


def trace_grid_cuda(orig: V3, dirv: V3, state, pack: ScenePack, cfg, active=None, rows=False):
    """Launch kernel B3 on the current stream: under the in-trace fog march
    the march, then the bounces, then the launch that advances each lane's
    state by the call's other trips."""
    global TRACE_LAUNCHES
    rad, st, counters, _len = _launch_trace(False, orig, dirv, state, pack, cfg, active, rows)
    TRACE_LAUNCHES += 1
    return rad, st, counters[0]


def trace_count_ops(orig: V3, dirv: V3, state, pack: ScenePack, cfg, active=None) -> dict:
    """The counting build of kernel B3 on the same rays: its launches'
    tallies merged as in :func:`count_ops_split` (``segments``, ``ops``,
    ``walk_ops``, ``walk_cycles``, ``cycles``, the lane cycles by stage, the
    hash rounds, ``advance_rounds`` those of the state advance), and under
    ``"march"`` the march launch's own (None where the call marched no fog).
    Not a launch of the trace path: ``TRACE_LAUNCHES`` does not change."""
    lib, args, (_out, _st, _len, counters, keep) = _trace_call(True, orig, dirv, state, pack, cfg, active)
    raise_on(lib.pt_trace_grid(*args), lib, "trace_grid")
    bounce = _count_dict(counters)
    march = _count_dict(keep[0]) if cfg.contract != "cpu" and _flags(pack, cfg) & FLAG_FOG_TRACE else None
    out = _merge_counts([bounce] + ([march] if march else []))
    out["march"] = march
    return out


def _components(v: V3, n: int):
    """The three f32 components of ``v`` as flat lanes and their common
    stride in elements: views where they share one (the columns of an
    [N, 3] row tensor, or contiguous planes), else contiguous copies."""
    cs = [(c if c.dim() == 1 else c.reshape(-1)) for c in v]
    cs = [c if c.dtype == torch.float32 else c.to(torch.float32) for c in cs]
    stride = cs[0].stride(0) if n > 1 else 1
    if any(c.numel() != n or (n > 1 and c.stride(0) != stride) or stride < 1 for c in cs):
        cs, stride = [c.contiguous() for c in cs], 1
    return cs, stride


def _trace_call(counting: bool, orig: V3, dirv: V3, state, pack, cfg, active, rows=False):
    """The inputs and outputs of one call of pt_trace_grid: (library,
    arguments, (radiance: f32[3, n] planes, or [n, 3] rows with ``rows``;
    states int64; path lengths int32; counters; what the pointers need kept
    alive, the march's counters first)).  Made without a launch: the rays
    are read in place (their components' stride), the states as int64 (the
    low 32 bits) and written as int64 values below 2^32, and the call zeroes
    its counters itself."""
    dev = _check_device("trace_grid_cuda", pack, orig.x, dirv.x, state, *(() if active is None else (active,)))
    n = orig.x.numel()
    o, o_stride = _components(orig, n)
    d, d_stride = _components(dirv, n)
    st_in = state if state.dim() == 1 else state.reshape(-1)
    st_in = (st_in if st_in.dtype == torch.int64 else st_in.to(torch.int64)).contiguous()
    act = None
    if active is not None:
        act = active.reshape(-1)
        act = (act.view(torch.uint8) if act.dtype == torch.bool else act.to(torch.uint8)).contiguous()
    out = torch.empty((n, 3) if rows else (3, n), dtype=torch.float32, device=dev)
    out_comp, out_lane = (1, 3) if rows else (n, 1)
    st = torch.empty(n, dtype=torch.int64, device=dev)
    # the counters, the march's counters (the counting build's own), trips and the path lengths in one buffer
    scratch = torch.empty(2 * N_COUNTERS + 1 + (n + 1) // 2, dtype=torch.int64, device=dev)
    counters = scratch[:N_COUNTERS]
    march = scratch[N_COUNTERS:2 * N_COUNTERS] if counting else counters
    lengths = scratch[2 * N_COUNTERS + 1:].view(torch.int32)[:n]
    lib = _lib(counting, "classic", prof_bits(cfg))
    args = (
        *_trace_scene_args(pack), *(c.data_ptr() for c in o), o_stride, *(c.data_ptr() for c in d), d_stride,
        st_in.data_ptr(), 0 if act is None else act.data_ptr(), n, cfg.max_depth, cfg.rr_threshold,
        _flags(pack, cfg), out.data_ptr(), out_comp, out_lane, st.data_ptr(), lengths.data_ptr(),
        scratch[2 * N_COUNTERS].data_ptr(), counters.data_ptr(), march.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return lib, args, (out, st, lengths, counters, (march, o, d, st_in, act, scratch))


def _trace_scene_args(pack: ScenePack):
    """The scene arguments of a trace (it makes no camera rays: a zero
    basis), made once a pack."""
    key = "_trace_args"
    if key not in pack._host:
        basis = torch.zeros(19, dtype=torch.float32, device=pack.device)
        pack._host[key] = (basis, _scene_args(pack, basis))
    return pack._host[key][1]


def _launch_trace(counting: bool, orig: V3, dirv: V3, state, pack, cfg, active, rows=False):
    """Returns (radiance: V3, or [n, 3] rows with ``rows``; state; counters;
    each lane's path length)."""
    lib, args, (out, st, lengths, counters, _keep) = _trace_call(counting, orig, dirv, state, pack, cfg, active, rows)
    raise_on(lib.pt_trace_grid(*args), lib, "trace_grid")
    shape = orig.x.shape
    if len(shape) == 1:
        return (out if rows else V3(out[0], out[1], out[2])), st, counters, lengths
    rad = out if rows else V3(out[0].reshape(shape), out[1].reshape(shape), out[2].reshape(shape))
    return rad, st.reshape(shape), counters, lengths


# ---------------------------------------------------------------------------
# The paged walk alone
# ---------------------------------------------------------------------------


def paged_traverse(o: V3, d: V3, pack: ScenePack, t_min, best_t, exclude_obj=None, t_max=None, skip=None):
    """Closest-hit paged walk for given rays; arguments and result as
    ``ops/bvh.py::traverse_triangles_paged`` (``visits`` is -1 from the
    kernel, which keeps no count across threads).  CUDA tensors go to the
    kernel, CPU tensors to the plain version; nothing falls back."""
    global WALK_LAUNCHES, WALK_PLAIN_CALLS
    if o.x.is_cuda:
        out_i, out_f, _ = _launch_walk(False, False, o, d, pack, t_min, best_t, t_max, exclude_obj, skip)
        WALK_LAUNCHES += 1
        shape = o.x.shape
        r = lambda x: x.reshape(shape)  # noqa: E731
        return bvh_mod.PagedHit(
            r(out_i[1] >= 0), r(out_i[0]), r(out_i[1]), r(out_f[0]), r(out_f[1]), r(out_f[2]), r(out_f[3]),
            r(out_f[4]), r(out_f[5]), visits=-1,
        )
    if o.x.device.type == "cpu":
        WALK_PLAIN_CALLS += 1
        return bvh_mod.traverse_triangles_paged(
            o, d, pack, t_min, best_t, exclude_obj=exclude_obj, t_max=t_max, skip=skip
        )
    raise NotImplementedError(f"paged_traverse: no kernel for device {o.x.device}")


def paged_occluded(o: V3, d: V3, pack: ScenePack, t_min, t_max, blocked):
    """Any-hit paged walk for given rays; arguments and result as
    ``ops/bvh.py::occluded_triangles_paged``."""
    global WALK_LAUNCHES, WALK_PLAIN_CALLS
    if o.x.is_cuda:
        _, _, out = _launch_walk(False, True, o, d, pack, t_min, None, t_max, None, blocked)
        WALK_LAUNCHES += 1
        return out.to(torch.bool).reshape(o.x.shape)
    if o.x.device.type == "cpu":
        WALK_PLAIN_CALLS += 1
        return bvh_mod.occluded_triangles_paged(o, d, pack, t_min, t_max, blocked)
    raise NotImplementedError(f"paged_occluded: no kernel for device {o.x.device}")


def paged_count_ops(o: V3, d: V3, pack: ScenePack, t_min, best_t=None, t_max=None, exclude_obj=None, skip=None,
                    any_hit=False) -> int:
    """The f32 operations that the walk does for these rays, tallied by the
    counting build (the C_PAGE_* table in csrc/paged_walk.cuh).  Not a
    launch of the walk: ``WALK_LAUNCHES`` does not change."""
    return paged_count_split(o, d, pack, t_min, best_t, t_max, exclude_obj, skip, any_hit)["ops"]


# the warp sweep's counts after the cursor (csrc/common.cuh, SWEEP_COUNTS)
_SWEEP_NAMES = ("sets", "pages_visited", "want_sum", "lane_slots", "pairs", "box_tests")


def paged_count_split(o: V3, d: V3, pack: ScenePack, t_min, best_t=None, t_max=None, exclude_obj=None, skip=None,
                      any_hit=False) -> dict:
    """The counting build of the walk alone on these rays, one thread a ray
    (a warp is 32 consecutive rays): ``ops``, and the warp sweep's counts
    summed over its working sets: ``sets``, ``pages_visited``, ``want_sum``
    (the rays that want each visited page), ``lane_slots`` (rounds of the
    row loop times the set's lanes), ``pairs`` (the (ray, row) pairs the
    rays need) and ``box_tests``.  Not a launch of the walk."""
    counters = _launch_walk(True, any_hit, o, d, pack, t_min, best_t, t_max, exclude_obj, skip, want_counts=True)
    vals = [int(c) for c in counters.cpu()]
    return {"ops": vals[1], **dict(zip(_SWEEP_NAMES, vals[36:42]))}


def _launch_walk(counting, any_hit, o, d, pack, t_min, best_t, t_max, exclude_obj, skip, want_counts=False):
    dev = o.x.device
    if dev.type != "cuda":
        raise ValueError(f"the paged walk kernel needs CUDA tensors, got {dev}")
    if pack.paged is None:
        raise ValueError("the paged walk needs a pack with pages (a mesh above STATIC_TRI_MAX triangles)")
    if pack.device != dev:
        raise ValueError("paged walk: pack and rays must be on one device")
    n = o.x.numel()
    lanes = lambda x, fill: (  # noqa: E731
        torch.full((n,), fill, dtype=torch.float32, device=dev) if x is None
        else torch.as_tensor(x, device=dev).to(torch.float32).broadcast_to(o.x.shape).reshape(-1)
    )
    rays = torch.stack([
        o.x.reshape(-1), o.y.reshape(-1), o.z.reshape(-1),
        lanes(d.x, 0.0), lanes(d.y, 0.0), lanes(d.z, 0.0),
        lanes(best_t, bvh_mod._BIG_T), lanes(t_max, float("inf")),
    ]).to(torch.float32).contiguous()
    excl = lanes(exclude_obj, -1.0).contiguous()
    skip_u8 = (
        torch.zeros(n, dtype=torch.uint8, device=dev) if skip is None
        else torch.as_tensor(skip, device=dev).broadcast_to(o.x.shape).reshape(-1).to(torch.uint8).contiguous()
    )
    out_i = torch.empty((2, n), dtype=torch.int32, device=dev)
    out_f = torch.empty((6, n), dtype=torch.float32, device=dev)
    out_b = torch.empty(n, dtype=torch.uint8, device=dev)
    counters = torch.zeros(N_COUNTERS, dtype=torch.int64, device=dev)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (pack.page_tiles, pack.page_boxes)):
        raise ValueError("paged walk: page tables must be contiguous float32")
    lib = _lib(counting)
    err = lib.pt_paged_walk(
        pack.page_tiles.data_ptr(), pack.page_boxes.data_ptr(), pack.paged.n_pages, pack.page_boxes.shape[1],
        rays.data_ptr(), excl.data_ptr(), skip_u8.data_ptr(), n, float(t_min), int(any_hit),
        out_i.data_ptr(), out_f.data_ptr(), out_b.data_ptr(), counters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"paged walk kernel launch failed: {lib.pt_error_string(err).decode()}")
    if want_counts:
        return counters
    return out_i, out_f, out_b
