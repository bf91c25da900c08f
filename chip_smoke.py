#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. report the card (nvidia-smi name and power limit);
2. build the kernels (csrc/render_pass.cu, csrc/classic.cu and
   csrc/probes.cu, each with csrc/common.cuh and csrc/paged_walk.cuh, and
   csrc/repro.cu, nvcc for sm_90a) and their operation-counting variants
   (-DPT_COUNT_OPS; repro.cu's holds only T6's step split), all builds side
   by side, and print ptxas' registers, spills, stack frames and shared
   memory;
3. hold the whole-pass kernel against its plain PyTorch version on the
   card for demo_showcase and demo_cornell at 256x144, depth 12, one pass
   and one 2-pass window: at least 95% of lanes within |a-b| <= 1e-3|b| +
   1e-3, segment counts within 2%, per-channel means within 1%, and bit
   for bit on every lane with segments equal; then a
   first, small run of the paged walk alone against its plain version
   (2,048 rays, bench_mesh and demo_mesh, with phase 8's cases), bit for
   bit;
4. drive the main path: Renderer(contract="gpu") on demo_showcase at
   1920x1080, depth 12, one 8-pass window, one warm-up and 3 timed renders
   (on the card a window is one launch of the fog kernel and one of B1's
   regeneration instance over all its lanes);
5. check that the main path launched both kernels and never called a plain
   version;
6. time them with CUDA events at the main path's shape (the window as the
   Renderer launches it, the fog kernel alone, B1 alone on the window's fog
   terms) and B1 at 256x144, where phase 3 timed the plain version on the
   same inputs; count the f32 operations and hash rounds the main path's
   inputs need with the counting variant, derive each kernel's bound (f32
   operations at 67 TFLOP/s, and as FFMA slots at the unfused rate), and
   print B1's split: lane cycles by stage, NEE's active-lane share, the warp
   tail, the launch's block ends and the hash rounds; and the fog kernel's
   (the march's split: lane cycles of its primary hit, noise, light
   sampling and shadow tests, the lanes that run a shadow test, the blocked
   share, the primitives a test visits, the sinf arguments past 105,615);
7. hold B1 against its plain version at the main path's own arguments
   (1920x1080, depth 12, frame seed 1, one 8-pass window): the lanes that
   phase 6's full-size launch produced, and the kernel run on the same
   8,209 lanes strided over the frame alone (a part-full last block), bit
   for bit with segments equal.

8. the paged walk alone (pt_paged_walk, the device functions that the
   whole-pass kernel calls for meshes above 128 triangles) against its
   plain version: camera and random rays on bench_mesh's pack (80 pages,
   flat) and demo_mesh's (smooth), closest hit with and without a start
   distance, an excluded object, a far limit and skipped rays, and any hit
   with rays that come in blocked; then the cooperative walk's partial
   working sets: the first 2,065 rays alone (the last warp holds 17), every
   other ray skipped (closest hit) or come in blocked (any hit): key, page,
   t, normal, mat, obj and blocked bit-identical on every ray;
9. the whole-pass kernel on mesh scenes against its plain version
   (demo_mesh, bench_mesh; 192x192, depth 8, one pass and a 2-pass
   window), bit for bit as in phase 3;
10. the whole-pass kernel on a scene of 12 lights (the 8-slot window of
    next-event estimation, one non-sphere light, fog; 192x108, depth 6)
    likewise;
11. drive the mesh path: Renderer(contract="gpu") on bench_mesh at 512x512,
    depth 8, one 8-pass window, one warm-up and 3 timed renders; it must
    run on the kernel alone;
12. time the whole-pass kernel on that frame and count its operations; time
    the walk alone on the frame's 262,144 primary rays, its plain version on
    the same rays, hold the two against each other bit for bit on every one
    of those rays (closest hit and any hit), and on perf probe T2's 65,536
    incoherent rays over T2's sphere (80 pages), count the walk's
    operations and the bytes it must move, and derive its bound;
13. hold the whole-pass kernel against its plain version at the mesh path's
    own arguments (bench_mesh 512x512, depth 8, frame seed 1, one 8-pass
    window): the lanes that phase 12's full-size launch produced (262,144
    lanes over the paged instance's persistent grid, whose threads take
    lanes as they go, so most threads run several), and the kernel run on
    the same 2,065 lanes strided over the frame alone (not a multiple of the
    block), bit for bit with segments equal.

14. kernel B3 (pt_trace_grid, the classic loop for given rays) against its
    plain version, bit for bit on radiance, state and segments: 16,384
    camera and random rays on demo_showcase, demo_cornell and bench_mesh,
    cpu contract (depth 80), gpu contract and gpu contract with the in-trace
    fog march (depth 12), and a batch with an active mask; then bench_mesh
    at the mesh path's depth 8 on 2,048 rays an SM and 17 more (270,353 on
    an H100): more rays than any persistent grid of B3's bounces has
    threads, so every thread takes several;
15. the classic instance of the whole-pass kernel against its plain version
    at 256x144, depth 12, bit for bit with segments equal: the cpu contract
    on demo_showcase and demo_cornell, faithful fog on demo_showcase, the
    frame as one chunk; then as the Renderer launches it, on the frame in 4
    chunks of 10,000 lanes (the last padded): the cpu contract's window of 3
    passes in one launch, faithful fog two launches a sample over all
    chunks;
16. drive the cpu-contract path: Renderer(contract="cpu") on demo_showcase
    at 1920x1080, depth 80, 16 passes, one warm-up and 3 timed renders; it
    must run on the classic instance alone, one launch a window of 8
    passes (2 a render);
17. drive the faithful-fog path: Renderer(contract="gpu", faithful_fog=True)
    on demo_showcase at 1920x1080, depth 12, 1 pass, likewise, two launches
    a sample over all chunks (the march kernel, then the sample kernel: 16
    of each a pass);
18. time the classic instance on those frames as the Renderer launches it
    (a window of 8 passes; one pass of 16 samples) by CUDA events, and each
    kernel's own device time from torch.profiler (which shows how long the
    card waits for the host), count their operations and hash rounds,
    derive their bounds and print their split (and the march kernel's
    march split, as phase 6 prints the fog kernel's); drive trace() (B3) on the
    262,144 primary rays of the cpu frame's first chunk, each contract,
    time it and its plain version, count its operations and derive its
    bound, and take the call apart (pt_trace_grid alone, the longest path's
    ray alone: the call's latency floor);
19. hold the classic instance against its plain version at those paths' own
    arguments, bit for bit with segments equal: 8,192 lanes strided over
    the cpu frame's window of 8 passes that phase 18 timed (frame seeds 1-8,
    one launch) and over a window of 2 passes, and the faithful-fog frame's
    first chunk and its padded last chunk
    (262,144 lanes each, 23,552 of the last one off-frame), the lanes taken
    from the frame's launches over all chunks.

20. perf probe T1 (op chains, csrc/probes.cu): every op class against its
    plain version at 4 iterations (256 ops), on the TPU probe's 256x128
    block and on a grid that fills the card (hash, select, sqrt, divide and
    fma bit for bit, the others within rel 1e-5), and the IEEE-exact classes
    at the full 2,000 iterations on the 256x128 block, bit for bit; then the probe's own
    entry point (tools/perf/microbench.py) at full length with its launch
    count, the fma-slot equivalents, and a check that half the iterations
    take about half the time;
21. T2 (the paged sweep): every variant on both packets, all 65,536 rays,
    one traversal, against its plain version bit for bit, and all = dense =
    gather; every variant on the incoherent packet at the probe's 16 chained
    traversals, bit for bit; then tools/perf/paged_probe.py (16 traversals a launch) with
    its time split, and the operations of each variant (counting build);
22. T3 (page-tile fetch by layout): the four layouts on the TPU probe's 16
    blocks and on a full-card grid against the plain version bit for bit,
    at p = 0, 1, K - 1, K, K + 1 (K the tiles of the kernel's ring) and 80;
    then tools/perf/fetch_probe.py; then T3's time against p (0 to 80,
    layouts a and d, both grids: the launch, a tile, and from the full-card
    grid the bytes an SM takes in a second) and the floor that the probe's
    contract allows (a block's tiles at that rate, plus the launch); then
    thread 0's loop by step, a tile (counting build, 16 blocks, a and d);
23. T4 (the fetch taken apart): the five variants likewise; then
    tools/perf/fetch_probe2.py, with the library call beside dyn_vec.

24. repro T5 (csrc/repro.cu, the windowed one-hot gather): layouts A and B
    against the plain version bit for bit, on the tool's pages and on two
    page sets whose window starts past 0, and on the tool's special values
    (window_slice_probe.special_inputs) bit for bit where a number and NaN
    where NaN; then tools/repro/window_slice_probe.py; then the kernel's
    split by clock64 (counting build: the base, the copy, the computation,
    the stores, the block tail and the block ends), both layouts;
25. T6 (the guarded chain of products): cond true, cond false and the
    control at 1 and 3 rounds, on the tool's ones and on a random b, bit
    for bit, and true != false on the random b; then
    tools/repro/mosaic_cond_skip.py at the JAX default of 16,384 rounds (at
    fewer, printed, if a call would pass 2 s), which must show control ~
    true >> false, and half the rounds about half the time; the library
    call torch.matmul a step beside it; the split of a step by clock64
    (counting build: the products, the write and barrier wait, the rest);
26. T7 (the staged relayout): stages 1-5 at G = 1, 2, 4, 8 bit for bit,
    and stage 5 at each G on the tool's inputs with special values (w with
    +-0, +-inf, NaN and a bf16 overflow, x with a NaN and negative
    entries); then tools/repro/mosaic_reshape_repro.py at each G;
27. T8 (the grouped rows): G = 1, 2, 4, 8 bit for bit; then
    tools/repro/group_rows_relayout.py at each G.

28. the fuzzed scenes: the four scenes of tests/test_fuzz.py (seeds 11,
    23, 37, 59, from tests/torch_fuzz_scenes.json), every lane of a 64x48
    frame, depth 4, one pass: the gpu contract on B1's regeneration
    instance and the cpu contract on the classic instance against their
    plain versions, bit for bit with segments equal;
29. the fog kernel at the main path's shape (the 1080p window's 2,097,152
    lanes x 8 passes in one launch) against its plain version
    (render.fog_pass_terms) on 65,536 lanes strided over the frame, bit for
    bit.

30. the CLI: ``cli.main`` in this process at the reference's headless final
    preset (cpu contract, demo_showcase, 1920x1080, 1,000 passes, depth 80)
    with PATHTRACER_METRICS set and --json-stats: the PNG written, its
    stats line, classic_window_kernel launched alone (one launch a window,
    the windows ending at the 20 interval passes), and
    tools/metrics_report.py on the metrics stream (20 finite intervals);
    then ``python -m path_trace_golang_tpu_torch -headless`` at the preview
    preset in a process of its own, which must write its PNG;
31. checkpoint resume: a render interrupted through cancel about halfway,
    then resumed from its checkpoint, bit for bit (image and final
    accumulator) against the uninterrupted render with the same checkpoint
    settings: the cpu contract at the final preset (also against the
    render without checkpointing and phase 30's image), the gpu contract
    (B1 and its fog kernel) and faithful fog (the classic march and sample
    kernels, also against the render without checkpointing) at the preview
    preset (400x225, 20 passes, depth 20); the walls with and without
    checkpointing, the saves' cost;
32. the interactive session on the card (gpu contract, the preview preset)
    under the viewer on 127.0.0.1 and an ephemeral port: /frame.png a PNG
    of the session's size, a /key that moves the camera and a new frame
    after it, /save writing inside the save directory, and the session's
    last image bit for bit a direct Renderer.render with the same windows;
    every launch from the card's kernels.

33. the mesh renderer (parallel/mesh.py), its ranks spawned by
    parallel/launch.run_world after phase 2 has built the kernels (the
    ranks load them): 33a a world of 1 over NCCL, a 1x1 mesh, demo_showcase
    1920x1080 d12 x8 (gpu contract); 33b a world of 4 ranks on this card
    over gloo (NCCL refuses two ranks on one card), meshes 4x1 and 2x2, on
    that case, the cpu contract at 1080p d80 x16, faithful fog at 1080p
    d12 x2 and bench_mesh 512x512 d8 x8 (B2 on the path).  Each rank
    renders once to warm up, then its counts are set to 0, it renders, and
    they are read: no plain call, and the kernels that the single Renderer
    launches on that case, no other.  Each render is held against the
    single Renderer in this process, whose chunk is the mesh's px block
    (the classic loop's chunks decide its states, PHYSICS.md D7): a px-only
    mesh bit for bit (accumulator, image), an spp mesh within 1e-5 a
    accumulator entry; segments equal; every rank the same image; each
    mesh's wall (its slowest rank's) printed beside the single Renderer's.

34. PATHTRACER_BVH_DROP (integrator.TraceConfig.debug_drop, the launch
    flags FLAG_DROP_*): for each of closest, shadow, spec and all three, B1's
    paged instance on bench_mesh (64x64, depth 4, one pass), faithful fog's
    classic instance on demo_showcase with its mesh routed to the paged walk
    (PATHTRACER_BVH_DYNAMIC=1; 96x48, depth 3, one pass: the shadow drop
    must leave the fog march's own shadow tests alone) and B3 through
    trace() under the gpu contract (bench_mesh, depth 8, 16,384 camera and
    16,384 random rays: the specular-NEE walk changes few of them), each against its plain version bit for bit with
    segments equal, and each dropped image different from the undropped;
35. every measurement tool of the port once, each in a process of its own
    at its smallest arguments (tools/perf walk_attrib, tri_scaling at 10k
    and 100k triangles, many_lights, fixed_cost, mesh_scaling and
    mesh_attrib on a world of 2, graft_entry on 2 ranks, and the CLI under
    PATHTRACER_TIME_PHASES=1, whose phase table must name the JAX
    Renderer's phases): each must exit 0 with its JSON line and no call of
    a plain version.

36. PATHTRACER_NO_REGEN: the classic instance under the gpu contract (its
    march kernel, which adds the fog once at sample 0, and its sample
    kernel) held bit for bit, segments equal, to the plain classic loop on
    demo_showcase (fog once) at 256x144 d12 and bench_mesh (paged) at
    192x192 d8, each in 4 chunks of 10,000 lanes, the last padded, on
    demo_cornell (no fog) at 256x144 d12 as one chunk launched through
    render_pass_cuda, and on the padded last chunk of the 1080p NO_REGEN
    frame (8 chunks of 2^18 lanes), there also to the chunk launched
    alone; then, after phase 29, the Renderer on
    the 1080p showcase, d12, one pass of 16 samples, under NO_REGEN beside
    the regeneration path: Mrays/s of both, the classic instance's
    launches, its time on the frame and its bound from the counting
    build's operations, the two images within the goldens' bands,
    nonfinite 0, no plain call;
37. each profiling knob (PATHTRACER_PROF_NO_MESH_HIT, _LITE, _OCCL,
    PATHTRACER_NO_WALK_SKIP) through the profiling build held bit for bit
    to the plain versions on B1 paged and page-free with the fog kernel,
    the classic instance under both contracts (NO_REGEN with fog once on a
    static and a paged mesh, faithful fog) and B3; a mesh knob must change
    the image of every path that runs its query, NO_WALK_SKIP none; after
    phase 29 the Renderer with NO_WALK_SKIP and without on the 1080p
    showcase (one pass) and bench_mesh 512x512 (what the knob costs on the
    card: NEE and the specular-NEE query on every lane that hit), and the
    shipped build's SASS digest of each library;
38. union_stats, want_stats and build_probe at their smallest arguments
    (union_stats exits 1 unless the counting build's sweep counts equal
    its warp model).

Phases 34 and 35 run in a third process (``--phases-34-35``), phase 36's
holds of demo_cornell and bench_mesh, 37 and 38 in a fourth
(``--phases-36-38``, which first builds the render libraries' eight
profiling builds, side by side), and in a fifth (``--side-holds``) phase
36's holds of the showcase, phase 15's faithful-fog frame as one chunk
and phase 19's first chunk of the 1080p faithful-fog frame; all started
beside the second and read with it.

Phase 15's faithful-fog frame in 4 chunks and phase 19's padded last
1080p chunk run in a second process (``--classic-holds``) that the main one
starts after phase 6 and reads before phase 11, beside phases 7-10, which
hold and time nothing: the plain versions take most of the script's time
and follow the host's speed, and run one after the other they would leave
too little of the time limit on a slow host (PERF.md §7).

The line before the last three says how long the phases took in all.  The
third-to-last line is a JSON object describing every kernel
(``max_abs_err`` is the largest the comparisons of that kernel found); the
second-to-last is the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  ``--quick`` runs phases 1-3 only, at 64x36
and depth 4, and a first, small run of B3 and of the classic instance.
``--probes`` runs phases 1, 2 (the probes' library only) and 20-23;
``--repro`` phases 1, 2 (the repros' library only) and 24-27;
``--front-end`` phases 1, 2 (the render libraries only) and 30-32;
``--mesh [4x1 2x2 ...]`` phases 1, 2 (the render libraries only) and 33
on the meshes given (33b's world holds the largest); ``--mesh
--across-cards`` phase 33c instead of 33a and 33b: that world over NCCL,
one card a rank (on a machine with as many cards).  ``--drop`` runs
phases 1, 2 (the render libraries only) and 34.  ``--tools`` runs phases
1, 2 and every tool at its full arguments on one card (mesh_scaling and
mesh_attrib at 1920x1080 on demo_showcase and on bench_mesh, the others at
the JAX tools' defaults), each tool's log and JSON line written under
build/tools/ (the page statistics at 10k, 40k and 100k triangles);
``--tools --across-cards`` the two mesh tools alone, over NCCL one card a
rank.  ``--knobs`` runs phases 1, 2 (the render libraries and their
profiling builds) and 36-38; ``--sass`` prints the shipped build's SASS
digest of each library (a copy of this script in another tree's root
digests that tree).

``--render-only [scene width height passes depth renders]`` (defaults:
demo_showcase 1920 1080 8 12 5) times the Renderer alone with the code of
phases 4, 11, 16 and 17: one warm-up render, which also builds the kernels,
then ``renders`` timed ones, and one JSON line with Mrays/s and wall seconds
(median, min, max), segments, launches per render and ptxas' report;
``--contract cpu`` renders the cpu contract, ``--faithful-fog`` faithful
fog.  ``--kernels`` also times the frame's kernels alone with CUDA events,
as phases 12 and 18 do, at the render's scene and contract: the whole-pass
calls of a render as the Renderer makes them (events around each call,
summed a render: under the gpu contract the fog kernel and B1 of a window,
else the classic instance's launches), kernel B3 through trace() on the
first chunk's primary rays and, where the scene carries pages, the paged
walk alone on the frame's primary rays (closest hit and any hit); where
the tree has ``cuda_trace.trace_split``, B3's call taken apart on those
rays: pt_trace_grid alone, the longest path's ray alone, the launches of
trace() besides B3's own, and B3's ptxas.
``--split`` adds the split from the counting build on the render's own
calls: B1's under the gpu contract, the classic instance's with
``--contract cpu`` or ``--faithful-fog`` (lane cycles by stage, the segments
the warps ran for, block ends, hash rounds, both bounds), and the fog
march's (the fog kernel's, or the march kernel's under faithful fog); and
B3's on the first chunk's primary rays (the same, with the state
advance's hash rounds apart, and its in-trace fog march's split).
``--kernels`` also reports each render kernel's own device time in a render
(torch.profiler, median of 3 renders).  It imports the package that lies
beside the script, so a copy of this file in the root of another commit's
tree times that commit: to compare two commits, run them in turns in one
shell on one card.
"""

from __future__ import annotations

import atexit
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores, 700 W
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DEVICE = "cuda"  # every tensor of this script lives on the card
MAIN_CHECK_LANES = 8192 + 17  # lanes of the 1080p frame held to the plain version in phase 7: the last block
# holds a part-full warp
FOG_CHECK_LANES = 65536  # lanes of the 1080p window whose fog terms are held to the plain version in phase 29
MESH_CHECK_LANES = 2048 + 17  # lanes of the 512x512 mesh frame held to the plain version in phase 13: not a
# multiple of the block; the lanes taken from the frame's own launch (262,144 lanes over the paged instance's
# persistent grid) are the ones that ran the refill
COUNTERS = ("LAUNCHES", "FOG_LAUNCHES", "MARCH_LAUNCHES", "PAGED_LAUNCHES", "CLASSIC_LAUNCHES", "TRACE_LAUNCHES",
            "WALK_LAUNCHES", "PLAIN_CALLS", "FOG_PLAIN_CALLS", "TRACE_PLAIN_CALLS", "WALK_PLAIN_CALLS")
PLAIN_COUNTERS = ("PLAIN_CALLS", "FOG_PLAIN_CALLS", "TRACE_PLAIN_CALLS", "WALK_PLAIN_CALLS")
CLASSIC_CHECK_LANES = 8192  # lanes of the cpu-contract frame held to the plain version in phase 19
SMALL_CHUNK = 10000  # phase 15's chunk on a 256x144 frame: 4 chunks, the last padded by 3,136 lanes
B3_CHECK_RAYS = 8192  # camera rays (and as many random ones) of each B3 batch in phase 14
PARTIAL_RAYS = 2048 + 17  # rays of the walk's partial-warp case: its launch's last warp holds 17
FUZZ_SCENES = os.path.join(HERE, "tests", "torch_fuzz_scenes.json")  # tests/test_fuzz.py's scenes as JSON
FUZZ_W, FUZZ_H, FUZZ_DEPTH = 64, 48, 4  # phase 28's frame
FRAME_KERNELS = ("fog_pass_kernel", "render_pass_kernel", "classic_window_kernel", "classic_march_kernel",
                 "classic_sample_kernel")  # the render kernels whose device time --render-only --kernels reports


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def bit_share(a, b):
    """Share of lanes whose three channels are bit-identical."""
    import torch

    return (a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32)).all(dim=-1).double().mean().item()


def lane_stats(col_k, col_p, segs_k, segs_p):
    """Share of lanes within |a-b| <= 1e-3|b| + 1e-3 on all channels, the
    relative segment gap, the largest relative per-channel mean gap, and the
    largest absolute difference."""
    import torch

    diff = (col_k - col_p).abs()
    ok = (diff <= 1e-3 * col_p.abs() + 1e-3).all(dim=-1)
    mk, mp = col_k.double().mean(0), col_p.double().mean(0)
    mean_gap = ((mk - mp).abs() / mp.abs().clamp_min(1e-12)).max().item()
    seg_gap = abs(int(segs_k) - int(segs_p)) / max(int(segs_p), 1)
    return ok.double().mean().item(), seg_gap, mean_gap, torch.nan_to_num(diff, nan=float("inf")).max().item()


def many_lights_scene():
    """Twelve lights over a floor with a matte and a rough-metal sphere in
    thin fog: eleven sphere lights and one emissive box, which the
    estimator lists but cannot sample."""
    from path_trace_golang_tpu_torch.scene.model import Camera, Color, Fog, Material, Object, Scene, Sky, Vec3

    mats = [
        Material(id="floor", type="lambert", albedo=Color(0.8, 0.8, 0.8)),
        Material(id="matte", type="lambert", albedo=Color(0.7, 0.3, 0.2)),
        Material(id="steel", type="metal", albedo=Color(0.8, 0.8, 0.85), smoothness=0.6),
    ]
    objs = [
        Object(id="p", type="plane", position=Vec3(0, 0, 0), size=Vec3(0, 0, 0), material_id="floor"),
        Object(id="a", type="sphere", position=Vec3(-1.2, 1, 0), size=Vec3(1, 0, 0), material_id="matte"),
        Object(id="b", type="sphere", position=Vec3(1.2, 1, 0), size=Vec3(1, 0, 0), material_id="steel"),
    ]
    for i in range(12):
        mats.append(Material(id=f"L{i}", type="emissive", emit=Color(1, 1, 1), power=2.0 + i * 0.1))
        if i == 5:
            objs.append(Object(id=f"l{i}", type="box", position=Vec3(i - 5.5, 4, -2), size=Vec3(0.4, 0.4, 0.4),
                               material_id=f"L{i}"))
        else:
            objs.append(Object(id=f"l{i}", type="sphere_light", position=Vec3(i - 5.5, 4, -2),
                               size=Vec3(0.3, 0, 0), material_id=f"L{i}"))
    return Scene(
        name="many_lights",
        camera=Camera(position=Vec3(0, 1, 5), target=Vec3(0, 1, 0), up=Vec3(0, 1, 0), fov=60),
        sky=Sky(type="solid", color=Color(0, 0, 0)), materials=mats, objects=objs,
        fog=Fog(sigma_s=0.02, sigma_a=0.01, g=0.3, color=Color(1, 1, 1), scatter=1.0, density=0.01,
                gpu_volumetric=True),
    )


def scene_setup(pt, name, w, h, depth, contract="gpu", faithful=False, scene=None):
    """A scene (``scene``, else the one ``name`` names), its pack on the
    card and the whole-pass arguments of one of its passes as the Renderer
    would give them."""
    from path_trace_golang_tpu_torch import integrator
    from path_trace_golang_tpu_torch.scene import builtin

    sc = scene if scene is not None else many_lights_scene() if name == "many_lights" else getattr(builtin, name)()
    pack = pt.pack_scene(sc, w, h, device=DEVICE)
    tcfg = integrator.trace_config_for_scene(pack, sc, depth, contract, faithful_fog=faithful)
    n_strata, samples = (4, 16) if contract == "gpu" else (1, 1)
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False)
    return sc, pack, kw


def lanes(w, h, start=0, count=None):
    import torch

    n = w * h if count is None else count
    idx = torch.arange(start, start + n, dtype=torch.int32, device=DEVICE)
    return idx % w, torch.div(idx, w, rounding_mode="floor")


def hold_pass(pt, cuda_trace, tag, name, w, h, depth, passes=(1, 2), contract="gpu", faithful=False):
    """Whole-pass kernel against its plain version for one scene: prints a
    line per window size, returns (all within the bands, largest |a-b|,
    the plain version's seconds per window size).  Both instances must be
    bit-identical on every lane, segments equal."""
    import torch

    _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
    name = f"{name} ({contract} contract{', faithful fog' if faithful else ''})"
    px, py = lanes(w, h)
    good, worst, plain_secs = True, 0.0, {}
    for n_passes in passes:
        col_k, segs_k = cuda_trace.render_pass_cuda(pack, 7, px, py, n_passes=n_passes, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        col_p, segs_p = cuda_trace.render_pass_plain(pack, 7, px, py, n_passes=n_passes, **kw)
        torch.cuda.synchronize()
        plain_s = plain_secs[n_passes] = time.perf_counter() - t0
        share, seg_gap, mean_gap, err = lane_stats(col_k.to_rows(), col_p.to_rows(), segs_k, segs_p)
        bits = bit_share(col_k.to_rows(), col_p.to_rows())
        worst = max(worst, err)
        print(
            f"[{tag}] {name} {w}x{h} d{depth} n_passes={n_passes}: lanes matching {share:.4%}, bit-identical "
            f"{bits:.4%}, segments {int(segs_k)} vs {int(segs_p)} (gap {seg_gap:.4%}), "
            f"channel-mean gap {mean_gap:.4%}, max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
            flush=True,
        )
        good = good and share >= 0.95 and seg_gap <= 0.02 and mean_gap <= 0.01
        good = good and bits == 1.0 and int(segs_k) == int(segs_p)
    return good, worst, plain_secs


def fuzz_phase(pt, cuda_trace, card):
    """Phase 28: the whole-pass kernel against its plain version on the four
    fuzzed scenes of tests/test_fuzz.py (tests/torch_fuzz_scenes.json), every
    lane of a FUZZ_W x FUZZ_H frame, depth FUZZ_DEPTH, one pass: the gpu
    contract on B1's regeneration instance, the cpu contract on the classic
    instance; phase 3's bands and bit for bit with segments equal.  Returns
    (all held, largest |a-b|)."""
    import torch
    from path_trace_golang_tpu_torch.scene import io as scene_io

    t0 = time.perf_counter()
    with open(FUZZ_SCENES) as f:
        scenes = json.load(f)["scenes"]
    px, py = lanes(FUZZ_W, FUZZ_H)
    good, worst = True, 0.0
    for seed, obj in scenes.items():
        sc = scene_io.loads(json.dumps(obj))
        for contract, instance in (("gpu", "B1"), ("cpu", "classic instance")):
            _sc, pack, kw = scene_setup(pt, f"fuzz {seed}", FUZZ_W, FUZZ_H, FUZZ_DEPTH, contract, scene=sc)
            col_k, segs_k = cuda_trace.render_pass_cuda(pack, 3, px, py, **kw)
            torch.cuda.synchronize()
            tp = time.perf_counter()
            col_p, segs_p = cuda_trace.render_pass_plain(pack, 3, px, py, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - tp
            a, b = col_k.to_rows(), col_p.to_rows()
            share, seg_gap, mean_gap, err = lane_stats(a, b, segs_k, segs_p)
            bits = bit_share(a, b)
            worst = max(worst, err)
            print(
                f"[28] fuzz scene {seed} ({len(sc.objects)} objects, fog {sc.fog is not None}), {instance}, "
                f"{contract} contract {FUZZ_W}x{FUZZ_H} d{FUZZ_DEPTH}: lanes matching {share:.4%}, bit-identical "
                f"{bits:.4%}, segments {int(segs_k)} vs {int(segs_p)} (gap {seg_gap:.4%}), channel-mean gap "
                f"{mean_gap:.4%}, max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
                flush=True,
            )
            good = good and share >= 0.95 and seg_gap <= 0.02 and mean_gap <= 0.01
            good = good and bits == 1.0 and int(segs_k) == int(segs_p)
    print(f"[28] the fuzzed scenes in {time.perf_counter() - t0:.1f} s | card {card}", flush=True)
    return good, worst


def hold_frame_lanes(cuda_trace, tag, label, pack, kw, frame_cols, w, n_check, n_passes, frame_seed=1, exact=False,
                     classic=False):
    """Whole-pass kernel against its plain version at a driven path's own
    arguments (frame seed 1, the window's reseed schedule): the plain version
    runs on ``n_check`` lanes strided over the frame and is held against
    ``frame_cols``, the lanes that the full-size launches produced, and
    against the kernel run on those lanes alone (``classic``: the classic
    instance's window into a zeroed accumulator, the lanes as one chunk, as
    ``cuda_trace.classic_render`` runs it; one sample a pass, so no lane
    depends on another).  Returns (within the bands, bit for bit with
    segments equal where ``exact``; largest |a-b|; seconds of the plain
    version), or None if a lane's result depends on the launch it ran in."""
    import torch

    stride = frame_cols.shape[0] // n_check
    sub = torch.arange(n_check, device=DEVICE, dtype=torch.int64) * stride + stride // 2
    spx, spy = (sub % w).to(torch.int32), torch.div(sub, w, rounding_mode="floor").to(torch.int32)

    def run(plain):
        if classic:
            acc = torch.zeros((n_check, 3), dtype=torch.float32, device=DEVICE)
            fn = cuda_trace.classic_render_plain if plain else cuda_trace.classic_render_cuda
            return acc, fn(acc, pack, frame_seed, spx, spy, chunk=n_check, n_passes=n_passes, **kw)
        fn = cuda_trace.render_pass_plain if plain else cuda_trace.render_pass_cuda
        col, segs = fn(pack, frame_seed, spx, spy, n_passes=n_passes, **kw)
        return col.to_rows(), segs

    t0 = time.perf_counter()
    col_p, segs_p = run(True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    col_k, segs_k = run(False)
    torch.cuda.synchronize()
    from_frame = frame_cols[sub]
    if not torch.equal(col_k, from_frame):
        return None
    share, seg_gap, mean_gap, err = lane_stats(from_frame, col_p, segs_k, segs_p)
    bits = bit_share(from_frame, col_p)
    print(
        f"[{tag}] {label} frame seed {frame_seed} n_passes={n_passes}, {n_check} lanes at stride {stride} "
        f"(kernel lanes from the full-size launches, and the same from a launch of these lanes alone): lanes "
        f"matching {share:.4%}, bit-identical {bits:.4%}, segments {int(segs_k)} vs {int(segs_p)} (gap "
        f"{seg_gap:.4%}), channel-mean gap {mean_gap:.4%}, max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
        flush=True,
    )
    good = share >= 0.95 and seg_gap <= 0.02 and mean_gap <= 0.01
    if exact:
        good = good and bits == 1.0 and int(segs_k) == int(segs_p)
    return good, err, plain_s


def hold_classic_frame(pt, cuda_trace, tag, name, w, h, depth, chunk, n_passes, contract, faithful, frame_seed=7):
    """The classic instance as the Renderer launches it on the card
    (``cuda_trace.classic_render_cuda``: all of a frame's lanes in chunks of
    ``chunk``, the last padded by off-frame rows, a window of ``n_passes``
    passes) against its plain version (``pass_body_grid`` pass by pass and
    chunk by chunk), both into zeroed accumulators: bit for bit with
    segments equal, in the launches of its shape (one of the window kernel a
    window under the cpu contract; one of the march kernel and one of the
    sample kernel a sample).  Returns (all held, largest |a-b|)."""
    import torch

    _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
    n_pad = -(-(w * h) // chunk) * chunk
    px, py = lanes(w, h, 0, n_pad)
    got = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
    want = torch.zeros_like(got)
    before = (cuda_trace.CLASSIC_LAUNCHES, cuda_trace.MARCH_LAUNCHES)
    segs_k = cuda_trace.classic_render_cuda(got, pack, frame_seed, px, py, chunk=chunk, n_passes=n_passes, **kw)
    launches = (cuda_trace.CLASSIC_LAUNCHES - before[0], cuda_trace.MARCH_LAUNCHES - before[1])
    t0 = time.perf_counter()
    segs_p = cuda_trace.classic_render_plain(want, pack, frame_seed, px, py, chunk=chunk, n_passes=n_passes, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    share, seg_gap, mean_gap, err = lane_stats(got, want, segs_k, segs_p)
    bits = bit_share(got, want)
    shape = (1, 0) if contract == "cpu" else (n_passes * kw["samples"],) * 2
    print(
        f"[{tag}] {name} {w}x{h} d{depth} {contract} contract{', faithful fog' if faithful else ''}, "
        f"{n_pad // chunk} chunks of {chunk} lanes ({n_pad - w * h} padding), {n_passes} passes in {launches[0]} "
        f"launches of the classic instance and {launches[1]} of its march kernel (want {shape[0]} and {shape[1]}): "
        f"lanes matching {share:.4%}, bit-identical {bits:.4%}, segments {int(segs_k)} vs "
        f"{int(segs_p)}, channel-mean gap {mean_gap:.4%}, max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
        flush=True,
    )
    return bits == 1.0 and int(segs_k) == int(segs_p) and launches == shape, err


def hold_classic_chunk(cuda_trace, tag, label, pack, kw, frame_acc, px, py, c0, chunk, n):
    """Phases 19 and 36: the chunk at lane ``c0`` of a 1080p frame of the
    classic instance (faithful fog, or the gpu contract under
    PATHTRACER_NO_REGEN), whose one pass ``frame_acc`` holds from the
    frame's launches over all chunks, against the plain version on that
    chunk and against the chunk launched alone, bit for bit with segments
    equal.  Returns (held, largest |a-b|, seconds of the plain version)."""
    import torch

    cpx, cpy = px[c0:c0 + chunk], py[c0:c0 + chunk]
    want = torch.zeros((chunk, 3), dtype=torch.float32, device=DEVICE)
    t0 = time.perf_counter()
    segs_p = cuda_trace.classic_render_plain(want, pack, 1, cpx, cpy, chunk=chunk, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    alone = torch.zeros((chunk, 3), dtype=torch.float32, device=DEVICE)
    segs_k = cuda_trace.classic_render_cuda(alone, pack, 1, cpx, cpy, chunk=chunk, **kw)
    got = frame_acc[c0:c0 + chunk]
    share, seg_gap, mean_gap, err = lane_stats(got, want, segs_k, segs_p)
    bits = bit_share(got, want)
    print(
        f"[{tag}] {label}, the chunk at lane {c0} ({chunk} lanes, "
        f"{max(0, c0 + chunk - n)} of them padding, frame seed 1; the kernel's lanes from the frame's launches "
        f"over all chunks): lanes matching {share:.4%}, bit-identical {bits:.4%}, segments {int(segs_k)} vs "
        f"{int(segs_p)} (the chunk launched alone; gap {seg_gap:.4%}), channel-mean gap {mean_gap:.4%}, "
        f"max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
        flush=True,
    )
    return torch.equal(alone, got) and bits == 1.0 and int(segs_k) == int(segs_p), err, plain_s


def classic_holds(pt, cuda_trace) -> bool:
    """``--classic-holds``: the classic instance's two longest holds, which
    the main run starts in a process of its own beside phases 7-10: phase
    15's faithful-fog frame in 4 chunks and phase 19's padded last chunk of
    the 1080p faithful-fog frame (rendered here as the Renderer launches
    it).  Returns whether both held bit for bit."""
    import torch

    good, _err = hold_classic_frame(pt, cuda_trace, "15", "demo_showcase", 256, 144, 12, SMALL_CHUNK, 1, "gpu", True)
    chunk, n = pt.render.env_config.get_chunk_size(), 1920 * 1080
    n_pad = -(-n // chunk) * chunk
    _sc, pack, kw = scene_setup(pt, "demo_showcase", 1920, 1080, 12, "gpu", True)
    px, py = lanes(1920, 1080, 0, n_pad)
    acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
    cuda_trace.classic_render_cuda(acc, pack, 1, px, py, chunk=chunk, **kw)
    last, _err, _s = hold_classic_chunk(cuda_trace, "19", "demo_showcase 1920x1080 d12 faithful fog", pack, kw, acc,
                                        px, py, n_pad - chunk, chunk, n)
    return good and last


def drive_renderer(pt, cuda_trace, tag, name, w, h, passes, depth, renders, card, contract="gpu", faithful=False):
    """Drive Renderer(contract=...) on a built-in scene: every count set to
    0, one warm-up render, ``renders`` timed ones, the counts read.  Returns
    the rates, walls, last image and statistics and the counts."""
    from path_trace_golang_tpu_torch.scene import builtin

    sc, cfg = getattr(builtin, name)(), pt.RenderConfig(w, h, passes, depth)
    for c in COUNTERS:
        if hasattr(cuda_trace, c):
            setattr(cuda_trace, c, 0)
    r = pt.Renderer(contract=contract, seed=1, faithful_fog=faithful)
    img = r.render(sc, cfg)  # warm-up
    print(f"[{tag}] warm-up: {r.stats.wall_seconds:.3f} s, {r.stats.mrays_per_sec:.2f} Mrays/s", flush=True)
    rates, walls = [], []
    for i in range(renders):
        img = r.render(sc, cfg)
        rates.append(r.stats.mrays_per_sec)
        walls.append(r.stats.wall_seconds)
        print(f"[{tag}] render {i}: {r.stats}  ({card})", flush=True)
    counts = {c: getattr(cuda_trace, c, 0) for c in COUNTERS}
    out = dict(rates=rates, walls=walls, img=img, stats=r.stats, counts=counts,
               plain_calls=sum(counts[c] for c in PLAIN_COUNTERS))
    print(
        f"[{tag}] {name} {w}x{h} d{depth} {passes} passes, {contract} contract"
        f"{', faithful fog' if faithful else ''}: {statistics.median(rates):.3f} Mrays/s median "
        f"(min {min(rates):.3f}, max {max(rates):.3f}), wall {statistics.median(walls):.4f} s median, "
        f"segments {r.stats.ray_segments}, nonfinite {r.stats.nonfinite}, image mean {img.mean():.4f} "
        f"std {img.std():.4f}; kernel launches {counts['LAUNCHES']} ({renders + 1} renders), of them with "
        f"pages {counts['PAGED_LAUNCHES']}, of the classic instance {counts['CLASSIC_LAUNCHES']}, fog kernel "
        f"launches {counts['FOG_LAUNCHES']}, "
        f"plain calls {out['plain_calls']} | card {card}",
        flush=True,
    )
    return out


def in_render(pt, cuda_trace, name, w, h, passes, depth, contract, faithful, hook):
    """Render a built-in scene once with ``hook(orig, args, kwargs)`` in place
    of cuda_trace.render_pass_cuda and, where the tree has it,
    cuda_trace.classic_render_cuda (the classic instance's frame calls), so
    that whatever the hook does sees every whole-pass call exactly as the
    Renderer makes it (its lanes, seeds and window).  The hook returns the
    call's result."""
    from path_trace_golang_tpu_torch.scene import builtin

    names = [k for k in ("render_pass_cuda", "classic_render_cuda") if hasattr(cuda_trace, k)]
    origs = {k: getattr(cuda_trace, k) for k in names}
    for k in names:
        setattr(cuda_trace, k, lambda *a, _o=origs[k], **kw: hook(_o, a, kw))
    try:
        pt.Renderer(contract=contract, seed=1, faithful_fog=faithful).render(
            getattr(builtin, name)(), pt.RenderConfig(w, h, passes, depth))
    finally:
        for k in names:
            setattr(cuda_trace, k, origs[k])


def render_kernel_ms(pt, cuda_trace, name, w, h, passes, depth, contract, faithful, renders=3):
    """The whole-pass calls of a render as the Renderer makes them, timed by
    CUDA events around each call and summed a render: median ms and calls a
    render.  The events' span holds all the call launches (the fog kernel
    and the regeneration instance, or the classic instance's launches)."""
    import torch

    spans, per_render = [], []

    def hook(orig, a, k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = orig(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return res

    for _ in range(renders):
        spans.clear()
        in_render(pt, cuda_trace, name, w, h, passes, depth, contract, faithful, hook)
        torch.cuda.synchronize()
        per_render.append((sum(e0.elapsed_time(e1) for e0, e1 in spans), len(spans)))
    return statistics.median(ms for ms, _ in per_render), per_render[0][1]


def render_split(pt, cuda_trace, name, w, h, passes, depth, contract="gpu", faithful=False):
    """The split of one render's whole-pass calls, each counted with the
    counting build on the call's own inputs: B1's (``cuda_trace.b1_split``)
    under the gpu contract, else the classic instance's
    (``cuda_trace.classic_split``); and the fog march's own
    (``cuda_trace.march_split``: the fog kernel's, or the march kernel's
    under faithful fog), None where the render marched no fog or the tree's
    counting build does not split it."""
    counted = []

    def hook(orig, a, k):
        classic = getattr(orig, "__name__", "") == "classic_render_cuda"
        counted.append((cuda_trace.classic_count_split if classic else cuda_trace.count_ops_split)(*a, **k))
        return orig(*a, **k)

    in_render(pt, cuda_trace, name, w, h, passes, depth, contract, faithful, hook)
    regen = contract == "gpu" and not faithful
    marched = [c.get("fog" if regen else "march") for c in counted]
    march = (cuda_trace.march_split([m for m in marched if m])
             if hasattr(cuda_trace, "march_split") and any(marched) else None)
    return (cuda_trace.b1_split(counted) if regen else cuda_trace.classic_split(counted)), march


def frame_trace_split(pt, cuda_trace, name, w, h, depth, contract, faithful):
    """B3's split (``cuda_trace.trace_split``) on the first chunk's primary
    rays of the frame, from the counting build, and its in-trace fog
    march's (None where the trace marches no fog)."""
    _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
    from path_trace_golang_tpu_torch.ops.vec import V3

    ro, rd, rst = primary_rays(pack, kw, 1, 0, min(pt.render.env_config.get_chunk_size(), w * h))
    counted = cuda_trace.trace_count_ops(V3(ro[:, 0], ro[:, 1], ro[:, 2]), V3(rd[:, 0], rd[:, 1], rd[:, 2]), rst,
                                         pack, kw["tcfg"])
    march = counted.get("march", counted)
    fog = march is not None and march["shadow_lanes"] + march["march_hit_cycles"] > 0
    return cuda_trace.trace_split([counted]), (cuda_trace.march_split([march]) if fog else None)


def frame_kernel_times(pt, cuda_trace, name, w, h, passes, depth, contract, faithful):
    """``--render-only ... --kernels``: the frame's kernels alone, median
    milliseconds of CUDA events (see the module docstring)."""
    import torch
    from path_trace_golang_tpu_torch import integrator

    _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
    n = w * h
    chunk = min(pt.render.env_config.get_chunk_size(), n)
    window = contract == "gpu" and not faithful
    pass_ms, calls = render_kernel_ms(pt, cuda_trace, name, w, h, passes, depth, contract, faithful)
    shape = f"a window of {passes} passes" if window else f"{passes} passes"
    out = {"pass_ms": pass_ms, "pass_is": f"the whole-pass calls of one render ({shape}, {calls} calls)"}
    ro, rd, rst = primary_rays(pack, kw, 1, 0, chunk)
    # each kernel's own device time in a render (torch.profiler), median of 3 renders
    per_render = [device_ms(lambda: in_render(pt, cuda_trace, name, w, h, passes, depth, contract, faithful,
                                              lambda o, a, k: o(*a, **k)), FRAME_KERNELS) for _ in range(3)]
    out["kernel_device_ms"] = {k: statistics.median(r[k] for r in per_render) for k in FRAME_KERNELS
                               if all(r[k] is not None for r in per_render)}
    out["trace_ms"] = cuda_time_ms(lambda: integrator.trace(ro, rd, rst, pack, kw["tcfg"]), 5)
    out["trace_rays"] = chunk
    if hasattr(cuda_trace, "trace_split"):
        out.update(trace_parts(cuda_trace, integrator, pack, kw["tcfg"], ro, rd, rst))
    if pack.paged is not None:
        wo, wd = walk_rays(pack, w, h, n, 0, seed=0)
        far = torch.full((n,), 1e20, device=DEVICE)
        out["walk_closest_ms"] = cuda_time_ms(lambda: cuda_trace.paged_traverse(wo, wd, pack, 0.001, far), 5)
        out["walk_any_ms"] = cuda_time_ms(lambda: cuda_trace.paged_occluded(wo, wd, pack, 0.001, far, far < 0), 5)
    return out


def trace_parts(cuda_trace, integrator, pack, cfg, ro, rd, rst):
    """B3's call taken apart, on the rays that ``--kernels`` times trace() on
    (CUDA events, median of 5): pt_trace_grid alone on inputs made once
    (``trace_kernel_ms``), the launches that one call of trace() makes
    besides B3's own kernels, by name (torch.profiler), and the longest
    path's ray traced alone (``trace_longest_ms``: the least time the call
    can take, since no ray's path runs faster than alone on the card), with
    its length and the number of rays that share it."""
    import torch
    from path_trace_golang_tpu_torch.ops.vec import V3

    o3, d3 = V3(ro[:, 0], ro[:, 1], ro[:, 2]), V3(rd[:, 0], rd[:, 1], rd[:, 2])
    lib, args, keep = cuda_trace._trace_call(False, o3, d3, rst, pack, cfg, None)
    if lib.pt_trace_grid(*args) != 0:
        raise RuntimeError("pt_trace_grid refused the call")
    kernel_ms = cuda_time_ms(lambda: lib.pt_trace_grid(*args), 5)
    lengths = keep[2]
    at = int(torch.argmax(lengths))
    one = lambda v: V3(v.x[at:at + 1].clone(), v.y[at:at + 1].clone(), v.z[at:at + 1].clone())  # noqa: E731
    lib1, args1, _keep1 = cuda_trace._trace_call(False, one(o3), one(d3), rst[at:at + 1].clone(), pack, cfg, None)
    longest_ms = cuda_time_ms(lambda: lib1.pt_trace_grid(*args1), 5)
    own = ("trace_grid_kernel", "trace_march_kernel", "trace_bounce_kernel", "advance_kernel")
    return {
        "trace_kernel_ms": kernel_ms,
        "trace_wrapper_launches": {k: v for k, v in device_launches(
            lambda: integrator.trace(ro, rd, rst, pack, cfg)).items() if not any(x in k for x in own)},
        "trace_longest_ms": longest_ms,
        "trace_longest_path": int(lengths[at]),
        "trace_rays_at_longest": int((lengths == lengths[at]).sum()),
        "trace_ptxas": {**ptxas_of(cuda_trace, "classic", "trace_"), **ptxas_of(cuda_trace, "classic", "advance_")},
    }


def device_launches(fn):
    """{name: count} of the device work (kernels, memsets, copies) that one
    call of ``fn`` launches, from torch.profiler's trace ({} where the
    profiler fails)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"    torch.profiler failed: {e}", flush=True)
        return {}
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.count for e in prof.key_averages() if getattr(e, "device_type", None) == cuda}


def walk_rays(pack, w, h, n_cam, n_rand, seed):
    """Rays for the walk alone: ``n_cam`` camera rays through pixel centres
    of a w x h frame (strided over it) and ``n_rand`` rays with origins in a
    box around the scene and directions uniform on the sphere (numpy, from
    ``seed``).  Returns (o V3, d V3) on the card."""
    import numpy as np
    import torch
    from path_trace_golang_tpu_torch.ops.camera import camera_basis
    from path_trace_golang_tpu_torch.ops.vec import V3

    b = camera_basis(pack.cam, w, h)
    idx = torch.arange(n_cam, device=DEVICE, dtype=torch.int64) * max(1, (w * h) // max(n_cam, 1))
    u = ((idx % w).float() + 0.5) / float(max(w - 1, 1))
    v = (float(h - 1) - torch.div(idx, w, rounding_mode="floor").float() + 0.5) / float(max(h - 1, 1))
    d = V3(b[3] + u * b[6] + v * b[9] - b[0], b[4] + u * b[7] + v * b[10] - b[1],
           b[5] + u * b[8] + v * b[11] - b[2]).normalize()
    o = V3.broadcast_scalars(u, b[0], b[1], b[2])
    if n_rand:
        rng = np.random.default_rng(seed)
        ro = (rng.uniform(-2.5, 2.5, size=(n_rand, 3)) + np.array([0.0, 1.0, 0.0])).astype(np.float32)
        rd = rng.normal(size=(n_rand, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=1, keepdims=True)
        ro, rd = torch.from_numpy(ro).to(DEVICE), torch.from_numpy(rd).to(DEVICE)
        o = V3(*(torch.cat([a, ro[:, k]]) for k, a in enumerate((o.x, o.y, o.z))))
        d = V3(*(torch.cat([a, rd[:, k]]) for k, a in enumerate((d.x, d.y, d.z))))
    return o, d


def walk_diff(k, p):
    """Closest-hit results of the walk, kernel ``k`` against plain version
    ``p``: the fields whose bits differ on some ray, and the largest |a-b|
    over t and the normal on the rays that hit."""
    import torch

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    fields = ("hit", "key", "page", "t", "nx", "ny", "nz", "mat", "obj")
    bad = [f for f in fields if not torch.equal(bits(getattr(k, f)), bits(getattr(p, f)))]
    hit = p.hit
    err = max(
        (torch.nan_to_num((getattr(k, f) - getattr(p, f)).abs()[hit], nan=float("inf")).max().item()
         if bool(hit.any()) else 0.0)
        for f in ("t", "nx", "ny", "nz")
    )
    return bad, err


def hold_walk(cuda_trace, tag, name, pack, o, d, seed):
    """The paged walk alone, kernel against plain version, bit for bit.
    Besides the whole batch, the first PARTIAL_RAYS rays alone (the launch's
    last warp then holds 17 rays: a partial working set of the cooperative
    walk) and the batch with every other ray skipped (closest hit: those
    lanes walk nothing but help their warp) or come in blocked (any hit:
    they do not enter the walk).  Returns (identical on every ray, largest
    |a-b| over t and the normal)."""
    import numpy as np
    import torch
    from path_trace_golang_tpu_torch.ops import bvh
    from path_trace_golang_tpu_torch.ops.vec import V3

    n = o.x.numel()
    part = min(n, PARTIAL_RAYS)
    part -= 15 if part % 32 == 0 else 0  # a smaller batch: still a partial last warp
    head = lambda v: V3(v.x[:part], v.y[:part], v.z[:part])  # noqa: E731
    rng = np.random.default_rng(seed)
    cu = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    start = cu(np.where(rng.random(n) < 0.5, rng.uniform(0.5, 6.0, n), 1e20).astype(np.float32))
    first_tri = pack.n_objects
    every_other = torch.arange(n, device=DEVICE) % 2 == 1
    cases = {
        "open": (o, d, dict(best_t=torch.full((n,), 1e20, device=DEVICE))),
        "bounded": (o, d, dict(
            best_t=start, t_max=cu(rng.uniform(2.0, 50.0, n).astype(np.float32)),
            exclude_obj=cu(rng.integers(first_tri, first_tri + pack.n_triangles, n).astype(np.int32)),
            skip=cu(rng.random(n) < 0.2),
        )),
        f"partial warp ({part} rays)": (head(o), head(d), dict(best_t=start[:part])),
        "every other ray skipped": (o, d, dict(best_t=start, skip=every_other)),
    }
    same, worst = True, 0.0
    for case, (co, cd, kw) in cases.items():
        k = cuda_trace.paged_traverse(co, cd, pack, 0.001, **kw)
        torch.cuda.synchronize()
        p = bvh.traverse_triangles_paged(co, cd, pack, 0.001, **kw)
        torch.cuda.synchronize()
        bad, err = walk_diff(k, p)
        hit = p.hit
        worst = max(worst, err)
        print(
            f"[{tag}] walk alone, {name} ({pack.paged.n_pages} pages), closest hit, {case}: {co.x.numel()} rays, "
            f"{int(hit.sum())} hits, {p.visits} pages swept by the plain version, fields that differ: "
            f"{bad or 'none'}, max |a-b| over t and normal {err:.4g}",
            flush=True,
        )
        same = same and not bad
    t_max = cu(rng.uniform(0.5, 8.0, n).astype(np.float32))
    any_cases = {
        "20% come in blocked": (o, d, t_max, cu(rng.random(n) < 0.2)),
        f"partial warp ({part} rays)": (head(o), head(d), t_max[:part], torch.zeros(part, dtype=torch.bool,
                                                                                  device=DEVICE)),
        "every other ray comes in blocked": (o, d, t_max, every_other),
    }
    for case, (co, cd, tm, blocked0) in any_cases.items():
        kb = cuda_trace.paged_occluded(co, cd, pack, 0.001, tm, blocked0)
        torch.cuda.synchronize()
        pb = bvh.occluded_triangles_paged(co, cd, pack, 0.001, tm, blocked0)
        torch.cuda.synchronize()
        differ = int((kb != pb).sum())
        print(
            f"[{tag}] walk alone, {name}, any hit, {case}: {co.x.numel()} rays, {int(blocked0.sum())} come in "
            f"blocked, {int(pb.sum())} blocked, rays that differ: {differ}",
            flush=True,
        )
        same = same and differ == 0
    return same, worst


def hold_trace(pt, cuda_trace, tag, name, contract, faithful, depth, n_cam, n_rand, seed, inactive=0.0):
    """Kernel B3 against its plain version on one batch of camera and random
    rays with random states (numpy, from ``seed``), ``inactive`` of the lanes
    masked off: radiance, state and segments bit for bit.  Returns
    (identical, largest |a-b| of the radiance, seconds of the plain version)."""
    import numpy as np
    import torch

    _sc, pack, kw = scene_setup(pt, name, 512, 512, depth, contract, faithful)
    cfg = kw["tcfg"]
    o, d = walk_rays(pack, 512, 512, n_cam, n_rand, seed)
    n = o.x.numel()
    rng = np.random.default_rng(seed + 1)
    state = torch.from_numpy(rng.integers(0, 2**32, size=n, dtype=np.int64)).to(DEVICE)
    active = torch.from_numpy(rng.random(n) >= inactive).to(DEVICE) if inactive else None
    rk, sk, gk = cuda_trace.trace_grid_cuda(o, d, state, pack, cfg, active)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp, sp, gp = cuda_trace.trace_grid_plain(o, d, state, pack, cfg, active)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    a, b = rk.to_rows(), rp.to_rows()
    same_rad = torch.equal(a.view(torch.int32), b.view(torch.int32))
    same = same_rad and torch.equal(sk, sp) and int(gk) == int(gp)
    err = torch.nan_to_num((a - b).abs(), nan=float("inf")).max().item()
    print(
        f"[{tag}] B3 {name}, {contract} contract{', in-trace fog' if cfg.enable_fog_march and cfg.fog_in_trace else ''}"
        f", depth {depth}: {n} rays{f' ({int(active.sum())} active)' if active is not None else ''}, segments "
        f"{int(gk)} vs {int(gp)}, radiance bit-identical {same_rad}, lanes whose state differs "
        f"{int((sk != sp).sum())}, max |a-b| {err:.4g}; plain version {plain_s:.1f} s",
        flush=True,
    )
    return same, err, plain_s


def primary_rays(pack, kw, frame_seed, start, count):
    """The first sample's camera rays and states of ``count`` lanes from
    ``start`` of a frame, as the classic whole-pass kernel makes them
    (render.pass_body_grid): the lane seed, two jitter draws, the stratum,
    the lens draws.  Returns (orig [n,3], dir [n,3], state) on the card."""
    import torch
    from path_trace_golang_tpu_torch.ops.camera import camera_rays
    from path_trace_golang_tpu_torch.ops.rng import LaneRng, seed_lanes

    w, h = kw["width"], kw["height"]
    px, py = lanes(w, h, start, count)
    rng = LaneRng(seed_lanes(px, py, frame_seed))
    jx, jy = rng.next(), rng.next()
    u = (px.float() + jx) * (1.0 / (w - 1))
    v = ((h - 1) - py.float() + jy) * (1.0 / (h - 1))
    o, d = camera_rays(u, v, pack.cam, w, h, rng, kw["has_aperture"], pack.lens_disk)
    return o.to_rows(), d.to_rows(), rng.state


def ptxas_lines(cuda_trace):
    return [f"{src}: {ln.strip()}" for src, log in cuda_trace.BUILD_LOG.items() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def ptxas_of(cuda_trace, source, kernel):
    """ptxas' report of the normal build of ``source`` for the instances of
    ``kernel`` (a part of the mangled name): {mangled name: {registers,
    stack_frame, spill_stores, spill_loads}}."""
    import re

    out, name = {}, None
    for ln in cuda_trace.BUILD_LOG.get(source, "").splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", ln)
        if entry:
            name = entry.group(1) if kernel in entry.group(1) else None
        elif name and "bytes stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out.setdefault(name, {}).update(zip(("stack_frame", "spill_stores", "spill_loads"), nums))
        elif name and "registers" in ln:
            out.setdefault(name, {})["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def device_ms(fn, kernels):
    """The device time of the kernels whose names hold each of ``kernels``
    that one call of ``fn`` launches, in ms, summed from torch.profiler's
    trace: a dict, None for a name that the trace holds none of (or all
    None where the profiler fails)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # a measurement only: the events' times stand without it
        print(f"    torch.profiler failed: {e}", flush=True)
        return dict.fromkeys(kernels)
    out = {}
    for kernel in kernels:
        us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) for e in prof.key_averages()
                 if kernel in e.key)
        out[kernel] = us / 1e3 if us > 0 else None
    return out


def cuda_time_ms(fn, reps):
    """Median over ``reps`` of the device time of ``fn()`` in ms (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


T1_CHECK_ITERS = 4  # iterations of T1's check: 256 ops a class (the hash 64 rounds), a known error bound
T1_EXACT = ("hash", "select", "sqrt", "divide", "fma")  # IEEE-exact on both sides
T1_RTOL = 1e-5  # ffma (the plain version rounds twice, via float64), rsqrt, exp, sin
T1_CHAIN = 10  # dependent launches per timed T1 measurement
PROBE_SOURCE = "path_trace_golang_tpu_torch/csrc/probes.cu"


T3_SWEEP_PAGES = (0, 1, 2, 5, 10, 20, 40, 80)  # T3's time against p: the intercept is the launch, the slope a tile
T3_SWEEP_LAYOUTS = ("a", "d")  # 16 KB and 4 KB tiles


def tile_fetch_sweep(probes, fetch_probe, timing, grids, dev, card):
    """T3's time against p on both grids, layouts a and d, by the probe's own
    timing (ms_per_launch, 10 launches); the least-squares line through each
    (intercept: the launch; slope: a tile), and from the full-card grid's
    slope the bytes an SM takes in a second (every block stages each tile
    whole, blocks spread evenly over the SMs)."""
    import numpy as np
    import torch

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"pages": list(T3_SWEEP_PAGES), "ms": {}, "intercept_ms": {}, "slope_us_per_tile": {}, "sm_gbps": {}}
    for grid, blocks in grids.items():
        x = torch.zeros((32 * blocks, 128), device=dev)
        for layout in T3_SWEEP_LAYOUTS:
            table = fetch_probe.make_table(layout, 0, str(dev))
            ms = [timing.ms_per_launch(lambda: probes.tile_fetch(layout, table, x, p), 10, dev)
                  for p in T3_SWEEP_PAGES]
            slope, icept = np.polyfit(np.array(T3_SWEEP_PAGES, float), np.array(ms), 1)
            key = f"{grid}:{layout}"
            out["ms"][key] = ms
            out["intercept_ms"][key] = float(icept)
            out["slope_us_per_tile"][key] = float(slope) * 1e3
            rate = ""
            if grid == "full-card":
                out["sm_gbps"][layout] = blocks * probes.TILE_ELEMS[layout] * 4 / (slope * 1e-3) / sms / 1e9
                rate = f"; {out['sm_gbps'][layout]:.1f} GB/s into each of {sms} SMs"
            print(f"[22] T3 sweep {grid} ({blocks} blocks) layout {layout}: ms at p = {list(T3_SWEEP_PAGES)}: "
                  f"{[round(v, 5) for v in ms]}; intercept {icept * 1e3:.2f} us, slope {slope * 1e3:.3f} us a "
                  f"tile{rate} | card {card}", flush=True)
    return out


def probe_phases(card):
    """Phases 20-23: the perf probes T1-T4 (ops/probes.py, csrc/probes.cu).
    Each kernel is held to its plain version on the card, then the probe's
    own entry point (path_trace_golang_tpu_torch/tools/perf/*.py) runs with
    the launch counts set to 0 just before and read just after.  Returns the
    kernels line's rows, or None after a failure (reported on stderr)."""
    import numpy as np
    import torch
    from path_trace_golang_tpu_torch.ops import probes
    from path_trace_golang_tpu_torch.tools.perf import fetch_probe, fetch_probe2, microbench, paged_probe, timing

    t_probes = time.perf_counter()
    dev = torch.device(DEVICE)

    def drive(tag, key, fn):
        for c in probes.PROBE_LAUNCHES:
            probes.PROBE_LAUNCHES[c] = probes.PROBE_PLAIN_CALLS[c] = 0
        res = fn()
        torch.cuda.synchronize()
        launches, plain = probes.PROBE_LAUNCHES[key], sum(probes.PROBE_PLAIN_CALLS.values())
        print(f"[{tag}] {key} launches on the probe's own path: {launches}, plain calls: {plain}", flush=True)
        return res, (launches if launches > 0 and plain == 0 else None)

    def fail(tag, what):
        print(f"[{tag}] FAIL: {what}", file=sys.stderr)

    def i32(t):
        return t.contiguous().view(torch.int32)

    # ---- 20. T1, op chains: every class against its plain version at a short length, both shapes
    shapes = microbench.shapes(dev)
    t1_err = 0.0
    for shape, (n, ilp) in shapes.items():
        x = torch.from_numpy(np.random.RandomState(20).uniform(0.1, 2.0, n).astype(np.float32)).to(dev)
        for kind in probes.OP_KINDS:
            k = probes.op_chain(kind, x, T1_CHECK_ITERS, ilp)
            p = probes.op_chain_plain(kind, x, T1_CHECK_ITERS)
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            t1_err = max(t1_err, err)
            ok = torch.equal(i32(k), i32(p)) if kind in T1_EXACT else bool(((k - p).abs() <= T1_RTOL * p.abs()).all())
            print(f"[20] T1 {kind:6s} {shape} ({n} elements, {ilp} chain(s) a thread, {T1_CHECK_ITERS} iterations): "
                  f"max |a-b| {err:.3g}, bit-equal {torch.equal(i32(k), i32(p))}", flush=True)
            if not ok:
                fail("20", f"T1 {kind} disagrees with its plain version")
                return None
    # the IEEE-exact classes at the probe's full length: every step rounds once on both sides
    n_block = shapes["tpu-block"][0]
    x = torch.from_numpy(np.random.RandomState(20).uniform(0.1, 2.0, n_block).astype(np.float32)).to(dev)
    for kind in T1_EXACT:
        t0 = time.perf_counter()
        k = probes.op_chain(kind, x, microbench.ITERS, 1)
        p = probes.op_chain_plain(kind, x, microbench.ITERS)
        same = torch.equal(i32(k), i32(p))
        print(f"[20] T1 {kind:6s} tpu-block ({n_block} elements, {microbench.ITERS} iterations): bit-equal {same}, "
              f"finite {bool(torch.isfinite(k).all())} ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not same:
            fail("20", f"T1 {kind} disagrees with its plain version at full length")
            return None
    n_card, ilp_card = shapes["full-card"]
    x_card = torch.full((n_card,), 0.73, device=dev)
    t1_plain_ms = cuda_time_ms(lambda: probes.op_chain_plain("ffma", x_card, T1_CHECK_ITERS), 1)
    t1_small_ms = cuda_time_ms(lambda: probes.op_chain("ffma", x_card, T1_CHECK_ITERS, ilp_card), 3)
    t1, t1_launches = drive("20", "op_chain", lambda: microbench.run(DEVICE, microbench.ITERS, T1_CHAIN))
    if t1_launches is None or not all(r["finite"] for sh in t1.values() for r in sh.values()):
        fail("20", "T1's path did not run on its kernel alone, or a chain came out non-finite")
        return None
    # the loop is really there: half the iterations take about half the time
    half = cuda_time_ms(lambda: probes.op_chain("ffma", x_card, microbench.ITERS // 2, ilp_card), 3)
    ratio = t1["full-card"]["ffma"]["ms"] / half
    top = t1["full-card"]
    flops = 2 * top["ffma"]["ops"]  # one fused multiply-add is 2 flops of the f32 peak
    t1_bound = max(flops / PEAK_F32_FLOPS, n_card * 8 / PEAK_BYTES) * 1e3
    print(f"[20] T1 ffma full card: {top['ffma']['ms']:.4f} ms a launch of {microbench.ITERS} iterations, "
          f"{half:.4f} ms at half as many (ratio {ratio:.2f}); bound {t1_bound:.4f} ms ({flops:.6g} flops), "
          f"{2 * top['ffma']['gops'] / 1e3:.2f} TFLOP/s; fma (FMUL + FADD) {top['fma']['gops'] / 1e3:.2f} Top/s "
          f"against ffma {top['ffma']['gops'] / 1e3:.2f} | card {card}", flush=True)
    if not 1.6 <= ratio <= 2.4:
        fail("20", "T1's time does not follow its iterations: the loop was not compiled as written")
        return None

    # ---- 21. T2, the paged sweep: every variant against its plain version on all rays, keys bit for bit
    pg, tiles, boxes, real_boxes = paged_probe.build_table(device=DEVICE)
    n_rays = paged_probe.ROWS * paged_probe.N_BLOCKS * paged_probe.LANE
    t2_plain_ms = t2_small_ms = None
    for kind in paged_probe.KINDS:
        rays = paged_probe.packets(kind, device=DEVICE)
        keys = {}
        for variant in probes.PAGED_VARIANTS:
            bx = real_boxes if variant == "real" else boxes
            k = probes.paged_probe(variant, tiles, bx, rays, 1)
            pbox = []
            p_ms = cuda_time_ms(lambda: pbox.append(probes.paged_probe_plain(variant, tiles, bx, rays, 1)), 1)
            same = torch.equal(k, pbox[0])
            keys[variant] = k
            print(f"[21] T2 {kind} {variant}: {n_rays} rays, one traversal, bit-identical {same}; plain version "
                  f"{p_ms:.1f} ms", flush=True)
            if not same:
                fail("21", f"T2 {variant} disagrees with its plain version")
                return None
            if kind == "incoherent" and variant == "dense":
                t2_plain_ms = p_ms
                t2_small_ms = cuda_time_ms(lambda: probes.paged_probe(variant, tiles, bx, rays, 1), 3)
        if not (torch.equal(keys["all"], keys["dense"]) and torch.equal(keys["all"], keys["gather"])):
            fail("21", "T2's all, dense and gather keys differ")
            return None
    # the chained traversals of one launch, at the probe's own REPS
    rays = paged_probe.packets("incoherent", device=DEVICE)
    for variant in probes.PAGED_VARIANTS:
        t0 = time.perf_counter()
        bx = real_boxes if variant == "real" else boxes
        same = torch.equal(probes.paged_probe(variant, tiles, bx, rays, paged_probe.REPS),
                           probes.paged_probe_plain(variant, tiles, bx, rays, paged_probe.REPS))
        print(f"[21] T2 incoherent {variant}: {n_rays} rays, {paged_probe.REPS} chained traversals, bit-identical "
              f"{same} ({time.perf_counter() - t0:.1f} s)", flush=True)
        if not same:
            fail("21", f"T2 {variant} disagrees with its plain version at {paged_probe.REPS} traversals")
            return None
    t2, t2_launches = drive("21", "paged_probe", lambda: paged_probe.run(DEVICE))
    if t2_launches is None:
        fail("21", "T2's path did not run on its kernel alone")
        return None
    t2_ops = {v: probes.paged_probe_count_ops(v, tiles, real_boxes if v == "real" else boxes, rays,
                                              paged_probe.REPS) for v in probes.PAGED_VARIANTS}
    t2_bytes = (tiles.numel() + boxes.numel() + rays.numel() + n_rays) * 4
    t2_bound = {v: max(o / PEAK_F32_FLOPS, t2_bytes / PEAK_BYTES) * 1e3 for v, o in t2_ops.items()}
    print(f"[21] T2 incoherent, {paged_probe.REPS} traversals: f32 operations by variant (counting build) "
          f"{ {v: f'{o:.4g}' for v, o in t2_ops.items()} }; bounds (ms) { {v: round(b, 5) for v, b in t2_bound.items()} }"
          f" | card {card}", flush=True)
    # the row's bound: the fewest operations that produce these keys (all, dense and gather give the same keys)
    t2_need = min(t2_ops[v] for v in ("all", "dense", "gather"))
    t2_row_bound = max(t2_need / PEAK_F32_FLOPS, t2_bytes / PEAK_BYTES) * 1e3

    # ---- 22. T3, page-tile fetch by layout: against the plain version bit for bit, both grids, at the tool's
    # P and at the page counts around the kernel's ring of stages (p = 0, 1, K - 1, K, K + 1)
    grids = {"tpu-grid": fetch_probe.N_BLOCKS, "full-card": timing.full_card_blocks(dev)}
    stages = probes.TILE_STAGES
    t3_pages = sorted({0, 1, stages - 1, stages, stages + 1, fetch_probe.P})
    for grid, blocks in grids.items():
        x = torch.from_numpy(np.random.RandomState(22).uniform(-1, 1, (32 * blocks, 128)).astype(np.float32)).to(dev)
        for layout in probes.TILE_LAYOUTS:
            table = fetch_probe.make_table(layout, 0, DEVICE)
            for p in t3_pages:
                if not torch.equal(i32(probes.tile_fetch(layout, table, x, p)),
                                   i32(probes.tile_fetch_plain(layout, table, x, p))):
                    fail("22", f"T3 layout {layout} on {blocks} blocks at p = {p} disagrees with its plain version")
                    return None
            print(f"[22] T3 layout {layout} {grid} ({blocks} blocks): bit-identical at p = {t3_pages} (a ring of "
                  f"K = {stages} tiles)", flush=True)
    xa = torch.zeros((32 * fetch_probe.N_BLOCKS, 128), device=dev)
    ta = fetch_probe.make_table("a", 0, DEVICE)
    t3_plain_ms = cuda_time_ms(lambda: probes.tile_fetch_plain("a", ta, xa, fetch_probe.P), 3)
    t3, t3_launches = drive("22", "tile_fetch", lambda: fetch_probe.run(DEVICE))
    if t3_launches is None:
        fail("22", "T3's path did not run on its kernel alone")
        return None
    t3_sweep = tile_fetch_sweep(probes, fetch_probe, timing, grids, dev, card)
    # thread 0's loop by step (counting build), a tile on the TPU grid: what the 16-block time of a tile reads
    t3_split = {}
    for layout in T3_SWEEP_LAYOUTS:
        table = fetch_probe.make_table(layout, 0, DEVICE)
        sp = probes.tile_fetch_split(layout, table, xa, fetch_probe.P)
        tiles = sp["blocks"] * fetch_probe.P
        t3_split[layout] = {k: sp[k] / tiles for k in probes.T3_STEPS + ("loop",)}
        print(f"[22] T3 layout {layout}'s split (counting build, {sp['blocks']} blocks, {fetch_probe.P} tiles), "
              "thread 0's clock cycles a tile: "
              + ", ".join(f"{k} {v:.1f}" for k, v in t3_split[layout].items()) + f" | card {card}", flush=True)

    def fetch_bound(table_bytes, blocks):
        return (table_bytes + 2 * 32 * 128 * 4 * blocks) / PEAK_BYTES * 1e3  # table read, x read, out written

    t3_bound = fetch_bound(ta.numel() * 4, fetch_probe.N_BLOCKS)
    # the floor that the probe's contract allows: every block stages every tile whole, so a block's P tiles
    # pass through its SM at no more than the rate one SM takes bytes in, the most that the full-card grid
    # shows (the slope of its sweep, the faster layout); beside it the launch, this kernel at p = 0 on 16 blocks
    sm_gbps = max(t3_sweep["sm_gbps"].values())
    t3_floor = {lay: fetch_probe.P * probes.TILE_ELEMS[lay] * 4 / (sm_gbps * 1e9) * 1e3
                + t3_sweep["ms"][f"tpu-grid:{lay}"][0] for lay in T3_SWEEP_LAYOUTS}
    print(f"[22] T3 floor on 16 blocks (a block's tiles at {sm_gbps:.1f} GB/s into its SM, plus the launch at "
          f"p = 0): { {k: round(v, 6) for k, v in t3_floor.items()} } ms | card {card}", flush=True)

    # ---- 23. T4, the fetch taken apart: against the plain version bit for bit, both grids
    table = fetch_probe2.make_table(0, DEVICE)
    for grid, blocks in grids.items():
        x = torch.from_numpy(np.random.RandomState(23).uniform(-1, 1, (32 * blocks, 128)).astype(np.float32)).to(dev)
        for variant in probes.FETCH_VARIANTS:
            same = torch.equal(i32(probes.fetch_attrib(variant, table, x, fetch_probe2.P)),
                               i32(probes.fetch_attrib_plain(variant, table, x, fetch_probe2.P)))
            print(f"[23] T4 {variant} {grid} ({blocks} blocks): bit-identical {same}", flush=True)
            if not same:
                fail("23", f"T4 {variant} disagrees with its plain version")
                return None
    t4_plain_ms = cuda_time_ms(lambda: probes.fetch_attrib_plain("dyn_vec", table, xa, fetch_probe2.P), 3)
    t4, t4_launches = drive("23", "fetch_attrib", lambda: fetch_probe2.run(DEVICE))
    if t4_launches is None:
        fail("23", "T4's path did not run on its kernel alone")
        return None
    t4_bound = fetch_bound(table.numel() * 4, fetch_probe2.N_BLOCKS)
    t4_bound_full = fetch_bound(table.numel() * 4, grids["full-card"])
    # the one PyTorch call that computes dyn_vec's column sums: a yardstick only, the port never calls it
    t4_lib_ms = timing.ms_per_launch(lambda: table.view(-1, 128).sum(0), 10, dev)
    print(f"[23] library call table.view(-1, 128).sum(0): {t4_lib_ms:.4f} ms; dyn_vec on 16 blocks "
          f"{t4[('tpu-grid', 'dyn_vec')]['ms']:.4f} ms | card {card}", flush=True)
    print(f"[20-23] the probes in {time.perf_counter() - t_probes:.1f} s | card {card}", flush=True)

    def per(res, key_of):
        return {key_of(k): round(v["ms"], 6) for k, v in res.items()}

    return [{
        "name": "op_chain",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": "tools/perf/microbench.py:45",
        "launches": t1_launches,
        "launches_are": "launches of pt_op_chain by the T1 tool (microbench.run): 9 classes x 2 shapes, a warm-up "
                        f"and {T1_CHAIN} chained launches each",
        "max_abs_err": t1_err,
        "max_abs_err_over": f"every class, {T1_CHECK_ITERS} iterations, on {n_block} and {n_card} "
                            f"elements; hash, select, sqrt, divide and fma bit for bit, ffma, rsqrt, exp and sin "
                            f"within rel {T1_RTOL}; the bit-for-bit classes also at {microbench.ITERS} iterations "
                            f"on {n_block} elements",
        "ms": top["ffma"]["ms"],
        "plain_ms": t1_plain_ms,
        "bound_ms": t1_bound,
        "bound_by": "operations",
        "library_ms": None,
        "shape": f"ffma class, {n_card} elements ({ilp_card} chains a thread, the full card), "
                 f"{microbench.ITERS} iterations of 64",
        "plain_shape": f"ffma class, {n_card} elements, {T1_CHECK_ITERS} iterations",
        "kernel_ms_at_plain_shape": t1_small_ms,
        "ms_by_shape_and_class": {sh: {c: round(r["ms"], 6) for c, r in res.items()} for sh, res in t1.items()},
        "gops_by_shape_and_class": {sh: {c: round(r["gops"], 3) for c, r in res.items()} for sh, res in t1.items()},
        "fma_slot_equivalents_vs_ffma": {c: round(top["ffma"]["gops"] / r["gops"], 3) for c, r in top.items()},
        "fma_slot_equivalents_vs_fma": {c: round(top["fma"]["gops"] / r["gops"], 3) for c, r in top.items()},
    }, {
        "name": "paged_probe",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": "tools/perf/paged_probe.py:247",
        "launches": t2_launches,
        "launches_are": "launches of pt_paged_probe by the T2 tool (paged_probe.run): 5 variants x 2 packets, a "
                        "warm-up and 5 timed launches each",
        "max_abs_err": 0.0,
        "max_abs_err_over": f"every variant on both packets, {n_rays} rays, one traversal, and on the incoherent "
                            f"packet at {paged_probe.REPS} traversals; keys bit for bit, and all = dense = gather",
        "ms": t2[("incoherent", "dense")]["ms"],
        "plain_ms": t2_plain_ms,
        "bound_ms": t2_row_bound,
        "bound_by": "operations" if t2_need / PEAK_F32_FLOPS >= t2_bytes / PEAK_BYTES else "bytes",
        "bound_ops": t2_need,
        "bound_ops_are": "the f32 operations of the fewest-operation variant that gives these keys (gather: each "
                         "ray sweeps only its own wanted pages), not those dense executes (ops_by_variant_incoherent)",
        "library_ms": None,
        "shape": f"dense variant, incoherent packet, {n_rays} rays, {paged_probe.REPS} traversals, "
                 f"{pg.n_pages} pages of 128 triangles",
        "plain_shape": f"dense variant, incoherent packet, {n_rays} rays, one traversal",
        "kernel_ms_at_plain_shape": t2_small_ms,
        "ms_by_packet_and_variant": per(t2, lambda k: f"{k[0]}:{k[1]}"),
        "ops_by_variant_incoherent": t2_ops,
        "bound_ms_by_variant_incoherent": t2_bound,
    }, {
        "name": "tile_fetch",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": "tools/perf/fetch_probe.py:69",
        "launches": t3_launches,
        "launches_are": "launches of pt_tile_fetch by the T3 tool (fetch_probe.run): 4 layouts x 2 grids, a "
                        "warm-up and 10 timed launches each",
        "max_abs_err": 0.0,
        "max_abs_err_over": f"every layout on both grids at p = 0, 1, K - 1, K, K + 1 and {fetch_probe.P} (K the "
                            "tiles of the kernel's ring), bit for bit",
        "ms": t3[("tpu-grid", "a")]["ms"],
        "plain_ms": t3_plain_ms,
        "bound_ms": t3_bound,
        "bound_by": "bytes",
        "library_ms": None,
        "floor_ms": t3_floor["a"],
        "floor_is": "a block's P tiles over the per-SM ingest rate that this run's full-card grid shows (the "
                    "slope of its sweep over p, the faster of layouts a and d), plus this kernel's launch at p = 0 "
                    "on 16 blocks: the least time under the probe's contract that every block stages every tile "
                    "whole",
        "sm_ingest_gbps": sm_gbps,
        "floor_ms_by_layout": t3_floor,
        "ring_stages": stages,
        "split_cycles_a_tile": t3_split,
        "shape": f"layout a (P,128,32), {fetch_probe.P} tiles of 16 KB, {fetch_probe.N_BLOCKS} blocks of 32x128",
        "ms_by_grid_and_layout": per(t3, lambda k: f"{k[0]}:{k[1]}"),
        "sweep": t3_sweep,
    }, {
        "name": "fetch_attrib",
        "route": "cuda",
        "source": PROBE_SOURCE,
        "replaces": "tools/perf/fetch_probe2.py:46",
        "launches": t4_launches,
        "launches_are": "launches of pt_fetch_attrib by the T4 tool (fetch_probe2.run): 5 variants x 2 grids, a "
                        "warm-up and 10 timed launches each",
        "max_abs_err": 0.0,
        "max_abs_err_over": "every variant on both grids, bit for bit",
        "ms": t4[("tpu-grid", "dyn_vec")]["ms"],
        "plain_ms": t4_plain_ms,
        "bound_ms": t4_bound,
        "bound_by": "bytes",
        "library_ms": t4_lib_ms,
        "library_call": "table.view(-1, 128).sum(0), the column sums of dyn_vec",
        "shape": f"dyn_vec, table f32[{fetch_probe2.P * 32},128], {fetch_probe2.N_BLOCKS} blocks of 32x128",
        "full_card_bound_ms": t4_bound_full,
        "full_card_shape": f"{grids['full-card']} blocks of 32x128",
        "ms_by_grid_and_variant": per(t4, lambda k: f"{k[0]}:{k[1]}"),
    }]


REPRO_SOURCE = "path_trace_golang_tpu_torch/csrc/repro.cu"
REPRO_GROUPS = (1, 2, 4, 8)  # G of T7's and T8's comparisons and tool runs
T6_CHECK_ROUNDS = (1, 3)  # rounds of T6's bit-for-bit comparisons (32 and 96 products)
T6_ROUNDS = 16384  # the JAX script's default
T6_SPLIT_ROUNDS = 256  # rounds of T6's step split in the counting build


def repro_phases(card):
    """Phases 24-27: the Mosaic repros T5-T8 (ops/repro.py, csrc/repro.cu).
    Each kernel is held to its plain version on the card bit for bit, then
    the repro's own entry point (path_trace_golang_tpu_torch/tools/repro/*.py)
    runs with the launch counts set to 0 just before and read just after.
    Returns the kernels line's rows, or None after a failure (reported on
    stderr)."""
    import numpy as np
    import torch
    from path_trace_golang_tpu_torch.ops import cuda_trace, repro
    from path_trace_golang_tpu_torch.tools.perf import timing
    from path_trace_golang_tpu_torch.tools.repro import group_rows_relayout as t8
    from path_trace_golang_tpu_torch.tools.repro import mosaic_cond_skip as t6
    from path_trace_golang_tpu_torch.tools.repro import mosaic_reshape_repro as t7
    from path_trace_golang_tpu_torch.tools.repro import window_slice_probe as t5

    t_repro = time.perf_counter()
    dev = torch.device(DEVICE)

    def drive(tag, key, fn, checks=0):
        """``checks``: the plain version's calls that the tool makes to hold the kernel to it."""
        for c in repro.REPRO_LAUNCHES:
            repro.REPRO_LAUNCHES[c] = repro.REPRO_PLAIN_CALLS[c] = 0
        res = fn()
        torch.cuda.synchronize()
        launches, plain = repro.REPRO_LAUNCHES[key], sum(repro.REPRO_PLAIN_CALLS.values())
        print(f"[{tag}] {key} launches on the repro's own path: {launches}, plain calls: {plain} (the tool's "
              f"checks: {checks})", flush=True)
        return res, (launches if launches > 0 and plain == checks else None)

    def fail(tag, what):
        print(f"[{tag}] FAIL: {what}", file=sys.stderr)

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

    def err(a, b):
        return float((a - b).abs().max())

    def same_or_both_nan(a, b):
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and same(a[~nan], b[~nan])

    # ---- 24. T5, the windowed gather: both layouts against the plain version, on the tool's pages and on two
    # sets whose window starts past 0 (floored; clamped to P - W, with pages outside the window)
    table, p_l, want = t5.make_inputs(DEVICE)
    rs = np.random.RandomState(24)
    page_sets = {"tool": p_l}
    for label, lo, hi in (("floored", 130, 450), ("clamped", 300, 512)):
        p = rs.randint(lo, hi, (1, t5.LANE)).astype(np.int32)
        p[0, ::9] = -1
        page_sets[label] = torch.from_numpy(p).to(dev)
    t5_err = 0.0
    for layout in repro.LAYOUTS:
        tab = t5.layout_table(table, layout)
        for label, pages in page_sets.items():
            k = repro.window_slice(tab, pages, layout)
            p = repro.window_slice_plain(tab, pages, layout)
            ok = same(k, p) and (label != "tool" or np.array_equal(k.cpu().numpy(), want))
            t5_err = max(t5_err, err(k, p))
            base = repro.window_base(pages.reshape(-1), t5.P)
            print(f"[24] T5 layout {layout}, {label} pages (window base {base}): bit-identical {ok}", flush=True)
            if not ok:
                fail("24", f"T5 layout {layout} disagrees with its plain version")
                return None
    # the special values: +-0, +-inf in and off the pages and past the window, NaN, a bf16 overflow, dead lanes,
    # pages past the window; bit for bit where the plain version gives a number, NaN where it gives NaN
    for case, (tab0, pages) in t5.special_inputs(DEVICE).items():
        for layout in repro.LAYOUTS:
            tab = t5.layout_table(tab0, layout)
            k, p = repro.window_slice(tab, pages, layout), repro.window_slice_plain(tab, pages, layout)
            if not same_or_both_nan(k, p):
                fail("24", f"T5 layout {layout} disagrees with its plain version on the {case} inputs")
                return None
        print(f"[24] T5 {case} inputs, layouts A and B: bit-identical where a number, NaN where NaN "
              f"({int(torch.isnan(p).sum())} NaN outputs)", flush=True)
    tab_a = t5.layout_table(table, "A")
    t5_plain_ms = cuda_time_ms(lambda: repro.window_slice_plain(tab_a, p_l, "A"), 3)
    t5_res, t5_launches = drive("24", "window_slice", lambda: t5.run(DEVICE))
    if t5_launches is None or not all(r["correct"] for r in t5_res.values()):
        fail("24", "T5's path did not run on its kernel alone, or came out wrong")
        return None
    t5_split = {}
    for layout in repro.LAYOUTS:
        sp = t5_split[layout] = repro.window_slice_split(t5.layout_table(table, layout), p_l, layout)
        total = sum(sp[k] for k in repro.T5_STAGES)
        print(f"[24] T5 layout {layout}'s split (counting build, the tool's pages, one launch of {sp['blocks']} "
              f"blocks), clock cycles summed over blocks: "
              + ", ".join(f"{k} {sp[k]} ({sp[k] / max(total, 1):.1%})" for k in repro.T5_STAGES)
              + f"; block ends spread over {sp['end_spread_us']:.3f} us of a {sp['span_us']:.3f} us span "
              f"| card {card}", flush=True)
    # the least work that gives the output is a read of the window, the pages and the output's write: a
    # non-finite entry anywhere in a row's window makes that row's output NaN for every lane that does not
    # select it (inf * 0 in the contraction), so every entry of the window can change the output
    t5_bytes = t5.R * repro.WINDOW * 2 + t5.LANE * 4 + t5.R * t5.LANE * 4
    t5_bound = t5_bytes / PEAK_BYTES * 1e3
    print(f"[24] T5 A {t5_res['A']['ms']:.4f} ms, B {t5_res['B']['ms']:.4f} ms a launch; bound {t5_bound:.6f} ms "
          f"({t5_bytes} bytes: the window, the pages, the output); plain {t5_plain_ms:.4f} ms | card {card}",
          flush=True)

    # ---- 25. T6, the guarded chain: cond true, cond false and the control against the plain version at a few
    # rounds, on the tool's ones and on a random b (where true must differ from false); then the tool
    a, ones = t6.make_inputs(DEVICE)
    b_rand = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (t6.N, t6.N)).astype(np.float32)).to(dev)
    flags = {v: torch.full((1,), v, dtype=torch.int32, device=dev) for v in (0, 1)}
    runs = {"true": (1, False), "false": (0, False), "ctrl": (1, True)}
    for bname, b in (("ones", ones), ("random", b_rand)):
        for rounds in T6_CHECK_ROUNDS:
            outs = {}
            for name, (flag, control) in runs.items():
                k = repro.cond_chain(flags[flag], a, b, rounds, control)
                p = repro.cond_chain_plain(flags[flag], a, b, rounds, control)
                if not same(k, p):
                    fail("25", f"T6 {name} on {bname} b, {rounds} rounds, disagrees with its plain version "
                               f"(max |a-b| {err(k, p):.3g})")
                    return None
                outs[name] = k
            moved = not same(outs["true"], outs["false"])
            print(f"[25] T6 {bname} b, {rounds} round(s): true, false, ctrl bit-identical to the plain version; "
                  f"true differs from false {moved}", flush=True)
            if bname == "random" and not moved:
                fail("25", "T6 cond-true equals cond-false on a random b: the chain did not run")
                return None
    t6_plain_ms = cuda_time_ms(lambda: repro.cond_chain_plain(flags[1], a, b_rand, 1), 1)
    t6_small_ms = cuda_time_ms(lambda: repro.cond_chain(flags[1], a, b_rand, 1), 3)
    t6_res, t6_launches = drive("25", "cond_chain", lambda: t6.run(T6_ROUNDS, DEVICE))
    if t6_launches is None:
        fail("25", "T6's path did not run on its kernel alone")
        return None
    # the tool's ones are a fixed point of a: hold cond-true at the tool's length on the random b as well
    t_full = time.perf_counter()
    full = repro.cond_chain(flags[1], a, b_rand, T6_ROUNDS)
    full_same = same(full, repro.cond_chain_plain(flags[1], a, b_rand, T6_ROUNDS))
    full_moved = not same(full, b_rand)
    print(f"[25] T6 cond true on the random b, {T6_ROUNDS} rounds: bit-identical to the plain version {full_same}, "
          f"differs from b {full_moved} ({time.perf_counter() - t_full:.1f} s)", flush=True)
    if not (full_same and full_moved):
        fail("25", f"T6 cond true at {T6_ROUNDS} rounds on a random b disagrees with its plain version, or left b "
                   f"as it was (max |a-b| {err(full, b_rand):.3g})")
        return None
    t6_ms = {k: min(v) for k, v in t6_res["ms"].items()}
    half = cuda_time_ms(lambda: repro.cond_chain(flags[1], a, b_rand, T6_ROUNDS // 2), 3)
    ratio = t6_ms["true"] / half
    print(f"[25] T6 {T6_ROUNDS} rounds: ctrl {t6_ms['ctrl']:.3f} ms, true {t6_ms['true']:.3f} ms, false "
          f"{t6_ms['false']:.4f} ms; half the rounds {half:.3f} ms (ratio {ratio:.2f}) | card {card}", flush=True)
    if not (t6_ms["true"] > 10 * t6_ms["false"] and 0.8 <= t6_ms["ctrl"] / t6_ms["true"] <= 1.25
            and 1.6 <= ratio <= 2.4):
        fail("25", "T6's times do not show control ~ true >> false, or do not follow the rounds")
        return None
    steps = T6_ROUNDS * repro.INNER
    torch.backends.cuda.matmul.allow_tf32 = False
    t6_lib_ms = timing.ms_per_launch(lambda: torch.matmul(a, b_rand), 50, dev) * steps
    t6_flops = 2 * t6.N ** 3 * steps
    t6_bound = t6_flops / PEAK_F32_FLOPS * 1e3
    print(f"[25] T6 bound {t6_bound:.3f} ms ({t6_flops:.4g} flops at 67 TFLOP/s; {2 * t6_bound:.3f} ms at the 33.5 "
          f"Tops/s of unfused code); library torch.matmul a step x {steps} steps {t6_lib_ms:.3f} ms; plain "
          f"{t6_plain_ms:.3f} ms at 1 round (kernel {t6_small_ms:.4f} ms there) | card {card}", flush=True)
    t6_split = repro.cond_chain_split(flags[1], a, b_rand, T6_SPLIT_ROUNDS)
    per_step = sum(t6_split[k] for k in ("products", "barrier", "rest"))
    print(f"[25] T6's step split (counting build, cond true on the random b, {T6_SPLIT_ROUNDS} rounds), clock "
          f"cycles a step and thread: products {t6_split['products']:.1f} "
          f"({t6_split['products'] / per_step:.1%}), write and barrier wait {t6_split['barrier']:.1f} "
          f"({t6_split['barrier'] / per_step:.1%}), rest {t6_split['rest']:.1f} "
          f"({t6_split['rest'] / per_step:.1%}); a step of the timed chain {t6_ms['true'] / steps * 1e6:.1f} ns "
          f"| card {card}", flush=True)

    # ---- 26. T7, the staged relayout: every stage at every G against the plain version; then the tool at every G
    x7, w7 = t7.make_inputs(DEVICE)
    t7_err = 0.0
    for g in REPRO_GROUPS:
        for stage in repro.STAGES:
            k, p = repro.reshape_stage(x7, w7, stage, g), repro.reshape_stage_plain(x7, w7, stage, g)
            t7_err = max(t7_err, err(k, p))
            if not same(k, p):
                fail("26", f"T7 stage {stage} at G={g} disagrees with its plain version")
                return None
        print(f"[26] T7 G={g}: stages 1-5 bit-identical to the plain version", flush=True)
    # stage 5 on w with +-0, +-inf, NaN and a bf16 overflow, x with a NaN and negative entries
    for case, (xs, ws) in t7.special_inputs(DEVICE).items():
        for g in REPRO_GROUPS:
            k, p = repro.reshape_stage(xs, ws, 5, g), repro.reshape_stage_plain(xs, ws, 5, g)
            t7_err = max(t7_err, err(k, p))
            if not same(k, p):
                fail("26", f"T7 stage 5 at G={g} disagrees with its plain version on the {case} inputs")
                return None
        print(f"[26] T7 stage 5, {case} inputs, G = 1, 2, 4, 8: bit-identical to the plain version "
              f"({int(torch.isnan(p).sum())} NaN lanes)", flush=True)
    t7_plain_ms = cuda_time_ms(lambda: repro.reshape_stage_plain(x7, w7, 5, 4), 3)
    t7_res, t7_launches = drive("26", "reshape_stage", lambda: {g: t7.run(g, DEVICE) for g in REPRO_GROUPS},
                                  len(REPRO_GROUPS) * len(repro.STAGES))
    if t7_launches is None or not all(r["ok"] for res in t7_res.values() for r in res.values()):
        fail("26", "T7's path did not run on its kernel alone, or a stage disagreed")
        return None
    # stage 5's least work: x, all of w (a non-finite entry anywhere in a row makes that row's answer NaN for
    # every other column, so every entry can change the output) and the output; the columns the pops reach,
    # each converted to bf16 and reduced to its minimum over the rows, and acc + contrib * row for each lane a
    # trip.  The launch floor beside it: stage 1's time, a launch that copies x
    n7, words, t7_cols = x7.numel(), repro.STAGE45_WORDS, set()
    for _ in range(repro.TRIPS):
        if words:
            t7_cols.add((words & -words).bit_length() - 1)
            words &= words - 1
    t7_bytes = (2 * n7 + repro.LANE * repro.LANE) * 4
    t7_ops = 2 * repro.TRIPS * n7 + len(t7_cols) * (2 * repro.LANE - 1)
    t7_bound = max(t7_bytes / PEAK_BYTES, t7_ops / PEAK_F32_FLOPS) * 1e3

    # ---- 27. T8, the grouped rows: every G against the plain version; then the tool at every G
    x8 = t8.make_input(DEVICE)
    for g in REPRO_GROUPS:
        if not same(repro.group_rows(x8, g), repro.group_rows_plain(x8, g)):
            fail("27", f"T8 at G={g} disagrees with its plain version")
            return None
    print("[27] T8 G=1, 2, 4, 8: bit-identical to the plain version", flush=True)
    t8_plain_ms = cuda_time_ms(lambda: repro.group_rows_plain(x8, 4), 3)
    t8_res, t8_launches = drive("27", "group_rows", lambda: {g: t8.run(g, DEVICE) for g in REPRO_GROUPS},
                                  len(REPRO_GROUPS))
    if t8_launches is None or not all(r["bit_equal"] for r in t8_res.values()):
        fail("27", "T8's path did not run on its kernel alone, or disagreed")
        return None
    t8_bound = 2 * x8.numel() * 4 / PEAK_BYTES * 1e3
    print(f"[26-27] T7 stage 5 at G=4 {t7_res[4][5]['ms']:.4f} ms (bound {t7_bound:.6f} ms, plain {t7_plain_ms:.3f} "
          f"ms); T8 at G=4 {t8_res[4]['ms']:.4f} ms (bound {t8_bound:.6f} ms, plain {t8_plain_ms:.3f} ms) | card "
          f"{card}", flush=True)
    # T8 against its launch floor: T7's stage 1 (a launch that copies x) at the same G in the same run
    t8_floor = {g: t7_res[g][1]["ms"] for g in REPRO_GROUPS}
    print("[27] T8 against the launch floor (T7 stage 1 at the same G, this run): " + "; ".join(
        f"G={g} T8 {t8_res[g]['ms'] * 1e3:.2f} µs, floor {t8_floor[g] * 1e3:.2f} µs, floor/T8 "
        f"{t8_floor[g] / t8_res[g]['ms']:.0%}" for g in REPRO_GROUPS) + f" | card {card}", flush=True)
    print(f"[24-27] the repros in {time.perf_counter() - t_repro:.1f} s | card {card}", flush=True)

    return [{
        "name": "window_slice",
        "route": "cuda",
        "source": REPRO_SOURCE,
        "replaces": "tools/repro/window_slice_probe.py:75",
        "launches": t5_launches,
        "launches_are": "launches of pt_window_slice by the T5 tool (window_slice_probe.run): 2 layouts, a check, "
                        "a warm-up and 20 timed launches each",
        "max_abs_err": t5_err,
        "max_abs_err_over": "layouts A and B on the tool's pages and on two page sets whose window starts at 128 "
                            "and at the clamp P - W = 256; bit for bit, and equal to the numpy gather; on the "
                            "special values bit for bit where a number and NaN where NaN (not in max_abs_err)",
        "ms": t5_res["A"]["ms"],
        "plain_ms": t5_plain_ms,
        "bound_ms": t5_bound,
        "bound_by": "bytes",
        "bound_bytes": t5_bytes,
        "bound_bytes_are": "the window bf16[R, W] (a non-finite entry anywhere in a row changes that row's "
                           "output), the pages, the f32 output",
        "library_ms": None,
        "shape": f"layout A, table bf16[{t5.R},{t5.P}], {t5.LANE} lanes, window {repro.WINDOW}",
        "ms_by_layout": {k: round(v["ms"], 6) for k, v in t5_res.items()},
        "split": t5_split,
    }, {
        "name": "cond_chain",
        "route": "cuda",
        "source": REPRO_SOURCE,
        "replaces": "tools/repro/mosaic_cond_skip.py:81",
        "launches": t6_launches,
        "launches_are": "launches of pt_cond_chain by the T6 tool (mosaic_cond_skip.run): 2 warm-ups and 4 "
                        "interleaved rounds of ctrl, true, false",
        "max_abs_err": 0.0,
        "max_abs_err_over": f"cond true, cond false and control at {T6_CHECK_ROUNDS} rounds on the ones and on a "
                            f"random b, and cond true at {T6_ROUNDS} rounds on the random b, bit for bit",
        "ms": t6_ms["true"],
        "plain_ms": t6_plain_ms,
        "bound_ms": t6_bound,
        "bound_by": "operations",
        "bound_unfused_ms": 2 * t6_bound,
        "library_ms": t6_lib_ms,
        "library_call": f"torch.matmul(a, c) (TF32 off), one a step, timed over 50 calls, times {steps} steps",
        "shape": f"cond true, f32[{t6.N},{t6.N}], {T6_ROUNDS} rounds of {repro.INNER} products",
        "plain_shape": f"cond true, 1 round of {repro.INNER} products",
        "kernel_ms_at_plain_shape": t6_small_ms,
        "ctrl_ms": t6_ms["ctrl"],
        "false_ms": t6_ms["false"],
        "half_rounds_ms": half,
        "step_ns": t6_ms["true"] / steps * 1e6,
        "step_split_cycles": t6_split,
        "ptxas": ptxas_of(cuda_trace, "repro", "chain_kernel"),
    }, {
        "name": "reshape_stage",
        "route": "cuda",
        "source": REPRO_SOURCE,
        "replaces": "tools/repro/mosaic_reshape_repro.py:129",
        "kernels": ["reshape_stage_kernel<1..4> (stages 1-4)",
                    "reshape_stage5_kernel (stage 5: each block's table of the contraction's 129 answers)"],
        "launches": t7_launches,
        "launches_are": "launches of pt_reshape_stage by the T7 tool (mosaic_reshape_repro.run) at G = 1, 2, 4, "
                        "8: 5 stages, a check against the plain version, a warm-up and 20 timed launches each",
        "max_abs_err": t7_err,
        "max_abs_err_over": "stages 1-5 at G = 1, 2, 4, 8 on the tool's x and w, and stage 5 at each G on "
                            "w with +-0, +-inf, NaN and a bf16 overflow and x with a NaN and negative entries; "
                            "bit for bit",
        "ms": t7_res[4][5]["ms"],
        "plain_ms": t7_plain_ms,
        "bound_ms": t7_bound,
        "bound_by": "operations" if t7_ops / PEAK_F32_FLOPS >= t7_bytes / PEAK_BYTES else "bytes",
        "bound_bytes": t7_bytes,
        "bound_ops": t7_ops,
        "bound_are": f"x, all of w and the output (a non-finite entry anywhere in a row changes that row's answer); "
                     f"acc + contrib * row a lane a trip and the {len(t7_cols)} columns' conversions and minima",
        "launch_floor_ms": t7_res[4][1]["ms"],
        "launch_floor_is": "stage 1 at G=4 (a launch that copies x)",
        "library_ms": None,
        "shape": "stage 5 at G=4, x f32[8,128], w f32[128,128]",
        "ms_by_g_and_stage": {f"{g}:{s}": round(r["ms"], 6) for g, res in t7_res.items() for s, r in res.items()},
    }, {
        "name": "group_rows",
        "route": "cuda",
        "source": REPRO_SOURCE,
        "replaces": "tools/repro/group_rows_relayout.py:94",
        "launches": t8_launches,
        "launches_are": "launches of pt_group_rows by the T8 tool (group_rows_relayout.run) at G = 1, 2, 4, 8: a "
                        "check against the plain version, a warm-up and 20 timed launches each",
        "max_abs_err": 0.0,
        "max_abs_err_over": "G = 1, 2, 4, 8, bit for bit",
        "ms": t8_res[4]["ms"],
        "plain_ms": t8_plain_ms,
        "bound_ms": t8_bound,
        "bound_by": "bytes",
        "library_ms": None,
        "shape": "G=4, x f32[32,128]",
        "ms_by_g": {g: round(r["ms"], 6) for g, r in t8_res.items()},
        "launch_floor_ms_by_g": {g: round(v, 6) for g, v in t8_floor.items()},
        "launch_floor_is": "T7 stage 1 at the same G in the same run: one launch that copies x",
    }]


FRONT_END_DIR = os.path.join(HERE, "build", "chip_smoke")  # phases 30-32's files (build/ is not committed)
FINAL = (1920, 1080, 1000, 80)  # the reference's headless final preset (util.go:25-42)
PREVIEW = (400, 225, 20, 20)  # its preview preset


def png_size(data: bytes):
    """(width, height) of a PNG from its IHDR, or None if it is not a PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        return None
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def front_end_phases(pt, cuda_trace, card):
    """Phases 30-32: the user's entry points on the card (the CLI at the final
    preset with its metrics stream, checkpoint resume, the interactive
    session under the viewer).  Returns the walls they printed, or None on
    a failure (printed)."""
    import contextlib
    import io
    import shutil
    import threading
    import urllib.request

    import numpy as np
    from path_trace_golang_tpu_torch import cli
    from path_trace_golang_tpu_torch.interactive import InteractiveSession
    from path_trace_golang_tpu_torch.io_png import encode_png
    from path_trace_golang_tpu_torch.scene import builtin
    from path_trace_golang_tpu_torch.utils import checkpoint as ck
    from path_trace_golang_tpu_torch.utils import native
    from path_trace_golang_tpu_torch.viewer import ViewerServer

    def fail(tag, what):
        print(f"[{tag}] FAIL: {what}", file=sys.stderr)

    def zero():
        for c in COUNTERS:
            setattr(cuda_trace, c, 0)

    def counts():
        out = {c: getattr(cuda_trace, c) for c in COUNTERS}
        out["plain"] = sum(out[c] for c in PLAIN_COUNTERS)
        return out

    shutil.rmtree(FRONT_END_DIR, ignore_errors=True)
    os.makedirs(FRONT_END_DIR)
    walls = {}
    print(f"[30] PNG encoder: {'the native tier (csrc/libpt_native.so)' if native.available() else 'zlib writer'}",
          flush=True)

    # ---- 30. the CLI in process at the final preset, cpu contract (the default backend), with the metrics
    # stream and --json-stats; then its metrics through tools/metrics_report.py; then one subprocess of the
    # module's entry point at the preview preset
    png, jsonl = os.path.join(FRONT_END_DIR, "final.png"), os.path.join(FRONT_END_DIR, "final.jsonl")
    zero()
    os.environ["PATHTRACER_METRICS"] = jsonl
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-scene", "demo_showcase", "-mode", "final", "-headless", "-out", png, "--json-stats"])
    finally:
        del os.environ["PATHTRACER_METRICS"]
    walls["cli_final_s"] = time.perf_counter() - t0
    got = counts()
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    w, h, passes, depth = FINAL
    window = max(1, int(os.environ.get("PATHTRACER_PASS_WINDOW", "8")))
    every = passes // 20
    want_launches = (passes // every) * -(-every // window)  # windows end at every interval pass
    print(f"[30] cli.main -scene demo_showcase -mode final -headless --json-stats (cpu contract, {w}x{h}, {passes} "
          f"passes, depth {depth}): rc {rc}, {walls['cli_final_s']:.3f} s; stats {json.dumps(stats)}; "
          f"classic_window_kernel launches {got['CLASSIC_LAUNCHES']} (want {want_launches}), all launches "
          f"{got['LAUNCHES']}, plain calls {got['plain']} | card {card}", flush=True)
    with open(png, "rb") as f:
        cli_png = f.read()
    if rc != 0 or png_size(cli_png) != (w, h) or (stats["width"], stats["height"], stats["passes"]) != (w, h, passes):
        fail("30", "the CLI did not write the final preset's PNG or stats")
        return None
    if got["CLASSIC_LAUNCHES"] != want_launches or got["LAUNCHES"] != want_launches or got["plain"] != 0:
        fail("30", "the CLI's render did not run on classic_window_kernel alone, one launch a window")
        return None
    with open(jsonl) as f:
        records = [json.loads(line) for line in f if line.strip()]
    report = subprocess.run([sys.executable, os.path.join(HERE, "tools", "metrics_report.py"), jsonl],
                            capture_output=True, text=True, timeout=120)
    print(f"[30] tools/metrics_report.py {os.path.relpath(jsonl, HERE)}: rc {report.returncode}\n"
          + "\n".join(f"    {line}" for line in report.stdout.splitlines()), flush=True)
    if (report.returncode != 0 or f"{len(records)} intervals, last pass {passes}" not in report.stdout
            or "accumulator finite in every interval" not in report.stdout or len(records) != 20
            or [r["pass"] for r in records] != list(range(every, passes + 1, every))
            or sum(r["segments"] for r in records) != stats["ray_segments"]):
        fail("30", "the metrics stream is not 20 finite intervals that tools/metrics_report.py reads")
        return None
    preview_png = os.path.join(FRONT_END_DIR, "preview.png")
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "path_trace_golang_tpu_torch", "-scene", "demo_showcase", "-headless",
                          "-out", preview_png], cwd=HERE, capture_output=True, text=True, timeout=600)
    walls["module_preview_s"] = time.perf_counter() - t0
    size = None
    if os.path.exists(preview_png):
        with open(preview_png, "rb") as f:
            size = png_size(f.read())
    print(f"[30] python -m path_trace_golang_tpu_torch -scene demo_showcase -headless (the preview preset, a process "
          f"of its own): rc {sub.returncode}, PNG {size}, {walls['module_preview_s']:.3f} s of process | card {card}",
          flush=True)
    if sub.returncode != 0 or size != PREVIEW[:2]:
        print(sub.stderr[-4000:], file=sys.stderr)
        fail("30", "the module's entry point did not write the preview PNG")
        return None

    # ---- 31. checkpoint resume: a render interrupted through cancel about halfway (just after the save at
    # the interval past half), then resumed, against the uninterrupted render with the same checkpoint
    # settings, bit for bit (image and final accumulator); the cpu contract and faithful fog also against the
    # render without checkpointing (their windows add pass by pass); walls with and without checkpointing
    sc = builtin.demo_showcase()
    cases = (("cpu contract, final preset", dict(contract="cpu"), FINAL, True),
             ("gpu contract, preview preset", dict(contract="gpu"), PREVIEW, False),
             ("faithful fog, preview preset", dict(contract="gpu", faithful_fog=True), PREVIEW, True))
    for label, opts, (w, h, passes, depth), same_windows in cases:
        cfg = pt.RenderConfig(w, h, passes, depth)
        tag = label.split(",")[0].replace(" ", "_")
        zero()
        r0 = pt.Renderer(seed=1, **opts)
        img0 = r0.render(sc, cfg)
        pa, pb = (os.path.join(FRONT_END_DIR, f"{tag}_{k}.ckpt") for k in ("a", "b"))
        ra = pt.Renderer(seed=1, checkpoint_path=pa, **opts)
        img_a = ra.render(sc, cfg)
        done = {"p": 0}
        rb = pt.Renderer(seed=1, checkpoint_path=pb, **opts)
        rb.render(sc, cfg, progress=lambda p, _im: done.update(p=p), cancel=lambda: done["p"] >= passes // 2)
        saved = ck.load_checkpoint(pb)
        rc_ = pt.Renderer(seed=1, checkpoint_path=pb, **opts)
        img_c = rc_.render(sc, cfg)
        got = counts()
        ck_a, ck_c = ck.load_checkpoint(pa), ck.load_checkpoint(pb)
        same_img = np.array_equal(img_c, img_a)
        same_acc = ck_a.passes == ck_c.passes == passes and np.array_equal(ck_a.accum.view(np.int32),
                                                                         ck_c.accum.view(np.int32))
        plain_same = np.array_equal(img0, img_a) if same_windows else None
        walls[f"{tag}_without_checkpoint_s"] = r0.stats.wall_seconds
        walls[f"{tag}_with_checkpoint_s"] = ra.stats.wall_seconds
        print(f"[31] {label} ({w}x{h}, {passes} passes, depth {depth}): interrupted at pass {rb.stats.passes}, "
              f"saved {saved.passes if saved else None}, resumed_from {rc_.stats.resumed_from}; resumed image "
              f"bit-identical {same_img}, final accumulator bit-identical {same_acc}, the render without "
              f"checkpointing {'bit-identical ' + str(plain_same) if same_windows else 'not compared (other windows)'}"
              f"; wall without checkpointing {r0.stats.wall_seconds:.3f} s, with {ra.stats.wall_seconds:.3f} s "
              f"({(passes // (20 if opts['contract'] == 'cpu' else 10))} passes a save), interrupted "
              f"{rb.stats.wall_seconds:.3f} s + resumed {rc_.stats.wall_seconds:.3f} s; launches {got['LAUNCHES']} "
              f"(fog kernel {got['FOG_LAUNCHES']}, classic {got['CLASSIC_LAUNCHES']}, march {got['MARCH_LAUNCHES']}), "
              f"plain calls {got['plain']}, nonfinite {rc_.stats.nonfinite} | card {card}", flush=True)
        if saved is None or not 0 < saved.passes < passes or rc_.stats.resumed_from != saved.passes:
            fail("31", f"{label}: the render was not interrupted and resumed from its checkpoint")
            return None
        if not (same_img and same_acc and plain_same is not False) or rc_.stats.nonfinite != 0:
            fail("31", f"{label}: the resumed render is not bit for bit the uninterrupted one")
            return None
        want = ("CLASSIC_LAUNCHES",) if opts["contract"] == "cpu" else (
            ("MARCH_LAUNCHES", "CLASSIC_LAUNCHES") if opts.get("faithful_fog") else ("FOG_LAUNCHES",))
        if got["plain"] != 0 or got["LAUNCHES"] <= 0 or any(got[k] <= 0 for k in want):
            fail("31", f"{label}: the renders did not run on the card's kernels alone")
            return None
        if opts["contract"] == "cpu" and encode_png(img0) != cli_png:
            fail("31", "the final preset's image differs from phase 30's CLI image")
            return None
    print(f"[31] the cost of the saves at the final preset (cpu contract, 20 saves of a f32[{FINAL[0] * FINAL[1]}, 3] "
          f"accumulator): {walls['cpu_contract_with_checkpoint_s'] - walls['cpu_contract_without_checkpoint_s']:.3f} "
          f"s a render | card {card}", flush=True)

    # ---- 32. the interactive session on the card under the viewer (127.0.0.1, an ephemeral port)
    zero()
    session = InteractiveSession(builtin.demo_showcase(), mode="preview", renderer=pt.Renderer(contract="gpu", seed=1))
    session.settings = pt.render_settings_for_mode("preview")
    srv = ViewerServer(session, host="127.0.0.1", port=0, save_dir=FRONT_END_DIR)
    srv.start_background()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=120) as r:
            return r.status, r.read()

    try:
        t0 = time.perf_counter()
        session.render_now(False)
        walls["session_render_s"] = time.perf_counter() - t0
        code, frame0 = get("/frame.png")
        gen0 = json.loads(get("/status")[1])["gen"]
        z0 = session.scene.camera.position.z
        code_k, key = get("/key?k=w")
        moved = session.scene.camera.position.z == z0 - 0.5 and json.loads(key)["ok"]
        arrived = srv.wait_for_frame(gen0, timeout=120)
        time.sleep(0.5)  # the debounce has started the render thread by now
        th = session._render_thread
        if th is not None:
            th.join(timeout=300)
        _c, frame1 = get("/frame.png")
        code_s, saved = get("/save?path=viewer_final.png")
        saved_path = json.loads(saved).get("saved", "")
        with open(os.path.join(FRONT_END_DIR, "viewer_final.png"), "rb") as f:
            saved_size = png_size(f.read())
        direct = pt.Renderer(contract="gpu", seed=1).render(session.scene.copy(), pt.RenderConfig(*PREVIEW),
                                                             cancel=lambda: False)
        same_direct = session.last_preview is not None and np.array_equal(session.last_preview, direct)
    finally:
        srv.shutdown()
        srv.httpd.server_close()
    got = counts()
    print(f"[32] InteractiveSession (gpu contract, {PREVIEW[0]}x{PREVIEW[1]}, {PREVIEW[2]} passes, depth {PREVIEW[3]}) "
          f"under ViewerServer on 127.0.0.1:{srv.port}: first frame {session.error or 'rendered'} in "
          f"{walls['session_render_s']:.3f} s, /frame.png {code} {png_size(frame0)}; /key?k=w {code_k} moved "
          f"{moved}, a new frame {arrived} and it differs {frame1 != frame0}; /save {code_s} -> "
          f"{os.path.relpath(saved_path, HERE) if saved_path else None} {saved_size}; the session's last image "
          f"bit-identical to a direct Renderer.render with the same windows {same_direct}; launches {got['LAUNCHES']} "
          f"(fog kernel {got['FOG_LAUNCHES']}), plain calls {got['plain']}, threads {threading.active_count()} | card "
          f"{card}", flush=True)
    if session.error is not None or code != 200 or png_size(frame0) != PREVIEW[:2] or not (moved and arrived):
        fail("32", "the session's frame or its camera key did not come through the viewer")
        return None
    if frame1 == frame0 or code_s != 200 or saved_size != PREVIEW[:2] \
            or os.path.dirname(saved_path) != os.path.realpath(FRONT_END_DIR) or not same_direct:
        fail("32", "no new frame after the key, /save did not write inside save_dir, or the session's image differs "
                   "from the Renderer's")
        return None
    if got["LAUNCHES"] <= 0 or got["FOG_LAUNCHES"] <= 0 or got["plain"] != 0:
        fail("32", "the session's frames did not come from the card's kernels alone")
        return None
    return walls


MESH_CASES = (
    # (label, scene, width, height, passes, depth, contract, faithful fog): phase 33b's renders
    ("showcase", "demo_showcase", 1920, 1080, 8, 12, "gpu", False),
    ("cpu", "demo_showcase", 1920, 1080, 16, 80, "cpu", False),
    ("faithful_fog", "demo_showcase", 1920, 1080, 2, 12, "gpu", True),
    ("bench_mesh", "bench_mesh", 512, 512, 8, 8, "gpu", False),
)
MESH_SHAPES = ((4, 1), (2, 2))  # phase 33b's meshes: a world of 4 ranks sharing the card over gloo
MESH_RTOL = 1e-5  # an spp mesh's accumulator against the single Renderer's, a entry: |a - b| <= MESH_RTOL |b|


def final_accum(module, box):
    """Wrap ``module.accum_image`` (the post chain that the Renderer and the
    mesh renderer finish their images with) so that the accumulator of the
    final image lands in ``box["accum"]`` (f32[n_pad, 3] on the host).
    Returns the function that restores it."""
    orig = module.accum_image

    def spy(accum, w, h, count, gpu, denoise):
        if denoise:
            box["accum"] = accum.cpu().numpy()
        return orig(accum, w, h, count, gpu, denoise)

    module.accum_image = spy
    return lambda: setattr(module, "accum_image", orig)


def mesh_rank(cases, shapes, device):
    """What every rank of phase 33 runs (a spawned process: it imports this
    file, which imports no JAX).  For each mesh shape, a mesh made by the
    whole world; for each case, one warm-up render, then every count set to
    0, the timed render, the counts read.  Returns a record a render: the
    stats, the counts and the image's digest, and on rank (0, 0) the image
    and the final accumulator."""
    import hashlib

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.parallel import MeshRenderer, make_mesh
    from path_trace_golang_tpu_torch.parallel import mesh as mesh_mod
    from path_trace_golang_tpu_torch.scene import builtin

    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    out = []
    for shape in shapes:
        mesh = make_mesh(*shape, device=device)
        if mesh.get_coordinate() is None:  # a rank beyond the mesh
            continue
        lead = mesh.get_coordinate() == (0, 0)
        for label, name, w, h, passes, depth, contract, faithful in cases:
            sc, cfg = getattr(builtin, name)(), pt.RenderConfig(w, h, passes, depth)
            r = MeshRenderer(mesh, contract=contract, seed=1, faithful_fog=faithful, device=device)
            r.render(sc, cfg)  # warm-up
            box = {}
            restore = final_accum(mesh_mod, box)
            for c in COUNTERS:
                setattr(cuda_trace, c, 0)
            try:
                img = r.render(sc, cfg)
            finally:
                restore()
            out.append({"shape": tuple(shape), "label": label, "stats": dict(vars(r.stats)),
                        "counts": {c: getattr(cuda_trace, c) for c in COUNTERS},
                        "img_sha": hashlib.sha256(img.tobytes()).hexdigest(),
                        "img": img if lead else None, "accum": box["accum"] if lead else None})
    return out


def mesh_phase(pt, cuda_trace, card, shapes, across_cards=False):
    """Phase 33: the mesh renderer (parallel/mesh.py) on the card, its ranks
    spawned by parallel/launch.run_world.  33a: a world of 1 over NCCL, a
    1x1 mesh, the showcase case; 33b: a world of max(n_px * n_spp) ranks on
    this card over gloo, every case of MESH_CASES on every shape.  With
    ``across_cards`` (``--mesh --across-cards``, a machine with a card a
    rank) 33c alone instead: that world over NCCL, one card a rank.  Each
    render is held against the single Renderer's in this process, whose
    chunk is the mesh's px block (so that the classic loop cuts the same
    chunks; the regeneration loop's lanes do not depend on it): a px-only
    mesh bit for bit, an spp mesh within MESH_RTOL a entry; segments
    equal, no plain call and no other kernel than the path's in any rank,
    every rank the same image.  Returns the walls, or None on a failure
    (printed)."""
    import numpy as np
    import torch
    from path_trace_golang_tpu_torch import render as render_mod
    from path_trace_golang_tpu_torch.parallel.launch import run_world
    from path_trace_golang_tpu_torch.scene import builtin

    t0 = time.perf_counter()
    refs = {}

    def reference(case, n_px):
        """The single Renderer on a case, with the mesh's block as its chunk:
        a warm-up, then the timed render (image, final accumulator, stats,
        the kernels it launched)."""
        label, name, w, h, passes, depth, contract, faithful = case
        chunk = -(-w * h // n_px)
        if (label, chunk) not in refs:
            sc, cfg = getattr(builtin, name)(), pt.RenderConfig(w, h, passes, depth)
            r = pt.Renderer(contract=contract, seed=1, faithful_fog=faithful, chunk=chunk, device=DEVICE)
            r.render(sc, cfg)
            box = {}
            restore = final_accum(render_mod, box)
            for c in COUNTERS:
                setattr(cuda_trace, c, 0)
            try:
                img = r.render(sc, cfg)
            finally:
                restore()
            launched = {c for c in COUNTERS if getattr(cuda_trace, c)}
            if launched & set(PLAIN_COUNTERS) or not launched:
                raise RuntimeError(f"[33] the single Renderer on {label} did not run on the kernels alone")
            refs[(label, chunk)] = (img, box["accum"], r.stats, launched)
        return refs[(label, chunk)]

    walls = {}

    def hold(tag, world_backend, recs, shape, case):
        label, name, w, h, passes, depth, contract, faithful = case
        mine = [r for r in recs if r["label"] == label and r["shape"] == tuple(shape)]
        img, accum, stats, want = reference(case, shape[0])
        lead = next(r for r in mine if r["img"] is not None)
        launched = {c for c in COUNTERS if mine[0]["counts"][c]}
        plain = sum(r["counts"][c] for r in mine for c in PLAIN_COUNTERS)
        same_counts = all(r["counts"] == mine[0]["counts"] for r in mine)
        same_ranks = all(r["img_sha"] == lead["img_sha"] for r in mine) and all(
            {k: v for k, v in r["stats"].items() if k != "wall_seconds"}
            == {k: v for k, v in lead["stats"].items() if k != "wall_seconds"} for r in mine)
        a, b = lead["accum"], accum
        bits = a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))
        rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float32).tiny))) if a.shape == b.shape \
            else float("inf")
        px_only = shape[1] == 1
        u8_share = float((lead["img"] == img).all(axis=-1).mean())
        segs_equal = lead["stats"]["ray_segments"] == stats.ray_segments
        wall = max(r["stats"]["wall_seconds"] for r in mine)
        walls[f"{tag} {shape[0]}x{shape[1]} {label}"] = {"mesh_s": wall, "single_s": stats.wall_seconds}
        rank_walls = ", ".join(f"{r['stats']['wall_seconds']:.4f}" for r in mine)
        print(
            f"[{tag}] {shape[0]}x{shape[1]} mesh over {world_backend}, {name} {w}x{h} d{depth} x{passes}, "
            f"{contract} contract{', faithful fog' if faithful else ''}: wall {wall:.4f} s (the ranks' "
            f"{rank_walls}) against the single Renderer's "
            f"{stats.wall_seconds:.4f} s (chunk {-(-w * h // shape[0])}); accumulator bit-identical {bits}, max "
            f"rel {rel:.3g}; u8 pixels equal {u8_share:.6f}; segments {lead['stats']['ray_segments']} / "
            f"{stats.ray_segments}; passes {lead['stats']['passes']}; nonfinite {lead['stats']['nonfinite']}; a "
            f"rank's launches { {c: v for c, v in mine[0]['counts'].items() if v} }; plain calls {plain}; every "
            f"rank the same image {same_ranks} | card {card}",
            flush=True,
        )
        good = (segs_equal and same_ranks and same_counts and plain == 0 and launched == want
                and lead["stats"]["nonfinite"] == 0 and lead["stats"]["passes"] == stats.passes
                and lead["img"].shape == (h, w, 3) and (bits and np.array_equal(lead["img"], img) if px_only
                                                        else rel <= MESH_RTOL))
        if not good:
            print(f"[{tag}] FAIL: the {shape[0]}x{shape[1]} mesh on {label} differs from the single Renderer, or "
                  f"its ranks disagree, or it launched {sorted(launched)} where the single Renderer launched "
                  f"{sorted(want)}, or called a plain version", file=sys.stderr)
        return good

    world = max(p * s for p, s in shapes)
    worlds = [("33c", world, "nccl", shapes, MESH_CASES)] if across_cards else [
        ("33a", 1, "nccl", [(1, 1)], MESH_CASES[:1]),  # 33a: a world of 1 over NCCL, a 1x1 mesh
        ("33b", world, "gloo", shapes, MESH_CASES)]  # 33b: ranks sharing this card (NCCL refuses two on one card)
    for tag, n, backend, tag_shapes, cases in worlds:
        if backend == "nccl" and n > torch.cuda.device_count():
            print(f"[{tag}] FAIL: a world of {n} over NCCL needs {n} cards, the machine has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return None
        tw = time.perf_counter()
        per_rank = run_world(mesh_rank, n, (cases, [tuple(x) for x in tag_shapes], DEVICE), backend=backend,
                             timeout=600)
        print(f"[{tag}] a world of {n} over {backend}"
              f"{', one card a rank' if backend == 'nccl' else ' on one card'} in {time.perf_counter() - tw:.1f} s "
              f"(spawn and CUDA start-up included)", flush=True)
        recs = [rec for rank in per_rank for rec in rank]
        for shape in tag_shapes:
            for case in cases:
                if not hold(tag, backend, recs, shape, case):
                    return None
    walls["phase_s"] = time.perf_counter() - t0
    return walls


DROPS = ("closest", "shadow", "spec", "closest,shadow,spec")
# phase 34's paths: (label, scene, width, height, depth, faithful fog, environment)
DROP_PATHS = (
    ("B1 paged instance", "bench_mesh", 64, 64, 4, False, {}),
    ("classic instance, faithful fog", "demo_showcase", 96, 48, 3, True, {"PATHTRACER_BVH_DYNAMIC": "1"}),
)


def drop_phase(pt, cuda_trace, card):
    """Phase 34: PATHTRACER_BVH_DROP on the card.  For each drop and path, the
    kernel against its plain version bit for bit with segments equal, and
    the dropped image against the undropped kernel's, which must differ.
    Returns {path: {drop: bits equal and differs}} and whether all held."""
    import numpy as np
    import torch

    held, good = {}, True
    saved = {k: os.environ.get(k) for k in ("PATHTRACER_BVH_DROP", "PATHTRACER_BVH_DYNAMIC")}
    try:
        for label, name, w, h, depth, faithful, env in DROP_PATHS:
            os.environ.update(env)
            os.environ.pop("PATHTRACER_BVH_DROP", None)
            _sc, pack, kw = scene_setup(pt, name, w, h, depth, "gpu", faithful)
            if pack.paged is None:
                print(f"[34] FAIL: {name} carries no pages, so no walk can be dropped", file=sys.stderr)
                return held, False
            px, py = lanes(w, h)
            base = cuda_trace.render_pass_cuda(pack, 7, px, py, n_passes=1, **kw)[0].to_rows()
            for drop in DROPS:
                os.environ["PATHTRACER_BVH_DROP"] = drop
                _sc, pack, kw = scene_setup(pt, name, w, h, depth, "gpu", faithful)
                col_k, segs_k = cuda_trace.render_pass_cuda(pack, 7, px, py, n_passes=1, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                col_p, segs_p = cuda_trace.render_pass_plain(pack, 7, px, py, n_passes=1, **kw)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
                a, b = col_k.to_rows(), col_p.to_rows()
                bits = torch.equal(a.view(torch.int32), b.view(torch.int32)) and int(segs_k) == int(segs_p)
                moved = int((a != base).any(dim=1).sum())
                ok = bits and moved > 0 and kw["tcfg"].debug_drop == tuple(sorted(drop.split(",")))
                held.setdefault(label, {})[drop] = ok
                good = good and ok
                print(f"[34] {label}, {name} {w}x{h} d{depth}, drop {drop}: kernel against plain bit-identical "
                      f"{bits} (segments {int(segs_k)} vs {int(segs_p)}), lanes that differ from the undropped "
                      f"image {moved} of {w * h}; plain version {plain_s:.1f} s", flush=True)
            for k in env:
                os.environ.pop(k, None)
        # B3 through trace(), gpu contract, on bench_mesh's pages
        os.environ.pop("PATHTRACER_BVH_DROP", None)
        _sc, pack, kw = scene_setup(pt, "bench_mesh", 512, 512, 8)
        o, d = walk_rays(pack, 512, 512, 16384, 16384, seed=34)
        state = torch.from_numpy(np.random.default_rng(35).integers(0, 2**32, size=o.x.numel(),
                                                                    dtype=np.int64)).to(DEVICE)
        base = cuda_trace.trace_grid_cuda(o, d, state, pack, kw["tcfg"])[0].to_rows()
        for drop in DROPS:
            os.environ["PATHTRACER_BVH_DROP"] = drop
            _sc, pack, kw = scene_setup(pt, "bench_mesh", 512, 512, 8)
            rk, sk, gk = cuda_trace.trace_grid_cuda(o, d, state, pack, kw["tcfg"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rp, sp, gp = cuda_trace.trace_grid_plain(o, d, state, pack, kw["tcfg"])
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            a, b = rk.to_rows(), rp.to_rows()
            bits = torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(sk, sp) and int(gk) == int(gp)
            moved = int((a != base).any(dim=1).sum())
            ok = bits and moved > 0
            held.setdefault("B3 through trace()", {})[drop] = ok
            good = good and ok
            print(f"[34] B3 through trace(), bench_mesh gpu contract d8, drop {drop}: {o.x.numel()} rays, radiance, "
                  f"state and segments bit-identical {bits} (segments {int(gk)} vs {int(gp)}), rays that differ "
                  f"from the undropped trace {moved}; plain version {plain_s:.1f} s | card {card}", flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not good:
        print("[34] FAIL: a dropped walk's kernel disagrees with its plain version, or left the image as it was",
              file=sys.stderr)
    return held, good


TOOLS_DIR = os.path.join(HERE, "build", "tools")  # --tools' logs and JSON lines (build/ is not committed)
TOOL = "path_trace_golang_tpu_torch.tools.perf."
# phase 35: (label, module, arguments, environment) at the smallest arguments
TOOL_SMOKE = (
    ("walk_attrib", TOOL + "walk_attrib", ["1", "--size", "64"], {}),
    ("tri_scaling", TOOL + "tri_scaling", ["--sizes", "80x64,250x200", "--size", "64", "--reps", "1"], {}),
    ("many_lights", TOOL + "many_lights", ["1", "64", "36", "1"], {}),
    ("fixed_cost", TOOL + "fixed_cost", ["1", "--size", "64"], {}),
    ("mesh_scaling", TOOL + "mesh_scaling", ["32", "16", "2", "--depth", "2", "--shapes", "1x1,2x1,1x2", "--reps",
                                             "1"], {}),
    ("mesh_attrib", TOOL + "mesh_attrib", ["32", "16", "2", "--depth", "2", "--shapes", "1x1,2x1,1x2", "--reps",
                                           "1"], {}),
    ("graft_entry", "path_trace_golang_tpu_torch.graft_entry", ["--devices", "2"], {}),
    ("time_phases", "path_trace_golang_tpu_torch", ["-scene", "demo_cornell", "-gpu", "-headless", "--width", "64",
                                                    "--height", "36", "--spp", "2", "--depth", "4", "--json-stats"],
     {"PATHTRACER_TIME_PHASES": "1"}),
)
# --tools: the same at full arguments on one card; --tools --across-cards: the mesh tools over NCCL
TOOL_FULL = (
    ("walk_attrib", TOOL + "walk_attrib", [], {}),
    ("tri_scaling", TOOL + "tri_scaling", [], {}),
    ("many_lights", TOOL + "many_lights", [], {}),
    ("fixed_cost", TOOL + "fixed_cost", [], {}),
) + tuple(
    (f"{tool}_{scene}", TOOL + tool, ["1920", "1080", spp, "--scene", scene], {})
    for tool, spp in (("mesh_scaling", "8"), ("mesh_attrib", "4")) for scene in ("demo_showcase", "bench_mesh")
) + (
    ("graft_entry", "path_trace_golang_tpu_torch.graft_entry", [], {}),
    ("time_phases", "path_trace_golang_tpu_torch", ["-scene", "demo_showcase", "-gpu", "-headless", "--width", "1920",
                                                    "--height", "1080", "--spp", "8", "--depth", "12", "--json-stats"],
     {"PATHTRACER_TIME_PHASES": "1"}),
)
PHASE_NAMES = ("pack_scene", "trace_config", "accum_init", "pass_window@", "interval@", "final_fetch")


def run_tools(tools, card, tag, out_dir=None, extra=()):
    """Each tool in a process of its own: exit 0, its last line a JSON object
    with no call of a plain version (the CLI's stats line, whose phase table
    on stderr must name the JAX Renderer's phases in their order).  Prints a
    line a tool; returns {label: the JSON line} or None on a failure."""
    results = {}
    for label, module, args, env in tools:
        cmd = [sys.executable, "-m", module] + list(args) + list(extra if module.startswith(TOOL + "mesh") else ())
        if out_dir and module != "path_trace_golang_tpu_torch":
            cmd += ["--out", os.path.join(out_dir, f"{label}.json")]
        if module == "path_trace_golang_tpu_torch":
            cmd += ["-out", os.path.join(FRONT_END_DIR, f"{label}.png")]
            os.makedirs(FRONT_END_DIR, exist_ok=True)
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=HERE, env={**os.environ, **env}, capture_output=True, text=True, timeout=1800)
        secs = time.perf_counter() - t0
        if out_dir:
            with open(os.path.join(out_dir, f"{label}.log"), "w") as f:
                f.write(f"$ {' '.join(cmd)}\n{p.stdout}\n--- stderr\n{p.stderr}")
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
        try:
            line = json.loads(lines[-1])
        except (IndexError, ValueError):
            line = None
        problem = None
        if p.returncode != 0 or line is None:
            problem = f"exit {p.returncode}, JSON line {'parsed' if line is not None else 'missing'}"
        elif line.get("plain_calls", 0) != 0 and str(line.get("device", "cuda")).startswith("cuda"):
            problem = f"{line['plain_calls']} calls of a plain version"
        elif "PATHTRACER_TIME_PHASES" in env:
            names = [ln.split()[1] for ln in p.stderr.splitlines() if ln.startswith("  phase ")]
            order = [next((i for i, ph in enumerate(PHASE_NAMES) if n.startswith(ph)), -1) for n in names]
            if not names or names[0] != "pack_scene" or names[-1] != "final_fetch" or -1 in order:
                problem = f"phase table {names}"
            line["phases"] = names
        results[label] = line
        shown = {k: v for k, v in (line or {}).items() if k not in ("rows", "note", "card")}
        print(f"[{tag}] {label}: {' '.join(cmd[2:])} in {secs:.1f} s: {problem or 'ok'}; "
              f"{json.dumps(shown)[:600]} | card {card}", flush=True)
        if problem:
            print(f"[{tag}] FAIL: {label}: {problem}\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}", file=sys.stderr)
            return None
    return results


# ---- phases 36-38: PATHTRACER_NO_REGEN, the profiling knobs, the page statistics
# phase 36's holds of the classic instance under the gpu contract: (scene, width, height, depth); the first two
# in 4 chunks of SMALL_CHUNK lanes, the last padded, the third as one chunk through cuda_trace.render_pass_cuda
NOREGEN_HOLDS = (("demo_showcase", 256, 144, 12), ("bench_mesh", 192, 192, 8), ("demo_cornell", 256, 144, 12))
NOREGEN_FRAME = ("demo_showcase", 1920, 1080, 1, 12)  # phase 36's full-width render: scene, w, h, passes, depth
# phase 37's timed pair of PATHTRACER_NO_WALK_SKIP: (scene, w, h, passes, depth), the main path's frame (one
# pass) and the mesh path's
WALK_SKIP_CELLS = (("demo_showcase", 1920, 1080, 1, 12), ("bench_mesh", 512, 512, 8, 8))
GOLDEN_BANDS = (0.015, 0.06)  # tests/test_goldens.py: the image mean within 1.5%, its std within 6%
# the profiling knobs: (variable, TraceConfig's name for it)
KNOBS = (("PATHTRACER_PROF_NO_MESH_HIT", "hit"), ("PATHTRACER_PROF_NO_MESH_LITE", "lite"),
         ("PATHTRACER_PROF_NO_MESH_OCCL", "occl"), ("PATHTRACER_NO_WALK_SKIP", "walk_all"))
# phase 37's paths: (label, scene, width, height, depth, contract, faithful fog, environment, the knobs that must
# change its image: every query type that the path runs on a mesh)
KNOB_PATHS = (
    ("B1 paged instance", "demo_mesh", 64, 64, 4, "gpu", False, {}, ("hit", "occl")),
    ("B1 page-free (static mesh) and the fog kernel", "demo_showcase", 64, 64, 4, "gpu", False, {},
     ("hit", "occl")),
    ("classic instance, gpu contract under NO_REGEN, paged", "demo_mesh", 64, 64, 4, "gpu", False,
     {"PATHTRACER_NO_REGEN": "1"}, ("hit", "occl")),
    ("classic instance, gpu contract under NO_REGEN, fog once, static mesh", "demo_showcase", 64, 32, 3, "gpu",
     False, {"PATHTRACER_NO_REGEN": "1"}, ("hit", "occl")),
    ("classic instance, gpu contract under NO_REGEN, fog once, paged", "demo_showcase", 64, 32, 3, "gpu", False,
     {"PATHTRACER_NO_REGEN": "1", "PATHTRACER_BVH_DYNAMIC": "1"}, ("hit", "occl")),
    ("classic instance, cpu contract, paged", "demo_mesh", 64, 64, 4, "cpu", False, {}, ("hit",)),
    ("classic instance, faithful fog, paged", "demo_showcase", 64, 32, 3, "gpu", True,
     {"PATHTRACER_BVH_DYNAMIC": "1"}, ("hit", "occl")),
)
# phase 38 at the smallest arguments; --tools at full ones
PAGE_TOOLS_SMOKE = (
    ("union_stats", TOOL + "union_stats", ["--sizes", "80x64", "--rows", "8"], {}),
    ("want_stats", TOOL + "want_stats", ["--sizes", "80x64", "--rows", "8"], {}),
    ("build_probe", TOOL + "build_probe", ["--rows", "8"], {}),
)
PAGE_TOOLS_FULL = tuple((label, module, [], {}) for label, module, _a, _e in PAGE_TOOLS_SMOKE)


class env_set:
    """Set environment variables for a block, and put back what was there."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def noregen_holds(pt, cuda_trace):
    """Phase 36's holds in the fourth process: under PATHTRACER_NO_REGEN the
    gpu contract runs the classic instance (the march kernel, then the
    sample kernel, 16 samples a pass), held bit for bit with segments equal
    to its plain version, the classic loop of render.pass_body_grid: a
    scene without fog as one chunk, launched through render_pass_cuda as
    the Renderer launches a pass, and the paged mesh in 4 chunks, the last
    padded (the showcase's fog once: ``noregen_chunk_holds``).  Returns
    (all held, seconds by scene: of the plain version, of the whole
    chunked hold)."""
    good, plain = True, {}
    with env_set(PATHTRACER_NO_REGEN="1"):
        name, w, h, depth = NOREGEN_HOLDS[1]
        t0 = time.perf_counter()
        good, _err = hold_classic_frame(pt, cuda_trace, "36", name, w, h, depth, SMALL_CHUNK, 1, "gpu", False)
        plain[name] = time.perf_counter() - t0
        for name, w, h, depth in NOREGEN_HOLDS[2:]:
            _sc, pack, kw = scene_setup(pt, name, w, h, depth)
            before = (cuda_trace.CLASSIC_LAUNCHES, cuda_trace.MARCH_LAUNCHES, cuda_trace.FOG_LAUNCHES)
            held, _err, secs = hold_pass(pt, cuda_trace, "36", name, w, h, depth, passes=(1,))
            launched = (cuda_trace.CLASSIC_LAUNCHES - before[0], cuda_trace.MARCH_LAUNCHES - before[1],
                        cuda_trace.FOG_LAUNCHES - before[2])
            ok = held and not kw["tcfg"].regen and launched == (16, 16, 0)
            plain[name] = secs[1]
            print(f"[36] {name}: the config's regen {kw['tcfg'].regen}, fog once "
                  f"{kw['tcfg'].enable_fog_march and not kw['tcfg'].fog_in_trace}, pages {pack.paged is not None}; "
                  f"launches of the sample kernel, the march kernel and the fog kernel {launched} (want 16, 16, 0): "
                  f"{'held' if ok else 'FAIL'}", flush=True)
            good = good and ok
    return good, plain


def noregen_chunk_holds(pt, cuda_trace) -> bool:
    """Phase 36's chunked holds of the showcase: under PATHTRACER_NO_REGEN
    the classic instance with the fog once a pass, at 256x144 in 4 chunks
    of 10,000 lanes, the last padded, and on the padded last chunk of the
    1080p frame that phase 36 times (8 chunks of the default chunk), each
    held bit for bit with segments equal to the plain version chunk by
    chunk.  Returns (both held, seconds of the plain version on the 1080p
    chunk)."""
    import torch

    t0 = time.perf_counter()
    with env_set(PATHTRACER_NO_REGEN="1"):
        name, w, h, depth = NOREGEN_HOLDS[0]
        good, _err = hold_classic_frame(pt, cuda_trace, "36", name, w, h, depth, SMALL_CHUNK, 1, "gpu", False)
        name, w, h, _passes, depth = NOREGEN_FRAME
        chunk, n = pt.render.env_config.get_chunk_size(), w * h
        n_pad = -(-n // chunk) * chunk
        _sc, pack, kw = scene_setup(pt, name, w, h, depth)
        px, py = lanes(w, h, 0, n_pad)
        acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
        cuda_trace.classic_render_cuda(acc, pack, 1, px, py, chunk=chunk, **kw)
        fog_once = kw["tcfg"].enable_fog_march and not kw["tcfg"].fog_in_trace
        last, _err, plain_s = hold_classic_chunk(cuda_trace, "36", f"{name} {w}x{h} d{depth} under NO_REGEN (fog "
                                                 f"once {fog_once}, {n_pad // chunk} chunks)", pack, kw, acc, px,
                                                 py, n_pad - chunk, chunk, n)
        good = good and last and not kw["tcfg"].regen and fog_once
    print(f"[36] the showcase's chunked holds in {time.perf_counter() - t0:.1f} s: {'held' if good else 'FAIL'}",
          flush=True)
    return good, plain_s


def side_holds(pt, cuda_trace) -> bool:
    """``--side-holds``: the main run's fifth process, beside phases 7-10:
    phase 36's chunked holds of the showcase (``noregen_chunk_holds``),
    phase 15's faithful-fog frame at 256x144 d12 as one chunk and phase
    19's first chunk of the 1080p faithful-fog frame (rendered here as the
    Renderer launches it, frame seed 1), each bit for bit with segments
    equal.  Prints ``SIDE-HOLDS {json}`` with the largest |a-b| and the
    seconds of the plain version on the two 1080p chunks; returns whether
    all held."""
    import torch

    t0 = time.perf_counter()
    good, noregen_plain_s = noregen_chunk_holds(pt, cuda_trace)
    held, err, _s = hold_pass(pt, cuda_trace, "15", "demo_showcase", 256, 144, 12, passes=(1,), contract="gpu",
                              faithful=True)
    good = good and held
    chunk, n = pt.render.env_config.get_chunk_size(), 1920 * 1080
    n_pad = -(-n // chunk) * chunk
    _sc, pack, kw = scene_setup(pt, "demo_showcase", 1920, 1080, 12, "gpu", True)
    px, py = lanes(1920, 1080, 0, n_pad)
    acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
    cuda_trace.classic_render_cuda(acc, pack, 1, px, py, chunk=chunk, **kw)
    first, err19, plain_s = hold_classic_chunk(cuda_trace, "19", "demo_showcase 1920x1080 d12 faithful fog", pack, kw,
                                               acc, px, py, 0, chunk, n)
    good = good and first
    print(f"[15/19/36] the fifth process's holds in {time.perf_counter() - t0:.1f} s: {'held' if good else 'FAIL'}",
          flush=True)
    print("SIDE-HOLDS " + json.dumps({"max_abs_err": max(err, err19), "fog_chunk_plain_s": plain_s,
                                      "noregen_chunk_plain_s": noregen_plain_s}), flush=True)
    return good


def knob_image(cuda_trace, pack, kw, px, py):
    col, segs = cuda_trace.render_pass_cuda(pack, 7, px, py, n_passes=1, **kw)
    return col.to_rows(), int(segs)


def knob_phase(pt, cuda_trace, card):
    """Phase 37: each profiling knob through the profiling build of the
    kernels, held bit for bit (segments equal) to the plain versions on
    every path of KNOB_PATHS and on B3 through trace(); each mesh knob must
    change the image of the paths that run its query type, and
    PATHTRACER_NO_WALK_SKIP must leave every image as the shipped build's,
    bit for bit.  Returns ({path: {knob: held}}, all held)."""
    import numpy as np
    import torch

    held, good = {}, True
    unset = {var: None for var, _ in KNOBS}
    for label, name, w, h, depth, contract, faithful, env, must_move in KNOB_PATHS:
        px, py = lanes(w, h)
        with env_set(**{**unset, **env}):
            _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
            base, base_segs = knob_image(cuda_trace, pack, kw, px, py)
        for var, knob in KNOBS:
            with env_set(**{**unset, **env, var: "1"}):
                _sc, pack, kw = scene_setup(pt, name, w, h, depth, contract, faithful)
                bits_of = cuda_trace.prof_bits(kw["tcfg"])
                col_k, segs_k = knob_image(cuda_trace, pack, kw, px, py)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                col_p, segs_p = cuda_trace.render_pass_plain(pack, 7, px, py, n_passes=1, **kw)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t0
            a, b = col_k, col_p.to_rows()
            bits = torch.equal(a.view(torch.int32), b.view(torch.int32)) and segs_k == int(segs_p)
            moved = int((a != base).any(dim=1).sum())
            if knob == "walk_all":
                ok = bits and moved == 0 and segs_k == base_segs
            else:
                ok = bits and (moved > 0 or knob not in must_move)
            held.setdefault(label, {})[knob] = ok
            good = good and ok and bits_of != 0
            print(f"[37] {label}, {name} {w}x{h} d{depth}, {var}=1 (PT_PROF={bits_of}): kernel against plain "
                  f"bit-identical {bits} (segments {segs_k} vs {int(segs_p)}), lanes that differ from the shipped "
                  f"build's image {moved} of {w * h}{' (must be 0)' if knob == 'walk_all' else ''}"
                  f"{' (must be > 0)' if knob in must_move else ''}: {'held' if ok else 'FAIL'}; plain version "
                  f"{plain_s:.1f} s", flush=True)
    # B3 through trace(), gpu contract, on demo_mesh's pages
    with env_set(**unset):
        _sc, pack, kw = scene_setup(pt, "demo_mesh", 64, 64, 8)
        o, d = walk_rays(pack, 64, 64, 2048, 2048, seed=37)
        state = torch.from_numpy(np.random.default_rng(38).integers(0, 2**32, size=o.x.numel(),
                                                                    dtype=np.int64)).to(DEVICE)
        base = cuda_trace.trace_grid_cuda(o, d, state, pack, kw["tcfg"])[0].to_rows()
    for var, knob in KNOBS:
        with env_set(**{**unset, var: "1"}):
            _sc, pack, kw = scene_setup(pt, "demo_mesh", 64, 64, 8)
            rk, sk, gk = cuda_trace.trace_grid_cuda(o, d, state, pack, kw["tcfg"])
            rp, sp, gp = cuda_trace.trace_grid_plain(o, d, state, pack, kw["tcfg"])
        a, b = rk.to_rows(), rp.to_rows()
        bits = torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(sk, sp) and int(gk) == int(gp)
        moved = int((a != base).any(dim=1).sum())
        ok = bits and (moved == 0 if knob == "walk_all" else moved > 0 or knob == "lite")
        held.setdefault("B3 through trace()", {})[knob] = ok
        good = good and ok
        print(f"[37] B3 through trace(), demo_mesh gpu contract d8, {var}=1: {o.x.numel()} rays, radiance, state and "
              f"segments bit-identical {bits}, rays that differ from the shipped build's {moved}: "
              f"{'held' if ok else 'FAIL'} | card {card}", flush=True)
    if not good:
        print("[37] FAIL: a profiling build disagrees with its plain version, a mesh knob left an image as it was, "
              "or PATHTRACER_NO_WALK_SKIP changed one", file=sys.stderr)
    return held, good


def sass_digests(cuda_trace):
    """The shipped build's machine code: {source: (functions, sha256 of
    ``cuobjdump -sass`` over its functions)}; the functions' own digests
    under "functions".  A function's name is taken without its anonymous
    namespace, whose mangled name holds a hash of the file's path."""
    import hashlib
    import re

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out, per_fn = {}, {}
    for source in cuda_trace.SOURCES:
        so = cuda_trace.build(False, source)
        text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True).stdout
        fns, name, body = {}, None, []
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                if name:
                    fns[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
                name, body = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1)), []
            elif name and line.strip().startswith("/*"):
                body.append(line.strip())
        if name:
            fns[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
        whole = hashlib.sha256("".join(f"{k}:{v};" for k, v in sorted(fns.items())).encode()).hexdigest()[:16]
        out[source] = (len(fns), whole)
        per_fn[source] = fns
    out["functions"] = per_fn
    return out


def noregen_timing(pt, cuda_trace, card):
    """Phase 36's full-width run: the Renderer on the 1080p showcase, depth
    12, one pass of 16 samples, under PATHTRACER_NO_REGEN beside the
    regeneration path on the same passes; the classic instance's launches,
    its device time on the frame and its bound from the counting build's
    operations.  Returns a dict, or None on a failure."""
    import torch

    name, w, h, passes, depth = NOREGEN_FRAME
    with env_set(PATHTRACER_NO_REGEN="1"):
        classic = drive_renderer(pt, cuda_trace, "36", name, w, h, passes, depth, 3, card)
        _sc, pack, kw = scene_setup(pt, name, w, h, depth)
        chunk = min(pt.render.env_config.get_chunk_size(), w * h)
        n_pad = -(-(w * h) // chunk) * chunk
        fpx, fpy = lanes(w, h, 0, n_pad)
        acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
        frame = lambda: cuda_trace.classic_render_cuda(acc, pack, 1, fpx, fpy, chunk=chunk, n_passes=1, **kw)  # noqa
        events_ms = cuda_time_ms(frame, 3)
        names = ("classic_march_kernel", "classic_sample_kernel")
        timed = device_ms(frame, names)
        counted = cuda_trace.classic_count_split(acc, pack, 1, fpx, fpy, chunk=chunk, n_passes=1, **kw)
    regen = drive_renderer(pt, cuda_trace, "36", name, w, h, passes, depth, 3, card)
    sp = cuda_trace.classic_split([counted])
    c = classic["counts"]
    mean_k, mean_r = float(classic["img"].mean()), float(regen["img"].mean())
    std_k, std_r = float(classic["img"].std()), float(regen["img"].std())
    banded = abs(mean_k - mean_r) <= GOLDEN_BANDS[0] * mean_r and abs(std_k - std_r) <= GOLDEN_BANDS[1] * std_r
    device = (sum(timed[k] for k in names) if all(timed[k] is not None for k in names) else None)
    if device is not None and device < 0.5 * events_ms:  # the profiler's capture came back short: not a time
        print(f"[36] torch.profiler saw {device:.3f} ms of the two kernels against {events_ms:.3f} ms of events: "
              f"its capture is short, and not reported", flush=True)
        device = timed["classic_march_kernel"] = timed["classic_sample_kernel"] = None
    out = {
        "mrays_classic": statistics.median(classic["rates"]), "mrays_regen": statistics.median(regen["rates"]),
        "launches": c["CLASSIC_LAUNCHES"], "march_launches": c["MARCH_LAUNCHES"], "renders": 4,
        "regen_launches_under_no_regen": c["LAUNCHES"] - c["CLASSIC_LAUNCHES"], "fog_launches": c["FOG_LAUNCHES"],
        "events_ms": events_ms, "device_ms": device, "march_ms": timed["classic_march_kernel"],
        "sample_ms": timed["classic_sample_kernel"], "ops": sp["ops"], "bound_ms": sp["bound_ops_ms"],
        "bound_slots_ms": sp["bound_slots_ms"], "split": sp, "image_means": (mean_k, mean_r),
        "image_stds": (std_k, std_r), "within_bands": banded,
        "ptxas": ptxas_of(cuda_trace, "classic", "classic_"),
    }
    ok = (banded and classic["stats"].nonfinite == 0 and classic["plain_calls"] == 0 and regen["plain_calls"] == 0
          and c["CLASSIC_LAUNCHES"] == 16 * 4 and c["MARCH_LAUNCHES"] == 16 * 4 and c["FOG_LAUNCHES"] == 0
          and c["LAUNCHES"] == c["CLASSIC_LAUNCHES"])
    print(f"[36] {name} {w}x{h} d{depth}, {passes} pass of 16 samples: under PATHTRACER_NO_REGEN "
          f"{out['mrays_classic']:.3f} Mrays/s (the classic instance: {c['CLASSIC_LAUNCHES']} launches of the sample "
          f"kernel and {c['MARCH_LAUNCHES']} of the march kernel over 4 renders, no other), the regeneration path "
          f"{out['mrays_regen']:.3f} Mrays/s; the frame's classic call {events_ms:.3f} ms (events), device "
          f"{device if device is None else round(device, 3)} ms (march {timed['classic_march_kernel']}, samples "
          f"{timed['classic_sample_kernel']}), bound {sp['bound_ops_ms']:.4f} ms ({sp['ops']:.6g} f32 operations; "
          f"{sp['bound_slots_ms']:.4f} ms as FFMA slots); images mean {mean_k:.4f} vs {mean_r:.4f}, std "
          f"{std_k:.4f} vs {std_r:.4f}: within the goldens' bands {banded}; nonfinite {classic['stats'].nonfinite}; "
          f"plain calls {classic['plain_calls']} | card {card}", flush=True)
    print(f"[36] the classic instance's split under the gpu contract: {cuda_trace.classic_split_line(sp)} | card "
          f"{card}", flush=True)
    if not ok:
        print("[36] FAIL: NO_REGEN's render left the goldens' bands, was not finite, called a plain version or did "
              "not run on the classic instance alone", file=sys.stderr)
        return None
    return out


def walk_skip_timing(pt, cuda_trace, card):
    """Phase 37's timed pair: what PATHTRACER_NO_WALK_SKIP costs on the card.
    There it makes every lane that hit run NEE, and every lane of a scene
    with rough metal run the specular-NEE query, their results dropped
    (common.cuh, PROF_WALK_ALL); a lane whose path ended or missed has left
    its loop and walks nothing, where the JAX knob and the plain version
    make such lanes walk.  The Renderer on each of WALK_SKIP_CELLS without
    the knob, with it, with it and without (3 timed renders each).  Returns
    {cell: (median Mrays/s without, with)}, or None where a render called
    a plain version, was not finite or changed the image."""
    import numpy as np

    out, good = {}, True
    for name, w, h, passes, depth in WALK_SKIP_CELLS:
        runs = {}
        for knob in (None, "1", "1", None):
            with env_set(PATHTRACER_NO_WALK_SKIP=knob):
                r = drive_renderer(pt, cuda_trace, "37", name, w, h, passes, depth, 3, card)
            runs.setdefault(knob, []).append(r)
        every = runs[None] + runs["1"]
        same = all(np.array_equal(r["img"], every[0]["img"]) and r["stats"].ray_segments ==
                   every[0]["stats"].ray_segments for r in every)
        ok = same and all(r["plain_calls"] == 0 and r["stats"].nonfinite == 0 for r in every)
        off = statistics.median([x for r in runs[None] for x in r["rates"]])
        on = statistics.median([x for r in runs["1"] for x in r["rates"]])
        out[f"{name} {w}x{h} d{depth} x{passes}"] = (off, on)
        good = good and ok
        print(f"[37] PATHTRACER_NO_WALK_SKIP on the card, {name} {w}x{h} d{depth} {passes} passes (off, on, on, off; "
              f"3 renders each): {off:.3f} Mrays/s median without the knob, {on:.3f} with it (PT_PROF="
              f"{cuda_trace.PROF_WALK_ALL}), {on / off:.4f} of it; images and segments equal {same}: "
              f"{'held' if ok else 'FAIL'} | card {card}", flush=True)
    return out if good else None


def prof_variants(cuda_trace):
    """The PT_PROF bits of phase 37's profiling builds: one knob each."""
    return sorted({cuda_trace.PROF_BITS[k] for _v, k in KNOBS if k != "walk_all"} | {cuda_trace.PROF_WALK_ALL})


def phases_36_38(pt, cuda_trace, card):
    """``--phases-36-38`` (the default run's fourth process, beside phases
    7-10) and ``--knobs``: the render libraries' profiling builds (one nvcc
    each, side by side; --knobs built them in phase 2), phase 36's holds,
    phase 37 and phase 38 at the tools' smallest arguments.  Prints a
    summary line; returns whether all held."""
    t0 = time.perf_counter()
    jobs = [(src, b) for src in ("render_pass", "classic") for b in prof_variants(cuda_trace)]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for f in [pool.submit(cuda_trace.build, False, src, b) for src, b in jobs]:
            f.result()
    print(f"[36-38] the profiling builds ready in {time.perf_counter() - t0:.1f} s", flush=True)
    held36, plain36 = noregen_holds(pt, cuda_trace)
    held37, good37 = knob_phase(pt, cuda_trace, card)
    tools = run_tools(PAGE_TOOLS_SMOKE, card, "38") if held36 and good37 else None
    print(f"[36-38] in {time.perf_counter() - t0:.1f} s | card {card}", flush=True)
    print("PHASES-36-38 " + json.dumps({"noregen_held": held36, "noregen_plain_s": plain36, "knobs": held37,
                                        "page_tools": {k: {"counted_equal": v.get("counted_equal")}
                                                       for k, v in (tools or {}).items()}}), flush=True)
    return held36 and good37 and tools is not None


def main(argv) -> int:
    quick = "--quick" in argv
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.ops.vec import V3
    from path_trace_golang_tpu_torch.scene import builtin

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert "jax" not in sys.modules, "the port must not import jax"

    # ---- 1. the card
    card = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    if "--render-only" in argv:
        rest = argv[argv.index("--render-only") + 1:]
        contract = rest[rest.index("--contract") + 1] if "--contract" in rest else "gpu"
        faithful = "--faithful-fog" in rest
        args = [a for i, a in enumerate(rest) if not a.startswith("--") and (i == 0 or rest[i - 1] != "--contract")]
        name = args[0] if args else "demo_showcase"
        w, h, passes, depth, renders = (int(a) for a in (args[1:6] + ["1920", "1080", "8", "12", "5"][len(args[1:6]):]))
        run = drive_renderer(pt, cuda_trace, "render", name, w, h, passes, depth, renders, card, contract, faithful)
        times = {}
        if "--kernels" in rest:
            times = frame_kernel_times(pt, cuda_trace, name, w, h, passes, depth, contract, faithful)
            run["plain_calls"] = sum(getattr(cuda_trace, c, 0) for c in PLAIN_COUNTERS)  # the render's too
        if "--split" in rest:
            times["split"], times["march_split"] = render_split(pt, cuda_trace, name, w, h, passes, depth, contract,
                                                                faithful)
            b1 = contract == "gpu" and not faithful
            line = (cuda_trace.split_line if b1 else cuda_trace.classic_split_line)(times["split"])
            what = f"on {name} {w}x{h} d{depth} x{passes}, {contract} contract{', faithful fog' if faithful else ''}"
            print(f"[render] {'B1' if b1 else 'the classic instance'}'s split {what}: {line} | card {card}",
                  flush=True)
            if times["march_split"] is not None:
                print(f"[render] the fog march's split ({'the fog kernel' if b1 else 'classic_march_kernel'}) "
                      f"{what}: {cuda_trace.march_split_line(times['march_split'])} | card {card}", flush=True)
            if hasattr(cuda_trace, "trace_split"):
                times["trace_split"], times["trace_march_split"] = frame_trace_split(
                    pt, cuda_trace, name, w, h, depth, contract, faithful)
                print(f"[render] B3's split through trace() on the first chunk's primary rays {what}: "
                      f"{cuda_trace.trace_split_line(times['trace_split'])} | card {card}", flush=True)
                if times["trace_march_split"] is not None:
                    print(f"[render] B3's in-trace fog march's split {what}: "
                          f"{cuda_trace.march_split_line(times['trace_march_split'])} | card {card}", flush=True)
        print(json.dumps({
            "scene": name, "width": w, "height": h, "passes": passes, "depth": depth, "renders": renders,
            "contract": contract, "faithful_fog": faithful, "card": card, "tree": HERE,
            "mrays_per_sec": {"median": statistics.median(run["rates"]), "min": min(run["rates"]),
                              "max": max(run["rates"])},
            "wall_seconds": {"median": statistics.median(run["walls"]), "min": min(run["walls"]),
                             "max": max(run["walls"])},
            "segments": run["stats"].ray_segments, "nonfinite": run["stats"].nonfinite,
            "launches_per_render": run["counts"]["LAUNCHES"] / (renders + 1),
            "kernel_ms": times, "ptxas": ptxas_lines(cuda_trace),
        }))
        if run["stats"].nonfinite != 0 or run["counts"]["LAUNCHES"] <= 0 or run["plain_calls"] != 0:
            print("[render] FAIL: non-finite entries, or the render did not run on the kernel alone", file=sys.stderr)
            return 1
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    if "--classic-holds" in argv:
        return 0 if classic_holds(pt, cuda_trace) else 1
    if "--phases-36-38" in argv:  # the default run's fourth process: the libraries are built
        return 0 if phases_36_38(pt, cuda_trace, card) else 1
    if "--side-holds" in argv:  # the default run's fifth process: the libraries are built
        return 0 if side_holds(pt, cuda_trace) else 1
    if "--phases-34-35" in argv:  # the default run's third process: the libraries are built
        t_side = time.perf_counter()
        held, good = drop_phase(pt, cuda_trace, card)
        tools = run_tools(TOOL_SMOKE, card, "35") if good else None
        print(f"[34-35] in {time.perf_counter() - t_side:.1f} s | card {card}", flush=True)
        print("PHASES-34-35 " + json.dumps({"drop": held, "tools": sorted(tools or {})}), flush=True)
        return 0 if good and tools is not None else 1

    # ---- 2. build: one nvcc for each source and variant, all started together (--probes, --repro: that
    # library only; the repros' counting variant holds T6's step split alone: their bounds come from their shapes)
    probes_only, repro_only, front_only = "--probes" in argv, "--repro" in argv, "--front-end" in argv
    mesh_only = "--mesh" in argv
    drop_only, tools_only = "--drop" in argv, "--tools" in argv
    knobs_only, sass_only = "--knobs" in argv, "--sass" in argv
    sources = ("probes",) if probes_only else ("repro",) if repro_only else (
        ("render_pass", "classic") if front_only or mesh_only or drop_only or tools_only or knobs_only
        else tuple(cuda_trace.SOURCES))
    # the variants: the shipped build, the counting build and, of the render libraries, the profiling builds
    # of phase 37's knobs, one knob each
    # (--sass builds the shipped build alone, and runs in a parent's tree too; the default run's fourth process
    # builds the profiling builds beside phases 7-10, --knobs here)
    jobs = [(src, c, {}) for src in sources for c in ((False,) if sass_only else (False, True))]
    if knobs_only:
        jobs += [(src, False, {"prof": b}) for src in sources for b in prof_variants(cuda_trace)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        builds = [pool.submit(cuda_trace.build, count_ops=c, source=src, **kw) for src, c, kw in jobs]
        sos = [b.result() for b in builds]
    print(
        f"[2] built {', '.join(os.path.relpath(so, HERE) for so in sos)} in {time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    for src, log in cuda_trace.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill", "smem", "error", "warning")):
                print(f"    ptxas {src}: {line.strip()}", flush=True)

    if sass_only:
        digests = sass_digests(cuda_trace)
        for src, (n_fn, dig) in ((k, v) for k, v in digests.items() if k != "functions"):
            print(f"[sass] {src}: {n_fn} functions, digest {dig} (cuobjdump -sass of the shipped build)", flush=True)
        print("SASS " + json.dumps(digests), flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if knobs_only:
        good = phases_36_38(pt, cuda_trace, card) and noregen_chunk_holds(pt, cuda_trace)[0]
        timing = noregen_timing(pt, cuda_trace, card) if good else None
        timing = timing and walk_skip_timing(pt, cuda_trace, card)
        digests = sass_digests(cuda_trace)
        print("SASS " + json.dumps(digests), flush=True)
        if timing is None:
            return 1
        print(f"[done] phases 1, 2 and 36-38 in {time.perf_counter() - t_start:.1f} s", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if probes_only:
        rows = probe_phases(card)
        if rows is None:
            return 1
        print(f"[done] phases 1, 2 and 20-23 in {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": rows}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if front_only:
        walls = front_end_phases(pt, cuda_trace, card)
        if walls is None:
            return 1
        print(f"[done] phases 1, 2 and 30-32 in {time.perf_counter() - t_start:.1f} s ({json.dumps(walls)})", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if mesh_only:
        shapes = [tuple(int(x) for x in a.split("x")) for a in argv[argv.index("--mesh") + 1:]
                  if not a.startswith("--")] or MESH_SHAPES
        walls = mesh_phase(pt, cuda_trace, card, shapes, across_cards="--across-cards" in argv)
        if walls is None:
            return 1
        print(f"[done] phases 1, 2 and 33{'c' if '--across-cards' in argv else ''} in "
              f"{time.perf_counter() - t_start:.1f} s ({json.dumps(walls)})", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if drop_only:
        held, good = drop_phase(pt, cuda_trace, card)
        if not good:
            return 1
        print(f"[done] phases 1, 2 and 34 in {time.perf_counter() - t_start:.1f} s ({json.dumps(held)})", flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if tools_only:
        across = "--across-cards" in argv
        os.makedirs(TOOLS_DIR, exist_ok=True)
        tools = [t for t in TOOL_FULL if t[1].startswith(TOOL + "mesh")] if across else TOOL_FULL + PAGE_TOOLS_FULL
        results = run_tools(tools, card, "tools", TOOLS_DIR, extra=("--across-cards",) if across else ())
        if results is None:
            return 1
        print(f"[done] phases 1, 2 and the tools{' across the cards' if across else ''} in "
              f"{time.perf_counter() - t_start:.1f} s (logs and JSON lines in {os.path.relpath(TOOLS_DIR, HERE)})",
              flush=True)
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0
    if repro_only:
        rows = repro_phases(card)
        if rows is None:
            return 1
        print(f"[done] phases 1, 2 and 24-27 in {time.perf_counter() - t_start:.1f} s", flush=True)
        print(json.dumps({"kernels": rows}))
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- 3. kernel vs plain version on the card
    cw, ch, cdepth = (64, 36, 4) if quick else (256, 144, 12)
    max_abs_err = 0.0
    for name in ("demo_showcase", "demo_cornell"):
        good, err, plain_secs = hold_pass(pt, cuda_trace, "3", name, cw, ch, cdepth)
        max_abs_err = max(max_abs_err, err)
        if name == "demo_showcase":
            plain_ms = plain_secs[1] * 1e3  # the plain version's time that the kernels line reports
        if not good:
            print("[3] FAIL: kernel disagrees with its plain version", file=sys.stderr)
            return 1
    # the paged walk's first run: small, synchronised, bit for bit
    walk_err = 0.0
    mesh_packs = {name: pt.pack_scene(getattr(builtin, name)(), 512, 512, device=DEVICE)
                  for name in ("bench_mesh", "demo_mesh")}
    for name, mpack in mesh_packs.items():
        o, d = walk_rays(mpack, 512, 512, 1024, 1024, seed=11)
        same, err = hold_walk(cuda_trace, "3", name, mpack, o, d, seed=12)
        walk_err = max(walk_err, err)
        if not same:
            print("[3] FAIL: the paged walk disagrees with its plain version", file=sys.stderr)
            return 1
    if quick:
        # the classic loop's first run: kernel B3 and the classic instance, small, synchronised
        for name, contract, faithful, depth in (("demo_showcase", "cpu", False, 12),
                                                ("demo_showcase", "gpu", True, 12), ("bench_mesh", "gpu", False, 8)):
            same, _err, _s = hold_trace(pt, cuda_trace, "3", name, contract, faithful, depth, 1024, 1024, seed=13,
                                        inactive=0.2 if faithful else 0.0)
            if not same:
                print("[3] FAIL: kernel B3 disagrees with its plain version", file=sys.stderr)
                return 1
        for contract, faithful in (("cpu", False), ("gpu", True)):
            good, _err, _secs = hold_pass(pt, cuda_trace, "3", "demo_showcase", cw, ch, cdepth, passes=(1,),
                                          contract=contract, faithful=faithful)
            if not good:
                print("[3] FAIL: the classic instance disagrees with its plain version", file=sys.stderr)
                return 1
        print(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    # ---- 4. main path: the Renderer at 1080p, depth 12, one 8-pass window
    main_run = drive_renderer(pt, cuda_trace, "4", "demo_showcase", 1920, 1080, 8, 12, 3, card)
    img, last = main_run["img"], main_run["stats"]
    launches, plain_calls = main_run["counts"]["LAUNCHES"], main_run["plain_calls"]
    if img.shape != (1080, 1920, 3) or str(img.dtype) != "uint8":
        print(f"[4] FAIL: image {img.shape} {img.dtype}", file=sys.stderr)
        return 1
    if last.nonfinite != 0 or not 5.0 < float(img.mean()) < 250.0:
        print("[4] FAIL: non-finite accumulator entries or a blank image", file=sys.stderr)
        return 1

    # ---- 5. the main path went through the kernels
    fog_launches = main_run["counts"]["FOG_LAUNCHES"]
    print(f"[5] kernel launches on the main path: {launches}, fog kernel launches {fog_launches} (4 renders), "
          f"plain calls: {plain_calls}", flush=True)
    if launches <= 0 or fog_launches <= 0 or plain_calls != 0:
        print("[5] FAIL: the main path did not run on the kernels alone", file=sys.stderr)
        return 1

    # ---- 6. time the kernels (main-path shape, and 256x144 where phase 3 timed the plain version)
    # the Renderer's launch shape on the card: the window's n_pad lanes (whole chunks) in one call, the fog
    # kernel then the regeneration instance
    _, pack, kw = scene_setup(pt, "demo_showcase", 1920, 1080, 12)
    chunk = pt.render.env_config.get_chunk_size()
    n = 1920 * 1080
    n_pad = -(-n // chunk) * chunk
    wpx, wpy = lanes(1920, 1080, 0, n_pad)
    box = []
    ms = cuda_time_ms(lambda: box.append(cuda_trace.render_pass_cuda(pack, 1, wpx, wpy, n_passes=8, **kw)), 3)
    frame_cols, segments = box[-1][0].to_rows(), int(box[-1][1])
    terms = cuda_trace.fog_pass(pack, 1, wpx, wpy, n_passes=8, **kw)
    fog_ms = cuda_time_ms(lambda: cuda_trace.fog_pass(pack, 1, wpx, wpy, n_passes=8, **kw), 3)
    b1_box = []
    b1_ms = cuda_time_ms(lambda: b1_box.append(
        cuda_trace.render_pass_cuda(pack, 1, wpx, wpy, n_passes=8, fog_terms=terms, **kw)), 3)
    if not torch.equal(b1_box[-1][0].to_rows(), frame_cols):
        print("[6] FAIL: B1 on given fog terms differs from B1 after its own fog launch", file=sys.stderr)
        return 1
    # the f32 operations and hash rounds these inputs need, tallied by the counting build of the same
    # sources (-DPT_COUNT_OPS), with B1's split; bytes: 8 read + 12 written a lane (B1), 8 read + 12 written a
    # lane and pass (the fog kernel), the terms once written and once read
    split = cuda_trace.b1_split([cuda_trace.count_ops_split(pack, 1, wpx, wpy, n_passes=8, **kw)])
    fog_counted = cuda_trace.fog_count_ops(pack, 1, wpx, wpy, n_passes=8, **kw)
    if split["segments"] != segments:
        print("[6] FAIL: the counting build traced other paths than the kernel", file=sys.stderr)
        return 1
    ops, fog_ops = split["ops"] - fog_counted["ops"], fog_counted["ops"]
    bound_ms = max(ops / PEAK_F32_FLOPS, n_pad * (8 + 12 + 8 * 12) / PEAK_BYTES) * 1e3
    fog_bound_ms = max(fog_ops / PEAK_F32_FLOPS, n_pad * (8 + 8 * 12) / PEAK_BYTES) * 1e3
    slots = lambda o, r: (o + cuda_trace.HASH_ROUND_SLOTS * r) / cuda_trace.UNFUSED_SLOTS * 1e3  # noqa: E731
    bound_slots_ms = slots(ops, split["rng_rounds"] - fog_counted["rng_rounds"])
    fog_bound_slots_ms = slots(fog_ops, fog_counted["rng_rounds"])

    _, spack, skw = scene_setup(pt, "demo_showcase", 256, 144, 12)
    spx, spy = lanes(256, 144)
    small_k = cuda_time_ms(lambda: cuda_trace.render_pass_cuda(spack, 7, spx, spy, n_passes=1, **skw), 3)
    print(
        f"[6] the window as the Renderer launches it (fog kernel and B1, {n_pad} lanes): {ms:.3f} ms, "
        f"{segments} segments, {segments / ms / 1e3:.2f} Mrays/s; B1 alone on the window's fog terms "
        f"{b1_ms:.3f} ms, bound {bound_ms:.4f} ms ({ops:.6g} f32 operations, {ops / segments:.1f} a segment, "
        f"{ops / (b1_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved; {bound_slots_ms:.4f} ms with its hash rounds as "
        f"FFMA slots at 32.79 Tslots/s); the fog kernel alone {fog_ms:.3f} ms, bound {fog_bound_ms:.4f} ms "
        f"({fog_ops:.6g} f32 operations; {fog_bound_slots_ms:.4f} ms as FFMA slots); at 256x144 1 pass: "
        f"{small_k:.3f} ms, plain {plain_ms:.1f} ms (phase 3's run of it on the same inputs) | card {card}",
        flush=True,
    )
    print(f"[6] B1's split on the window: {cuda_trace.split_line(split)} | card {card}", flush=True)
    fog_split = cuda_trace.march_split([fog_counted])
    print(f"[6] the fog kernel's split on the window: {cuda_trace.march_split_line(fog_split)} | card {card}",
          flush=True)

    # the classic instance's two longest holds (phases 15 and 19, faithful fog) in a second process beside
    # phases 7-10, which hold and time nothing; read before phase 11 times the mesh path; stopped at exit
    holds = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--classic-holds"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: holds.poll() is None and (holds.kill(), holds.wait()))
    # phases 34 and 35 in a third process beside them, read with the second
    side = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phases-34-35"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: side.poll() is None and (side.kill(), side.wait()))
    # phase 36's holds, 37 and 38 in a fourth process beside them, read with the others
    knob_side = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phases-36-38"],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: knob_side.poll() is None and (knob_side.kill(), knob_side.wait()))
    # phase 36's chunked holds of the showcase and the faithful-fog holds of phases 15 and 19 (one chunk at
    # 256x144, the first 1080p chunk) in a fifth process beside them, read with the others
    chunk_side = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--side-holds"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: chunk_side.poll() is None and (chunk_side.kill(), chunk_side.wait()))

    # ---- 7. kernel vs plain version at the main path's own arguments
    # (1920x1080 camera mapping, frame seed 1, the 8-pass reseed schedule)
    held = hold_frame_lanes(cuda_trace, "7", "demo_showcase 1920x1080 d12", pack, kw, frame_cols[:n], 1920,
                            MAIN_CHECK_LANES, 8, exact=True)
    if held is None:
        print("[7] FAIL: a lane's result depends on the launch it ran in", file=sys.stderr)
        return 1
    max_abs_err = max(max_abs_err, held[1])
    if not held[0]:
        print("[7] FAIL: kernel disagrees with its plain version at the main path's arguments", file=sys.stderr)
        return 1

    # ---- 8. the paged walk alone against its plain version
    for name, mpack in mesh_packs.items():
        o, d = walk_rays(mpack, 512, 512, 8192, 8192, seed=21)
        same, err = hold_walk(cuda_trace, "8", name, mpack, o, d, seed=22)
        walk_err = max(walk_err, err)
        if not same:
            print("[8] FAIL: the paged walk disagrees with its plain version", file=sys.stderr)
            return 1

    # ---- 9. the whole-pass kernel on mesh scenes; 10. on more than 8 lights
    for tag, name, w, h, depth in (("9", "demo_mesh", 192, 192, 8), ("9", "bench_mesh", 192, 192, 8),
                                   ("10", "many_lights", 192, 108, 6)):
        good, err, _secs = hold_pass(pt, cuda_trace, tag, name, w, h, depth)
        max_abs_err = max(max_abs_err, err)
        if not good:
            print(f"[{tag}] FAIL: kernel disagrees with its plain version on {name}", file=sys.stderr)
            return 1

    print(f"[7-10] done at {time.perf_counter() - t_start:.1f} s; reading the side processes", flush=True)
    print(holds.communicate()[0], end="", flush=True)
    if holds.returncode != 0:
        print("[15/19] FAIL: the classic instance disagrees with its plain version on the chunked faithful-fog "
              "frame or the padded last 1080p chunk (second process)", file=sys.stderr)
        return 1
    side_out = side.communicate()[0]
    print(side_out, end="", flush=True)
    if side.returncode != 0:
        print("[34/35] FAIL: a dropped walk disagrees with its plain version, or a tool failed (third process)",
              file=sys.stderr)
        return 1
    side_summary = json.loads(next(ln for ln in side_out.splitlines() if ln.startswith("PHASES-34-35 "))[13:])
    knob_out = knob_side.communicate()[0]
    print(knob_out, end="", flush=True)
    if knob_side.returncode != 0:
        print("[36-38] FAIL: the classic instance under NO_REGEN or a profiling build disagrees with its plain "
              "version, or a page-statistics tool failed (fourth process)", file=sys.stderr)
        return 1
    knob_summary = json.loads(next(ln for ln in knob_out.splitlines() if ln.startswith("PHASES-36-38 "))[13:])
    chunk_out = chunk_side.communicate()[0]
    print(chunk_out, end="", flush=True)
    if chunk_side.returncode != 0:
        print("[15/19/36] FAIL: the classic instance disagrees with its plain version on the showcase under "
              "NO_REGEN in 4 chunks or on its padded last 1080p chunk, on the faithful-fog frame or on the first "
              "1080p faithful-fog chunk (fifth process)", file=sys.stderr)
        return 1
    side_holds_summary = json.loads(next(ln for ln in chunk_out.splitlines() if ln.startswith("SIDE-HOLDS "))[11:])
    print(f"[7-10] the side processes read at {time.perf_counter() - t_start:.1f} s", flush=True)

    # ---- 11. the mesh path at full width: bench_mesh 512x512, depth 8, one 8-pass window
    mesh_run = drive_renderer(pt, cuda_trace, "11", "bench_mesh", 512, 512, 8, 8, 3, card)
    mimg, mlast = mesh_run["img"], mesh_run["stats"]
    mesh_launches, paged_launches = mesh_run["counts"]["LAUNCHES"], mesh_run["counts"]["PAGED_LAUNCHES"]
    # the scene is bright by design (sky 0.8-1.0, a 40x light): the mean sits near 254,
    # so blank is told by the spread, not by the mean
    if mimg.shape != (512, 512, 3) or mlast.nonfinite != 0 or float(mimg.mean()) <= 5.0 or float(mimg.std()) <= 1.0:
        print("[11] FAIL: wrong shape, non-finite accumulator entries or a blank image", file=sys.stderr)
        return 1
    if paged_launches <= 0 or paged_launches != mesh_launches or mesh_run["plain_calls"] != 0:
        print("[11] FAIL: the mesh path did not run on the kernel alone", file=sys.stderr)
        return 1

    # ---- 12. times and bounds on the mesh frame
    _, mpack, mkw = scene_setup(pt, "bench_mesh", 512, 512, 8)
    mn = 512 * 512
    mchunks = [lanes(512, 512, st, min(chunk, mn - st)) for st in range(0, mn, chunk)]
    mseg_box, mcol_box = [], []

    def mesh_frame():
        mseg_box.clear()
        mcol_box.clear()
        for px, py in mchunks:
            col, segs = cuda_trace.render_pass_cuda(mpack, 1, px, py, n_passes=8, **mkw)
            mseg_box.append(segs)
            mcol_box.append(col)

    mesh_ms = cuda_time_ms(mesh_frame, 3)
    mesh_segments = int(sum(int(sg) for sg in mseg_box))
    mesh_cols = torch.cat([c.to_rows() for c in mcol_box])
    mcounted = [cuda_trace.count_ops_split(mpack, 1, px, py, n_passes=8, **mkw) for px, py in mchunks]
    mesh_ops, mesh_walk_ops, mesh_walk_cycles, mesh_cycles = (
        sum(c[k] for c in mcounted) for k in ("ops", "walk_ops", "walk_cycles", "cycles"))
    if sum(c["segments"] for c in mcounted) != mesh_segments:
        print("[12] FAIL: the counting build traced other paths than the kernel", file=sys.stderr)
        return 1
    mesh_bound_ms = max(mesh_ops / PEAK_F32_FLOPS, mn * (8 + 12) / PEAK_BYTES) * 1e3
    print(
        f"[12] whole-pass kernel on bench_mesh: {mesh_ms:.3f} ms per 512x512 8-pass window "
        f"({len(mchunks)} launches, {mesh_segments} segments, {mesh_segments / mesh_ms / 1e3:.2f} Mrays/s); "
        f"bound {mesh_bound_ms:.4f} ms ({mesh_ops:.6g} f32 operations, {mesh_ops / mesh_segments:.1f} per "
        f"segment, {mesh_ops / (mesh_ms * 1e-3) / 1e12:.2f} TFLOP/s achieved); the paged walk inside it: "
        f"{mesh_walk_ops / mesh_ops:.2%} of the operations, {mesh_walk_cycles / mesh_cycles:.2%} of the lanes' "
        f"clock cycles (counting build) | card {card}",
        flush=True,
    )

    # the walk alone on the frame's primary rays (pixel centres, no start distance)
    wo, wd = walk_rays(mpack, 512, 512, mn, 0, seed=0)
    far = torch.full((mn,), 1e20, device=DEVICE)
    walk_ms = cuda_time_ms(lambda: cuda_trace.paged_traverse(wo, wd, mpack, 0.001, far), 5)
    occl_ms = cuda_time_ms(lambda: cuda_trace.paged_occluded(wo, wd, mpack, 0.001, far, far < 0), 5)
    from path_trace_golang_tpu_torch.ops import bvh as bvh_ops

    walk_box = []
    walk_plain_ms = cuda_time_ms(
        lambda: walk_box.append(bvh_ops.traverse_triangles_paged(wo, wd, mpack, 0.001, far)), 1)
    # the plain version's results on the whole frame are there now: hold the kernel to them
    walk_k = cuda_trace.paged_traverse(wo, wd, mpack, 0.001, far)
    bad, err = walk_diff(walk_k, walk_box[0])
    walk_err = max(walk_err, err)
    occl_differ = int((cuda_trace.paged_occluded(wo, wd, mpack, 0.001, far, far < 0)
                       != bvh_ops.occluded_triangles_paged(wo, wd, mpack, 0.001, far, far < 0)).sum())
    walk_ops = cuda_trace.paged_count_ops(wo, wd, mpack, 0.001, best_t=far)
    # bytes the walk must move: the page tables once, 8 floats, an excluded
    # id and a skip byte per ray in, 2 ints and 6 floats per ray out
    walk_bytes = mpack.page_tiles.numel() * 4 + mpack.page_boxes.numel() * 4 + mn * (8 * 4 + 4 + 1) + mn * 8 * 4
    walk_by_ops, walk_by_bytes = walk_ops / PEAK_F32_FLOPS * 1e3, walk_bytes / PEAK_BYTES * 1e3
    walk_bound_ms = max(walk_by_ops, walk_by_bytes)
    hits = int(walk_k.hit.sum())
    print(
        f"[12] walk alone on {mn} primary rays of bench_mesh ({mpack.paged.n_pages} pages, {hits} hits): "
        f"closest hit {walk_ms:.3f} ms, any hit {occl_ms:.3f} ms, plain version {walk_plain_ms:.1f} ms; "
        f"{walk_ops:.6g} f32 operations ({walk_by_ops:.4f} ms at peak), {walk_bytes} bytes "
        f"({walk_by_bytes:.4f} ms at peak): bound {walk_bound_ms:.4f} ms; against the plain version on all "
        f"{mn} rays: closest-hit fields that differ: {bad or 'none'}, max |a-b| over t and normal {err:.4g}, "
        f"any-hit rays that differ: {occl_differ} | card {card}",
        flush=True,
    )
    if bad or occl_differ:
        print("[12] FAIL: the paged walk disagrees with its plain version on the frame's primary rays",
              file=sys.stderr)
        return 1
    # perf probe T2's incoherent packet on T2's sphere (80 pages): the walk where its warps diverge most
    import numpy as np
    from path_trace_golang_tpu_torch.tools.perf import paged_probe

    ppack = pt.pack_scene(paged_probe.probe_scene(), 512, 512, device=DEVICE)
    irays = paged_probe.packets("incoherent", device=DEVICE)
    n_inc = irays.shape[1]
    io3, id3 = V3(irays[0], irays[1], irays[2]), V3(irays[3], irays[4], irays[5])
    ifar = torch.full((n_inc,), 1e20, device=DEVICE)
    ik = cuda_trace.paged_traverse(io3, id3, ppack, 0.001, ifar)
    ibad, ierr = walk_diff(ik, bvh_ops.traverse_triangles_paged(io3, id3, ppack, 0.001, ifar))
    walk_err = max(walk_err, ierr)
    it_max = torch.from_numpy(np.random.default_rng(12).uniform(0.5, 6.0, n_inc).astype(np.float32)).to(DEVICE)
    ib = cuda_trace.paged_occluded(io3, id3, ppack, 0.001, it_max, ifar < 0)
    iocc_differ = int((ib != bvh_ops.occluded_triangles_paged(io3, id3, ppack, 0.001, it_max, ifar < 0)).sum())
    print(
        f"[12] walk alone on perf probe T2's {n_inc} incoherent rays ({ppack.paged.n_pages} pages, "
        f"{int(ik.hit.sum())} hits, {int(ib.sum())} blocked): closest-hit fields that differ: {ibad or 'none'}, "
        f"max |a-b| over t and normal {ierr:.4g}, any-hit rays that differ: {iocc_differ}",
        flush=True,
    )
    if ibad or iocc_differ:
        print("[12] FAIL: the paged walk disagrees with its plain version on T2's incoherent rays", file=sys.stderr)
        return 1

    # ---- 13. kernel vs plain version at the mesh path's own arguments
    # (512x512 camera mapping, frame seed 1, the 8-pass reseed schedule, 80 pages)
    held = hold_frame_lanes(cuda_trace, "13", "bench_mesh 512x512 d8", mpack, mkw, mesh_cols, 512,
                            MESH_CHECK_LANES, 8, exact=True)
    if held is None:
        print("[13] FAIL: a lane's result depends on the launch it ran in", file=sys.stderr)
        return 1
    max_abs_err = max(max_abs_err, held[1])
    mesh_check_err = held[1]
    if not held[0]:
        print("[13] FAIL: kernel disagrees with its plain version at the mesh path's arguments", file=sys.stderr)
        return 1

    # ---- 14. kernel B3 against its plain version, bit for bit
    classic_err = trace_err = 0.0
    for name in ("demo_showcase", "demo_cornell", "bench_mesh"):
        for contract, faithful, depth in (("cpu", False, 80), ("gpu", False, 12), ("gpu", True, 12)):
            if faithful and name != "demo_showcase":
                continue  # the other two scenes have no fog to march
            same, err, _s = hold_trace(pt, cuda_trace, "14", name, contract, faithful, depth, B3_CHECK_RAYS,
                                       B3_CHECK_RAYS, seed=31)
            trace_err = max(trace_err, err)
            if not same:
                print(f"[14] FAIL: kernel B3 disagrees with its plain version on {name}", file=sys.stderr)
                return 1
    same, err, _s = hold_trace(pt, cuda_trace, "14", "demo_showcase", "gpu", True, 12, B3_CHECK_RAYS, B3_CHECK_RAYS,
                               seed=33, inactive=0.25)
    trace_err = max(trace_err, err)
    if not same:
        print("[14] FAIL: kernel B3 disagrees with its plain version under an active mask", file=sys.stderr)
        return 1
    # threads that take several rays: more rays than any persistent grid of B3's bounces has threads (2,048 an
    # SM at most), on the paged instance at the mesh path's depth
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_refill = 2048 * sms + 17
    same, err, _s = hold_trace(pt, cuda_trace, "14", "bench_mesh", "gpu", False, 8, n_refill - n_refill // 2,
                               n_refill // 2, seed=35)
    trace_err = max(trace_err, err)
    if not same:
        print("[14] FAIL: kernel B3 disagrees with its plain version where its threads take several rays",
              file=sys.stderr)
        return 1

    # ---- 15. the classic instance against its plain version at 256x144, depth 12, bit for bit (faithful fog:
    # the fifth process)
    for name, contract, faithful in (("demo_showcase", "cpu", False), ("demo_cornell", "cpu", False)):
        good, err, _secs = hold_pass(pt, cuda_trace, "15", name, 256, 144, 12, passes=(1,), contract=contract,
                                     faithful=faithful)
        classic_err = max(classic_err, err)
        if not good:
            print(f"[15] FAIL: the classic instance disagrees with its plain version on {name}", file=sys.stderr)
            return 1
    # the Renderer's launch shape on a frame of 4 chunks, the last padded: the cpu contract's window of 3
    # passes in one launch (faithful fog, two launches a sample over all chunks: the second process)
    good, err = hold_classic_frame(pt, cuda_trace, "15", "demo_showcase", 256, 144, 12, SMALL_CHUNK, 3, "cpu", False)
    classic_err = max(classic_err, err)
    if not good:
        print("[15] FAIL: the classic instance disagrees with its plain version on the chunked frame",
              file=sys.stderr)
        return 1

    # ---- 16. the cpu-contract path; 17. the faithful-fog path
    classic_runs = {}
    window = max(1, int(os.environ.get("PATHTRACER_PASS_WINDOW", "8")))
    for tag, contract, faithful, passes, depth in (("16", "cpu", False, 16, 80), ("17", "gpu", True, 1, 12)):
        run = drive_renderer(pt, cuda_trace, tag, "demo_showcase", 1920, 1080, passes, depth, 3, card, contract,
                             faithful)
        cimg, counts = run["img"], run["counts"]
        if cimg.shape != (1080, 1920, 3) or run["stats"].nonfinite != 0 or not 5.0 < float(cimg.mean()) < 250.0:
            print(f"[{tag}] FAIL: wrong shape, non-finite accumulator entries or a blank image", file=sys.stderr)
            return 1
        if counts["LAUNCHES"] <= 0 or counts["CLASSIC_LAUNCHES"] != counts["LAUNCHES"] or run["plain_calls"] != 0:
            print(f"[{tag}] FAIL: the path did not run on the classic instance alone", file=sys.stderr)
            return 1
        # the launch shape: one launch a window of passes (cpu contract); one of the march kernel and one of
        # the sample kernel a sample over all chunks (faithful fog)
        want = -(-passes // window) if contract == "cpu" else passes * 16
        want_march = 0 if contract == "cpu" else passes * 16
        print(f"[{tag}] launches a render: the classic instance {counts['CLASSIC_LAUNCHES'] / 4:g} (want {want}), "
              f"its march kernel {counts['MARCH_LAUNCHES'] / 4:g} (want {want_march})", flush=True)
        if counts["CLASSIC_LAUNCHES"] != 4 * want or counts["MARCH_LAUNCHES"] != 4 * want_march:
            print(f"[{tag}] FAIL: the path did not take the classic instance's launch shape", file=sys.stderr)
            return 1
        classic_runs[contract] = run

    # ---- 18. times: the classic instance on those frames as the Renderer launches it (all chunks of the
    # frame: the cpu contract a window of 8 passes in one launch, faithful fog one pass of 16 launches);
    # B3 through trace() on primary rays
    n = 1920 * 1080
    fpx, fpy = lanes(1920, 1080, 0, n_pad)
    cpu_setup = scene_setup(pt, "demo_showcase", 1920, 1080, 80, "cpu")[1:]
    fog_setup = scene_setup(pt, "demo_showcase", 1920, 1080, 12, "gpu", True)[1:]
    setups = {"cpu": cpu_setup, "gpu": fog_setup}
    frame_passes = {"cpu": 8, "gpu": 1}
    classic_accum = {}

    def classic_frame(label, frame_seed, n_passes):
        cpack, ckw = setups[label]
        acc = torch.zeros((n_pad, 3), dtype=torch.float32, device=DEVICE)
        segs = cuda_trace.classic_render_cuda(acc, cpack, frame_seed, fpx, fpy, chunk=chunk, n_passes=n_passes,
                                              **ckw)
        classic_accum[(label, frame_seed, n_passes)] = acc
        return segs

    classic_ms, classic_device_ms, classic_bound, classic_split_of = {}, {}, {}, {}
    kernel_of = {"cpu": "classic_window_kernel", "gpu": "classic_sample_kernel", "march": "classic_march_kernel"}
    for label in setups:
        box, np_ = [], frame_passes[label]
        classic_ms[label] = cuda_time_ms(lambda: box.append(classic_frame(label, 1, np_)), 3)
        # the kernels' own device time beside the events' span, which also holds the gaps in which
        # the device waits for the host between launches
        names = (kernel_of[label],) + (("classic_march_kernel",) if label == "gpu" else ())
        timed = device_ms(lambda: classic_frame(label, 1, np_), names)
        classic_device_ms[label] = timed[kernel_of[label]]
        dev = sum(timed[k] for k in names) if all(timed[k] is not None for k in names) else None
        # the f32 operations and hash rounds of the call, tallied by the counting build, and the split;
        # bytes, each input read once and each output written once: px, py and the accumulator read, the
        # accumulator written (8 + 12 + 12 a lane); under faithful fog the sample kernel also reads, and the
        # march kernel writes, a sample's ray, march and state (40 bytes a lane and sample)
        cpack, ckw = setups[label]
        counted = cuda_trace.classic_count_split(classic_accum[(label, 1, np_)], cpack, 1, fpx, fpy, chunk=chunk,
                                                 n_passes=np_, **ckw)
        if counted["segments"] != int(box[-1]):
            print("[18] FAIL: the counting build traced other paths than the classic instance", file=sys.stderr)
            return 1
        sp = classic_split_of[label] = cuda_trace.classic_split([counted])
        march = counted["march"]
        parts = {label: (counted["ops"] - (march["ops"] if march else 0),
                         counted["rng_rounds"] - (march["rng_rounds"] if march else 0),
                         n_pad * (32 + (16 * 40 if march else 0)))}
        if march:
            parts["march"] = (march["ops"], march["rng_rounds"], n_pad * (8 + 16 * 40))
            classic_device_ms["march"] = timed["classic_march_kernel"]
        for part, (ops_k, rounds_k, bytes_k) in parts.items():
            by_ops, by_bytes = ops_k / PEAK_F32_FLOPS * 1e3, bytes_k / PEAK_BYTES * 1e3
            slots_ms = (ops_k + cuda_trace.HASH_ROUND_SLOTS * rounds_k) / cuda_trace.UNFUSED_SLOTS * 1e3
            classic_bound[part] = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes", ops_k,
                                   slots_ms)
        timed_line = ", ".join(f"{k} {'not measured' if v is None else f'{v:.3f} ms'}" for k, v in timed.items())
        print(
            f"[18] classic instance, demo_showcase 1920x1080, {label} contract"
            f"{' faithful fog, one pass of 16 samples' if label == 'gpu' else ' depth 80, a window of 8 passes'} as "
            f"the Renderer launches it ({counted['launches']} launches, {n_pad} lanes): {classic_ms[label]:.3f} ms "
            f"({int(box[-1])} segments, {int(box[-1]) / classic_ms[label] / 1e3:.2f} Mrays/s); bound "
            f"{sum(classic_bound[k][0] for k in parts):.4f} ms ({counted['ops']:.6g} f32 operations; "
            f"{sp['bound_slots_ms']:.4f} ms with its hash rounds as FFMA slots), of it "
            + ", ".join(f"{kernel_of[k]} {classic_bound[k][0]:.4f} ms ({classic_bound[k][3]:.4f} as slots)"
                        for k in parts)
            + f"; kernels' device time (torch.profiler) {timed_line}"
            f"{'' if dev is None else f', device idle {1 - dev / classic_ms[label]:.1%}'} | card {card}",
            flush=True,
        )
        print(f"[18] its split: {cuda_trace.classic_split_line(sp)} | card {card}", flush=True)
        if march:
            classic_split_of["march"] = cuda_trace.march_split([march])
            print(f"[18] classic_march_kernel's split: {cuda_trace.march_split_line(classic_split_of['march'])} | "
                  f"card {card}", flush=True)
    classic_frame("cpu", 1, 2)  # the cpu frame's 2-pass window, for phase 19 beside the timed 8-pass one

    from path_trace_golang_tpu_torch import integrator

    trace_ms, trace_plain_ms, trace_bound, trace_launches, trace_part = {}, {}, {}, 0, {}
    for label, (tpack, tkw) in setups.items():
        cfg = tkw["tcfg"]
        ro, rd, rst = primary_rays(tpack, tkw, 1, 0, chunk)
        for c in COUNTERS:
            setattr(cuda_trace, c, 0)
        box = []
        trace_ms[label] = cuda_time_ms(lambda: box.append(integrator.trace(ro, rd, rst, tpack, cfg)), 3)
        if cuda_trace.TRACE_LAUNCHES <= 0 or sum(getattr(cuda_trace, c) for c in PLAIN_COUNTERS) != 0:
            print("[18] FAIL: trace() did not run on kernel B3 alone", file=sys.stderr)
            return 1
        trace_launches += cuda_trace.TRACE_LAUNCHES
        o3 = V3(ro[:, 0], ro[:, 1], ro[:, 2])
        d3 = V3(rd[:, 0], rd[:, 1], rd[:, 2])
        pbox = []
        trace_plain_ms[label] = cuda_time_ms(
            lambda: pbox.append(cuda_trace.trace_grid_plain(o3, d3, rst, tpack, cfg)), 1)
        if label == "gpu":  # the march kernel's plain version: the trace's fog march on the same rays
            march_plain_ms = cuda_time_ms(lambda: integrator.fog_prepass_grid(o3, d3, rst, tpack), 1)
        (krad, kst, kseg), (prad, pst, pseg) = box[-1], pbox[0]
        same = torch.equal(krad.view(torch.int32), prad.to_rows().view(torch.int32)) and torch.equal(kst, pst) \
            and int(kseg) == int(pseg)
        counted = cuda_trace.trace_count_ops(o3, d3, rst, tpack, cfg)
        if counted["segments"] != int(kseg) or not same:
            print("[18] FAIL: B3 disagrees with its plain version on the frame's primary rays, or the counting "
                  "build traced other paths", file=sys.stderr)
            return 1
        # bytes: 6 floats and an int64 state in, 3 floats and an int64 state out, per ray
        by_ops, by_bytes = counted["ops"] / PEAK_F32_FLOPS * 1e3, chunk * 52 / PEAK_BYTES * 1e3
        trace_bound[label] = (max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes", counted["ops"])
        print(
            f"[18] B3 through trace(), {chunk} primary rays of the first chunk, {label} contract, depth "
            f"{cfg.max_depth}{', in-trace fog' if cfg.fog_in_trace and cfg.enable_fog_march else ''}: "
            f"{trace_ms[label]:.3f} ms, plain version {trace_plain_ms[label]:.1f} ms, bit-identical on every ray; "
            f"{int(kseg)} segments, {counted['ops']:.6g} f32 operations ({by_ops:.4f} ms at peak), "
            f"{chunk * 52} bytes ({by_bytes:.4f} ms at peak): bound {trace_bound[label][0]:.4f} ms; "
            f"launches {cuda_trace.TRACE_LAUNCHES} | card {card}",
            flush=True,
        )
        part = trace_part[label] = trace_parts(cuda_trace, integrator, tpack, cfg, ro, rd, rst)
        print(f"[18] B3 taken apart, {label} contract: pt_trace_grid alone {part['trace_kernel_ms']:.4f} ms, the "
              f"longest path ({part['trace_longest_path']} bounces) traced alone {part['trace_longest_ms']:.4f} ms "
              f"(the call's latency floor), launches besides B3's own {part['trace_wrapper_launches']} | card {card}",
              flush=True)

    # ---- 19. the classic instance against its plain version at the paths' own arguments, bit for bit: on
    # strided lanes the cpu frame's 8-pass window that phase 18 timed (the main path's launch, frame seeds
    # 1-8) and a 2-pass window (the faithful-fog frame's first chunk in full: the fifth process; its padded last
    # chunk: the second)
    cpack, ckw = cpu_setup
    for n_passes in (8, 2):
        held = hold_frame_lanes(cuda_trace, "19", "demo_showcase 1920x1080 d80 cpu contract", cpack, ckw,
                                classic_accum[("cpu", 1, n_passes)][:n], 1920, CLASSIC_CHECK_LANES, n_passes,
                                exact=True, classic=True)
        if held is None or not held[0]:
            print("[19] FAIL: the classic instance disagrees with its plain version on the cpu frame",
                  file=sys.stderr)
            return 1
        classic_err = max(classic_err, held[1])
        if n_passes == 8:
            cpu_plain_ms = held[2] * 1e3
    fog_chunk_plain_ms = side_holds_summary["fog_chunk_plain_s"] * 1e3
    classic_err = max(classic_err, side_holds_summary["max_abs_err"])
    max_abs_err = max(max_abs_err, classic_err)

    # ---- 20-23. the perf probes T1-T4
    probe_rows = probe_phases(card)
    if probe_rows is None:
        return 1

    # ---- 24-27. the Mosaic repros T5-T8
    repro_rows = repro_phases(card)
    if repro_rows is None:
        return 1

    # ---- 28. the fuzzed scenes, B1 and the classic instance against their plain versions
    good, fuzz_err = fuzz_phase(pt, cuda_trace, card)
    max_abs_err, classic_err = max(max_abs_err, fuzz_err), max(classic_err, fuzz_err)
    if not good:
        print("[28] FAIL: the whole-pass kernel disagrees with its plain version on a fuzzed scene", file=sys.stderr)
        return 1

    # ---- 29. the fog kernel at the main path's shape against its plain version, bit for bit
    terms = cuda_trace.fog_pass(pack, 1, wpx, wpy, n_passes=8, **kw)
    stride = n // FOG_CHECK_LANES
    sub = torch.arange(FOG_CHECK_LANES, device=DEVICE, dtype=torch.int64) * stride + stride // 2
    fpx, fpy = wpx[sub], wpy[sub]
    fog_box = []
    fog_plain_ms = cuda_time_ms(lambda: fog_box.append(pt.render.fog_pass_terms(
        pack, 1, fpx, fpy, width=1920, height=1080, samples=16, has_aperture=kw["has_aperture"], n_passes=8)), 1)
    want = torch.stack([torch.stack([t.x, t.y, t.z]) for t in fog_box[0]])
    got = terms[:, :, sub]
    fog_err = torch.nan_to_num((got - want).abs(), nan=float("inf")).max().item()
    fog_same = torch.equal(got.contiguous().view(torch.int32), want.view(torch.int32))
    print(
        f"[29] fog kernel, demo_showcase 1920x1080 one 8-pass window ({n_pad} lanes in one launch, as the Renderer "
        f"launches it) against its plain version (render.fog_pass_terms) on {FOG_CHECK_LANES} lanes at stride "
        f"{stride}: bit-identical {fog_same}, max |a-b| {fog_err:.4g}, terms' mean {float(want.double().mean()):.6g}; "
        f"plain version {fog_plain_ms:.1f} ms | card {card}",
        flush=True,
    )
    if not fog_same:
        print("[29] FAIL: the fog kernel disagrees with its plain version", file=sys.stderr)
        return 1

    # ---- 36 (its timed part). PATHTRACER_NO_REGEN at full width beside the regeneration path (before phases
    # 30-33, which start processes and worlds of their own); 37: the shipped build's machine code, which a render
    # that sets no knob runs
    noregen = noregen_timing(pt, cuda_trace, card)
    if noregen is None or walk_skip_timing(pt, cuda_trace, card) is None:
        return 1
    digests = sass_digests(cuda_trace)
    for src, (n_fn, dig) in ((k, v) for k, v in digests.items() if k != "functions"):
        print(f"[37] the shipped build of {src}: {n_fn} functions, SASS digest {dig} | card {card}", flush=True)

    # ---- 30-32. the user's entry points on the card: the CLI, checkpoint resume, the session and the viewer
    t_front = time.perf_counter()
    front_walls = front_end_phases(pt, cuda_trace, card)
    if front_walls is None:
        return 1
    print(f"[30-32] in {time.perf_counter() - t_front:.1f} s ({json.dumps(front_walls)}) | card {card}", flush=True)

    # ---- 33. the mesh renderer: a world of 1 over NCCL, then 4 ranks on this card over gloo
    mesh_walls = mesh_phase(pt, cuda_trace, card, MESH_SHAPES)
    if mesh_walls is None:
        return 1
    print(f"[33] in {mesh_walls['phase_s']:.1f} s | card {card}", flush=True)

    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "render_pass",
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/render_pass.cu",
        "replaces": "path_trace_golang_tpu/ops/pallas_trace.py:404",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": b1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations",
        "bound_slots_ms": bound_slots_ms,
        "bound_slots_are": "B1's f32 operations and hash rounds (16 FFMA slots a round) as FFMA slots at the "
                           "32.79 Tslots/s that T1 measured for code built with --fmad=false",
        "library_ms": None,
        "shape": f"demo_showcase 1920x1080 d12, one 8-pass window, {n_pad} lanes in one launch, on the "
                 f"window's fog terms",
        "window_ms": ms,
        "window_is": "the fog kernel and B1 as the Renderer launches them for the window",
        "split": split,
        "plain_shape": "demo_showcase 256x144 d12, 1 pass (the whole pass body, fog included)",
        "max_abs_err_over": f"256x144 d12 n_passes 1 and 2 (showcase, cornell); 1920x1080 d12 n_passes 8, "
                            f"{MAIN_CHECK_LANES} strided lanes (showcase); 192x192 d8 n_passes 1 and 2 "
                            f"(demo_mesh, bench_mesh); 192x108 d6 n_passes 1 and 2 (12 lights); 512x512 d8 "
                            f"n_passes 8, {MESH_CHECK_LANES} strided lanes (bench_mesh); the four fuzzed scenes "
                            f"of tests/test_fuzz.py at {FUZZ_W}x{FUZZ_H} d{FUZZ_DEPTH}, gpu contract",
        "kernel_ms_at_plain_shape": small_k,
        "launches_mesh_path": mesh_launches,
        "mesh_ms": mesh_ms,
        "mesh_bound_ms": mesh_bound_ms,
        "mesh_shape": "bench_mesh 512x512 d8, one 8-pass window",
        "mesh_max_abs_err": mesh_check_err,
        "mesh_walk_share_of_operations": mesh_walk_ops / mesh_ops,
        "mesh_walk_share_of_lane_cycles": mesh_walk_cycles / mesh_cycles,
        "drop_flag": {"flags": cuda_trace.FLAG_DROP, "held_bit_for_bit_and_moved": {
            k: v for k, v in side_summary["drop"].items() if not k.startswith("B3")}},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/classic.cu",
        "replaces": "path_trace_golang_tpu/ops/pallas_trace.py:404",
        "replaces_part": what,
        "launches": classic_runs[run]["counts"][counter],
        "launches_are": f"launches of {kernel_of[label]} on the {path} path (4 renders)",
        "max_abs_err": classic_err,
        "max_abs_err_over": "the classic instance's comparisons of phases 3, 15, 19 and 28, every one bit for bit",
        "ms": classic_device_ms[label] if classic_device_ms[label] is not None else classic_ms[run],
        "ms_is": f"{kernel_of[label]}'s device time (torch.profiler) on the shape below"
                 if classic_device_ms[label] is not None else "CUDA events around the shape below",
        "events_ms": classic_ms[run],
        "plain_ms": plain,
        "plain_shape": plain_shape,
        "bound_ms": classic_bound[label][0],
        "bound_by": classic_bound[label][1],
        "bound_slots_ms": classic_bound[label][3],
        "ops": classic_bound[label][2],
        "library_ms": None,
        "shape": shape,
        "ptxas": ptxas_of(cuda_trace, "classic", kernel_of[label]),
        "split": classic_split_of[label],
    } for name, label, run, counter, path, what, plain, plain_shape, shape in (
        ("classic_window", "cpu", "cpu", "CLASSIC_LAUNCHES", "cpu-contract (1080p d80, 16 passes)",
         "the classic per-sample loop of render.pass_body_grid (render.py:296-322), the cpu contract", cpu_plain_ms,
         f"{CLASSIC_CHECK_LANES} strided lanes of the 1080p d80 frame, the 8-pass window",
         f"demo_showcase 1920x1080 d80, cpu contract, a window of 8 passes over {n_pad} lanes in one launch"),
        ("classic_sample", "gpu", "gpu", "CLASSIC_LAUNCHES", "faithful-fog (1080p d12, 1 pass)",
         "the classic per-sample loop of render.pass_body_grid (render.py:296-322) under faithful fog: the bounces",
         fog_chunk_plain_ms,
         f"the whole pass body on the first chunk ({chunk} lanes) of the 1080p d12 faithful-fog frame",
         f"demo_showcase 1920x1080 d12, faithful fog, one pass: 16 samples over {n_pad} lanes, 16 launches (after "
         f"16 of the march kernel)"),
        ("classic_march", "march", "gpu", "MARCH_LAUNCHES", "faithful-fog (1080p d12, 1 pass)",
         "the classic per-sample loop under faithful fog: each sample's state advance, camera ray and the trace's "
         "fog march (integrator._trace_gpu's fog_prepass_grid)", march_plain_ms,
         f"integrator.fog_prepass_grid on the first chunk's {chunk} primary rays",
         f"demo_showcase 1920x1080 d12, faithful fog, one pass: 16 samples over {n_pad} lanes, 16 launches"))
    ] + [{
        "name": "classic_samples_gpu",
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/classic.cu",
        "replaces": "path_trace_golang_tpu/ops/pallas_trace.py:404",
        "replaces_part": "the classic per-sample loop of render.pass_body_grid (render.py:296-322) under the gpu "
                         "contract with PATHTRACER_NO_REGEN: classic_march_kernel (the state advance, the camera ray "
                         "and, at sample 0, the fog once a pass) and classic_sample_kernel (the bounces)",
        "launches": noregen["launches"] + noregen["march_launches"],
        "launches_are": f"launches of the two kernels on the NO_REGEN path ({NOREGEN_FRAME[0]} "
                        f"{NOREGEN_FRAME[1]}x{NOREGEN_FRAME[2]} d{NOREGEN_FRAME[4]}, 1 pass, 4 renders)",
        "max_abs_err": 0.0,
        "max_abs_err_over": "phase 36's holds, bit for bit: " + ", ".join(
            f"{n} {w}x{h} d{d}" for n, w, h, d in NOREGEN_HOLDS) + ", the padded last chunk of the 1080p frame",
        "ms": noregen["events_ms"],
        "ms_is": "CUDA events around the frame's one pass (32 launches)",
        "device_ms": noregen["device_ms"],
        "device_ms_is": "the two kernels' device time by torch.profiler, which can come back short after the "
                        "script's earlier profiles: the events' time is the row's",
        "plain_ms": side_holds_summary["noregen_chunk_plain_s"] * 1e3,
        "plain_shape": f"the whole pass body on the padded last chunk ({chunk} lanes) of the 1080p d12 frame, one "
                       f"pass (phase 36's hold, in the fifth process beside phases 7-10)",
        "bound_ms": noregen["bound_ms"],
        "bound_by": "operations",
        "bound_slots_ms": noregen["bound_slots_ms"],
        "ops": noregen["ops"],
        "library_ms": None,
        "shape": f"{NOREGEN_FRAME[0]} 1920x1080 d12, one pass: 16 samples over {n_pad} lanes, 32 launches",
        "mrays_classic": noregen["mrays_classic"],
        "mrays_regen_same_passes": noregen["mrays_regen"],
        "split": noregen["split"],
        "profiling_build": {"knobs_held_bit_for_bit": knob_summary["knobs"],
                            "shipped_sass": {k: v for k, v in digests.items() if k != "functions"}},
        "page_statistics": knob_summary["page_tools"],
    }] + [{
        "name": "fog_pass",
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/render_pass.cu",
        "replaces": "path_trace_golang_tpu/ops/pallas_trace.py:404",
        "replaces_part": "the fog-once march of render.pass_body_grid (render.py:232-266) inside render_pass_pallas",
        "launches": fog_launches,
        "max_abs_err": fog_err,
        "max_abs_err_over": f"the 1080p window's terms on {FOG_CHECK_LANES} strided lanes x 8 passes (phase 29), "
                            f"bit for bit",
        "ms": fog_ms,
        "plain_ms": fog_plain_ms,
        "plain_shape": f"{FOG_CHECK_LANES} strided lanes of the 1080p window, 8 passes",
        "bound_ms": fog_bound_ms,
        "bound_by": "operations" if fog_ops / PEAK_F32_FLOPS >= n_pad * (8 + 8 * 12) / PEAK_BYTES else "bytes",
        "bound_slots_ms": fog_bound_slots_ms,
        "ops": fog_ops,
        "library_ms": None,
        "shape": f"demo_showcase 1920x1080, one 8-pass window: {n_pad} lanes x 8 passes, one thread each",
        "ptxas": ptxas_of(cuda_trace, "render_pass", "fog_pass_kernel"),
        "march_split": fog_split,
    }, {
        "name": "trace_grid",
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/classic.cu",
        "replaces": "path_trace_golang_tpu/ops/pallas_trace.py:240",
        "kernels": ["trace_march_kernel (the in-trace fog march, where the call has one)",
                    "trace_bounce_kernel (the bounces; paged: persistent blocks)",
                    "advance_kernel (the states advanced by the call's other trips)"],
        "launches": trace_launches,
        "launches_are": "calls of trace() that launched pt_trace_grid (and its state advance) in phase 18, "
                        "timing included",
        "max_abs_err": trace_err,
        "ms": trace_ms["cpu"],
        "plain_ms": trace_plain_ms["cpu"],
        "bound_ms": trace_bound["cpu"][0],
        "bound_by": trace_bound["cpu"][1],
        "library_ms": None,
        "shape": f"{chunk} primary rays of demo_showcase 1920x1080 (the first chunk, frame seed 1), cpu "
                 f"contract, depth 80",
        "ops": trace_bound["cpu"][2],
        "fog_ms": trace_ms["gpu"],
        "fog_plain_ms": trace_plain_ms["gpu"],
        "fog_bound_ms": trace_bound["gpu"][0],
        "fog_shape": "the same rays, gpu contract with the in-trace fog march, depth 12",
        "kernel_alone_ms": {k: v["trace_kernel_ms"] for k, v in trace_part.items()},
        "latency_floor_ms": {k: v["trace_longest_ms"] for k, v in trace_part.items()},
        "latency_floor_is": "the longest path's ray traced alone (pt_trace_grid on one ray): no call ends sooner",
        "ptxas": trace_part["cpu"]["trace_ptxas"],
        "drop_flag": {"flags": cuda_trace.FLAG_DROP, "held_bit_for_bit_and_moved": {
            k: v for k, v in side_summary["drop"].items() if k.startswith("B3")}},
        "max_abs_err_over": "2,048 and 16,384 camera and random rays on demo_showcase, demo_cornell and "
                            "bench_mesh, cpu contract d80, gpu contract d12, in-trace fog d12, a batch with "
                            "an active mask; 2,048 rays an SM and 17 more on bench_mesh d8, several rays a "
                            "thread of the persistent bounces; the timed primary rays; radiance, state and "
                            "segments bit for bit",
    }, {
        "name": "paged_walk",
        "route": "cuda",
        "source": "path_trace_golang_tpu_torch/csrc/paged_walk.cuh",
        "replaces": "path_trace_golang_tpu/ops/bvh.py:1642",
        "launches": paged_launches,
        "launches_are": "launches of render_pass that carried pages on the mesh path (4 renders of bench_mesh "
                        "512x512 d8 x8): the walk runs inside them",
        "max_abs_err": walk_err,
        "ms": walk_ms,
        "plain_ms": walk_plain_ms,
        "bound_ms": walk_bound_ms,
        "bound_by": "operations" if walk_by_ops >= walk_by_bytes else "bytes",
        "library_ms": None,
        "any_hit_ms": occl_ms,
        "shape": f"closest hit, {mn} primary rays of bench_mesh 512x512, {mpack.paged.n_pages} pages of 128 "
                 f"triangles, through pt_paged_walk",
        "max_abs_err_over": "camera and random rays on bench_mesh and demo_mesh, 2,048 and 16,384 rays, "
                            "closest hit (open; start distance, far limit, excluded object, skipped rays) "
                            "and any hit; the 262,144 primary rays of the timed frame, closest hit and any "
                            "hit; every output bit for bit",
    }] + probe_rows + repro_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
