"""The port's mesh renderer (``path_trace_golang_tpu_torch/parallel``) on
the CPU, over gloo, in one spawned world of 8 ranks, against the port's
single Renderer and the JAX MeshRenderer (on the 8 virtual CPU devices of
tests/conftest.py).

Every case of tests/test_parallel.py is here, one for one, at its sizes.
The world runs all the cases once (tests/torch_mesh_ranks.py, which
imports no JAX), while this process renders the JAX side.  Tolerances:

(a) a px-only mesh against the single Renderer: bit for bit (accumulator,
    image, segments) wherever both cut the same lanes into the same chunks
    and windows: the regeneration loop (gpu contract) whatever the chunks,
    since a lane's result does not depend on its launch; the classic loop
    (cpu contract, faithful fog) where the Renderer's chunk is the mesh's
    block (a chunk's longest path advances its lanes' states, PHYSICS.md
    D7), a 1x1 mesh and a Renderer with ``chunk = w*h`` included;
(b) an spp mesh against the single Renderer: the same (pixel, pass)
    samples added in another order, so the accumulator agrees within
    ``|a - b| <= 1e-5 |b|`` per entry (4.3e-7 measured on the gpu case),
    segments are equal and at least 99% of the u8 pixels are (100%
    measured);
(c) against the JAX MeshRenderer at the same mesh shape: the images within
    the bands of tests/test_parallel.py:23-31, passes, samples per pixel,
    resumed_from, the progress calls and, at these tiny frames, the
    segments equal (on the fog scene too, though its noise's ``hash31``
    rounds apart under XLA's fused multiply-adds, ROADMAP.md Queue C, so
    its images are held to the bands, not bit for bit);
(d) the same mesh and seed rendered twice: bit for bit.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import path_trace_golang_tpu as jpt
from path_trace_golang_tpu.parallel import MeshRenderer as JMeshRenderer
from path_trace_golang_tpu.parallel import make_mesh as jmake_mesh
from path_trace_golang_tpu.scene import io as JS

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch.parallel import MeshRenderer, make_mesh
from path_trace_golang_tpu_torch.parallel.launch import run_world
from path_trace_golang_tpu_torch.scene import io as TS

import torch_mesh_ranks as ranks
from helpers import full_feature_scene, lambert_floor_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
FULL, FLOOR = JS.dumps(full_feature_scene()), JS.dumps(lambert_floor_scene())
GPU7 = dict(contract="gpu", seed=7, normalize_pass=True)
CFG = (48, 32, 2, 4)
SMALL = (24, 16, 2, 3)  # the 1x1 meshes' frame
SMOOTH = {"PATHTRACER_GPU_SMOOTH": "1", "PATHTRACER_GPU_SMOOTH_RADIUS": "2", "PATHTRACER_GPU_SMOOTH_STRENGTH": "1.0"}
FOG7 = dict(contract="gpu", seed=7, faithful_fog=True)


def _cases(tmp):
    ck = lambda name: dict(contract="cpu", seed=5, checkpoint_path=str(tmp / name))  # noqa: E731
    return {
        "shapes": {"kind": "shapes"},
        # tests/test_parallel.py's cases
        "px_gpu": dict(mesh=(8, 1), scene=FULL, cfg=CFG, kw=GPU7, runs=[{}]),
        "spp_gpu": dict(mesh=(4, 2), scene=FULL, cfg=CFG, kw=GPU7, runs=[{}, {}]),
        "progress": dict(mesh=(2, 2), scene=FLOOR, cfg=(40, 24, 4, 3), kw=dict(contract="cpu", seed=1),
                         runs=[{"progress": True}]),
        "cancel": dict(mesh=(2, 1), scene=FLOOR, cfg=(40, 24, 8, 3), kw=dict(contract="cpu", seed=3),
                       runs=[{"cancel_after": 2}]),
        "resume": dict(mesh=(2, 1), scene=FLOOR, cfg=(40, 24, 4, 3), kw=ck("ck_port.npz"),
                       runs=[{}, {"cancel_after": 1}, {}]),
        "chunked": dict(mesh=(4, 2), scene=FLOOR, cfg=(48, 32, 2, 3), kw=dict(contract="cpu", seed=9),
                        runs=[{"kw": {"chunk": 0}}, {"kw": {"chunk": 256}}, {}]),
        "smooth": dict(mesh=(4, 2), scene=FULL, cfg=(48, 32, 1, 3), kw=dict(contract="gpu", seed=4),
                       runs=[{}, {"env": SMOOTH}]),
        # a checkpoint of the JAX MeshRenderer, resumed
        "resume_jax": dict(mesh=(2, 1), scene=FLOOR, cfg=(40, 24, 4, 3), kw=ck("ck_jax.npz"), runs=[{}]),
        # (a) under the classic loop, and 1x1 meshes under all three paths
        "px_cpu": dict(mesh=(4, 1), scene=FULL, cfg=CFG, kw=dict(contract="cpu", seed=7), runs=[{}]),
        "px_fog": dict(mesh=(2, 1), scene=FULL, cfg=(24, 16, 1, 3), kw=FOG7, runs=[{}]),
        "one_gpu": dict(mesh=(1, 1), scene=FULL, cfg=SMALL, kw=GPU7, runs=[{}]),
        "one_cpu": dict(mesh=(1, 1), scene=FULL, cfg=SMALL, kw=dict(contract="cpu", seed=7), runs=[{}]),
        "one_fog": dict(mesh=(1, 1), scene=FULL, cfg=(24, 16, 1, 3), kw=FOG7, runs=[{}]),
        # (b) under the classic loop
        "spp_cpu": dict(mesh=(2, 2), scene=FULL, cfg=(48, 32, 4, 4), kw=dict(contract="cpu", seed=7), runs=[{}]),
    }


def _jax_render(mesh_shape, scene, cfg, progress=False, cancel_after=None, **kw):
    calls, ticks = [], []
    r = JMeshRenderer(jmake_mesh(*mesh_shape), **kw)
    img = r.render(JS.loads(scene), jpt.RenderConfig(*cfg),
                   progress=(lambda p, im: calls.append(p)) if progress else None,
                   cancel=(lambda: ticks.append(1) is None and len(ticks) >= cancel_after) if cancel_after else None)
    return {"img": img, "stats": r.stats, "progress": calls}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' results by case (a list over ranks, None outside the
    mesh), and the JAX MeshRenderer's renders by case."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases = _cases(tmp)
    jax = {}
    # the JAX MeshRenderer's interrupted render, whose checkpoint the world resumes
    rc = cases["resume_jax"]
    jax["resume_full"] = _jax_render(rc["mesh"], rc["scene"], rc["cfg"], **rc["kw"])
    jax["resume_cut"] = _jax_render(rc["mesh"], rc["scene"], rc["cfg"], cancel_after=1, **rc["kw"])
    with np.load(rc["kw"]["checkpoint_path"]) as z:
        jax["digest"] = bytes(z["digest"]).decode()
    names = list(cases)
    for c in cases.values():
        c.setdefault("kind", "render")
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_world, ranks.run_cases, WORLD, ([cases[k] for k in names],), backend="gloo",
                          timeout=600)
        for name in ("px_gpu", "spp_gpu"):
            c = cases[name]
            jax[name] = _jax_render(c["mesh"], c["scene"], c["cfg"], **c["kw"])
        c = cases["progress"]
        jax["progress"] = _jax_render(c["mesh"], c["scene"], c["cfg"], progress=True, **c["kw"])
        c = cases["cancel"]
        jax["cancel"] = _jax_render(c["mesh"], c["scene"], c["cfg"], cancel_after=2, **c["kw"])
        results = fut.result()
    by_case = {name: [r[i] for r in results] for i, name in enumerate(names)}
    return {"cases": cases, "ranks": by_case, "jax": jax}


def _lead(world, name):
    """Rank (0, 0)'s runs of a case (rank 0 of the world)."""
    return world["ranks"][name][0]


def _single(case, **kw):
    """The port's single Renderer on a case: image, final accumulator, stats."""
    with ranks.final_accum(TR) as box:
        r = tpt.Renderer(device="cpu", **kw)
        img = r.render(TS.loads(case["scene"]), tpt.RenderConfig(*case["cfg"]))
    return img, box["accum"], r.stats


def _assert_statistically_equal(a, b):
    """tests/test_parallel.py:23-31's bands."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    assert abs(a.mean() - b.mean()) < 1.5
    assert np.abs(a - b).mean() < 3.0
    assert (np.abs(a - b) > 40).mean() < 0.02


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def test_make_mesh_shapes(world):
    for rank, got in enumerate(world["ranks"]["shapes"]):
        assert got["shape"] == {"px": 4, "spp": 2}
        assert got["coord"] == (rank // 2, rank % 2)  # JAX's reshape(n_px, n_spp)
        assert got["default"] == (8, 1)  # all ranks on "px"
        assert "16 ranks, have 8" in got[(8, 2, "cpu", None)]  # 16 devices needed, only 8
        assert "runs 'gloo', not 'nccl'" in got[(4, 2, "cpu", "nccl")]  # the caller's backend, no switch


@pytest.mark.parametrize("name,chunk", [("px_gpu", None), ("px_cpu", 384), ("px_fog", 192), ("one_gpu", 384),
                                        ("one_cpu", 384), ("one_fog", 384)])
def test_px_mesh_is_the_single_renderer_bit_for_bit(world, name, chunk):
    """(a): the Renderer's chunk (where the classic loop needs it) is the
    mesh's block, so both cut the same chunks."""
    case = world["cases"][name]
    img, accum, stats = _single(case, **case["kw"], **({"chunk": chunk} if chunk else {}))
    got = _lead(world, name)[0]
    assert np.array_equal(_bits(got["accum"]), _bits(accum))
    assert np.array_equal(got["img"], img)
    assert got["stats"]["ray_segments"] == stats.ray_segments
    assert got["stats"]["passes"] == stats.passes == case["cfg"][2]


@pytest.mark.parametrize("name,chunk", [("spp_gpu", None), ("spp_cpu", 768)])
def test_spp_mesh_agrees_with_the_single_renderer(world, name, chunk):
    """(b): the same samples, summed in another order."""
    case = world["cases"][name]
    img, accum, stats = _single(case, **case["kw"], **({"chunk": chunk} if chunk else {}))
    got = _lead(world, name)[0]
    assert np.all(np.abs(got["accum"] - accum) <= 1e-5 * np.abs(accum))
    assert got["stats"]["ray_segments"] == stats.ray_segments
    assert (got["img"] == img).all(axis=-1).mean() >= 0.99


def test_mesh_matches_single_chip_px_only(world):
    """tests/test_parallel.py's px-only case, against the JAX MeshRenderer (c)."""
    got, want = _lead(world, "px_gpu")[0], world["jax"]["px_gpu"]
    _assert_statistically_equal(want["img"], got["img"])
    assert got["stats"]["passes"] == want["stats"].passes == 2
    assert got["stats"]["samples_per_pixel"] == want["stats"].samples_per_pixel == 32
    assert got["stats"]["resumed_from"] == want["stats"].resumed_from == 0
    assert got["stats"]["ray_segments"] == want["stats"].ray_segments


def test_mesh_spp_sharding_matches(world):
    got, want = _lead(world, "spp_gpu")[0], world["jax"]["spp_gpu"]
    _assert_statistically_equal(want["img"], got["img"])
    assert got["stats"]["passes"] == want["stats"].passes == 2
    assert got["stats"]["samples_per_pixel"] == want["stats"].samples_per_pixel
    assert got["stats"]["ray_segments"] == want["stats"].ray_segments


def test_mesh_rerun_is_bit_stable(world):
    """(d)."""
    first, again = _lead(world, "spp_gpu")
    assert np.array_equal(_bits(first["accum"]), _bits(again["accum"]))
    assert np.array_equal(first["img"], again["img"])
    assert first["stats"]["ray_segments"] == again["stats"]["ray_segments"]


def test_every_rank_returns_the_same_image(world):
    for name, case in world["cases"].items():
        if case["kind"] != "render":
            continue
        inside = [r for r in world["ranks"][name] if r is not None]
        assert len(inside) == case["mesh"][0] * case["mesh"][1]
        for r in inside[1:]:
            for run, lead in zip(r, inside[0]):
                assert np.array_equal(run["img"], lead["img"]), name
                assert {k: v for k, v in run["stats"].items() if k != "wall_seconds"} == {
                    k: v for k, v in lead["stats"].items() if k != "wall_seconds"}, name


def test_mesh_progress_and_stats(world):
    got = _lead(world, "progress")[0]
    assert got["img"].shape == (24, 40, 3)
    assert got["progress"][-1] == 4
    assert got["stats"]["ray_segments"] > 0
    # only rank (0, 0) calls progress
    assert all(r[0]["progress"] == [] for r in world["ranks"]["progress"][1:4])


def test_mesh_progress_and_stats_are_the_jax_meshs(world):
    """(c) on the scene without fog: segments equal too."""
    got, want = _lead(world, "progress")[0], world["jax"]["progress"]
    _assert_statistically_equal(want["img"], got["img"])
    assert got["progress"] == want["progress"] == [2, 4]
    for k in ("passes", "samples_per_pixel", "ray_segments", "resumed_from", "nonfinite"):
        assert got["stats"][k] == getattr(want["stats"], k), k


def test_parity_cancel(world):
    """Cancelled after the 2nd dispatch, asked on rank (0, 0) alone, as the
    JAX MeshRenderer (and the single Renderer) stop."""
    got = world["ranks"]["cancel"]
    assert got[0][0]["img"].shape == (24, 40, 3)
    assert 0 < got[0][0]["stats"]["passes"] < 8
    assert got[0][0]["stats"]["passes"] == world["jax"]["cancel"]["stats"].passes
    assert got[0][0]["ticks"] == 2 and got[1][0]["ticks"] == 0


def test_parity_checkpoint_resume(world):
    full, cut, resumed = _lead(world, "resume")
    assert 0 < cut["stats"]["passes"] < 4
    assert resumed["stats"]["resumed_from"] == cut["stats"]["passes"]
    assert np.array_equal(full["img"], resumed["img"])  # exact resume
    assert np.array_equal(_bits(full["accum"]), _bits(resumed["accum"]))


def test_mesh_digest_is_the_jax_packages(world, tmp_path):
    """The same scene, settings and mesh give the same checkpoint digest in
    both packages, in hex."""
    with np.load(world["cases"]["resume"]["kw"]["checkpoint_path"]) as z:
        digest = bytes(z["digest"]).decode()
    assert digest == world["jax"]["digest"]
    assert digest.endswith(":mesh2x1w1") and len(digest.split(":")[0]) == 64


def test_port_resumes_a_jax_mesh_checkpoint(world):
    got = _lead(world, "resume_jax")[0]
    cut, full = world["jax"]["resume_cut"], world["jax"]["resume_full"]
    assert 0 < cut["stats"].passes < 4
    assert got["stats"]["resumed_from"] == cut["stats"].passes
    assert got["stats"]["passes"] == full["stats"].passes == 4
    _assert_statistically_equal(full["img"], got["img"])


def test_mesh_chunked_shards_match(world):
    """Chunking within a px block: the same lanes and seeds, bounded in
    flight (the classic loop's chunks change its paths, so bands)."""
    whole, chunked, ref = _lead(world, "chunked")
    for img in (whole["img"], chunked["img"]):
        a, b = img.astype(np.float64), ref["img"].astype(np.float64)
        assert abs(a.mean() - b.mean()) < 1.5
        assert (np.abs(a - b) > 40).mean() < 0.02
    assert np.array_equal(whole["img"], ref["img"])  # chunk 0 is the default


def test_mesh_final_applies_smooth_config(world):
    plain, smoothed = _lead(world, "smooth")

    def local_var(im):
        f = im.astype(np.float64)
        return np.abs(np.diff(f, axis=0)).mean() + np.abs(np.diff(f, axis=1)).mean()

    assert local_var(smoothed["img"]) < local_var(plain["img"])


def test_parallel_imports_no_jax():
    code = "import path_trace_golang_tpu_torch.parallel, sys; assert 'jax' not in sys.modules"
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshRenderer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_a_failed_rank_fails_the_world():
    """Rank 1 raises while rank 0 waits for it in a collective: the call
    raises the rank's error and leaves no rank behind."""
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_world(ranks.fail_on_rank, 2, (1,), timeout=120)
