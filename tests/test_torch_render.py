"""The port's Renderer, post-processing and PNG writer against the JAX
package, its determinism and device rules, its independence from JAX, and
(on a card only) the CUDA kernel against its plain version.

Image tolerance: the golden bands of tests/test_goldens.py:85-86 (per
channel, mean within rel 1.5% / abs 1.0, std within rel 6% / abs 1.5),
against the JAX Renderer's statistics for the same render, recorded in
tests/torch_goldens.json and checked against the JAX Renderer by
tests/test_torch_integrator.py (so the showcase pass body is compiled by
XLA in one test file only).

The JAX package is imported inside the tests that compare with it, so the
card-only tests also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_render.py``.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import post as tpost
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch.ops import cuda_trace
from path_trace_golang_tpu_torch.ops.vec import V3
from path_trace_golang_tpu_torch.scene import builtin as TB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(width=32, height=16, samples_per_px=2, max_depth=4)
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_goldens.json")
RECORD_KEY = "demo_showcase:gpu:32x16:spp2:d4:seed3"


def _stats(img):
    f = np.asarray(img).astype(np.float64)
    return f.mean(axis=(0, 1)), f.std(axis=(0, 1))


@pytest.fixture(scope="module")
def showcase_images():
    """The JAX Renderer's image statistics for this render, as recorded in
    tests/torch_goldens.json (test_torch_integrator.py holds the record to
    the JAX Renderer, where the showcase program is compiled anyway), and
    the port's image."""
    with open(RECORD) as f:
        want = json.load(f)[RECORD_KEY]
    r = tpt.Renderer(contract="gpu", seed=3, device="cpu")
    timg = r.render(TB.demo_showcase(), tpt.RenderConfig(**CFG))
    return want, timg, r.stats


def test_renderer_showcase_within_golden_bands(showcase_images):
    want, timg, stats = showcase_images
    assert timg.shape == (16, 32, 3) and timg.dtype == np.uint8
    (jm, js), (tm, ts) = (want["mean"], want["std"]), _stats(timg)
    for ch in range(3):
        assert tm[ch] == pytest.approx(jm[ch], rel=0.015, abs=1.0)
        assert ts[ch] == pytest.approx(js[ch], rel=0.06, abs=1.5)
    assert stats.passes == 2 and stats.samples_per_pixel == 32
    assert stats.nonfinite == 0 and stats.ray_segments > 0 and stats.mrays_per_sec > 0


def test_renderer_is_deterministic(showcase_images):
    _j, timg, _s = showcase_images
    again = tpt.Renderer(contract="gpu", seed=3, device="cpu").render(TB.demo_showcase(), tpt.RenderConfig(**CFG))
    assert np.array_equal(timg, again)


def test_window_equals_pass_by_pass(monkeypatch):
    """A 2-pass window renders the same image as two 1-pass windows."""
    sc, cfg = TB.demo_cornell(), tpt.RenderConfig(16, 8, 2, 3)
    a = tpt.Renderer(contract="gpu", seed=9, device="cpu").render(sc, cfg)
    monkeypatch.setenv("PATHTRACER_PASS_WINDOW", "1")
    b = tpt.Renderer(contract="gpu", seed=9, device="cpu").render(sc, cfg)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_progress_and_cancel():
    seen = []
    r = tpt.Renderer(contract="gpu", seed=1, device="cpu")
    img = r.render(
        TB.demo_cornell(), tpt.RenderConfig(8, 8, 4, 2),
        progress=lambda p, im: seen.append((p, im.shape)), cancel=lambda: len(seen) >= 2,
    )
    assert seen == [(1, (8, 8, 3)), (2, (8, 8, 3))]
    assert r.stats.passes == 2 and img.shape == (8, 8, 3)


def test_renderer_needs_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.Renderer()
    with pytest.raises(RuntimeError):
        tpt.Renderer(contract="gpu", device="cuda")
    assert tpt.Renderer(device="cpu").device.type == "cpu"


def test_render_settings_presets():
    from path_trace_golang_tpu.render import render_settings_for_mode as jmode

    import dataclasses

    for mode in ("final", "preview"):
        assert dataclasses.asdict(tpt.render_settings_for_mode(mode)) == dataclasses.asdict(jmode(mode))


def test_finalize_gpu_contract_matches_jax():
    import jax.numpy as jnp
    from path_trace_golang_tpu import post as jpost

    rng = np.random.default_rng(12)
    accum = (rng.gamma(1.0, 3.0, size=(24, 40, 3)) * 16).astype(np.float32)
    for denoise in (False, True):
        want = np.asarray(jpost.finalize_gpu_contract(jnp.asarray(accum), jnp.asarray(5), denoise=denoise))
        got = tpost.finalize_gpu_contract(torch.from_numpy(accum), 5, denoise=denoise).numpy()
        diff = np.abs(want.astype(int) - got.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    u8 = rng.integers(0, 256, size=(24, 40, 3)).astype(np.uint8)
    want = np.asarray(jpost.box_smooth(jnp.asarray(u8), 2, 0.5))
    got = tpost.box_smooth(torch.from_numpy(u8), 2, 0.5).numpy()
    assert np.abs(want.astype(int) - got.astype(int)).max() <= 1


def test_save_png_matches_jax_writer(tmp_path):
    from path_trace_golang_tpu import io_png as jpng

    img = np.random.default_rng(13).integers(0, 256, size=(9, 7, 3)).astype(np.uint8)
    tpt.save_png(tmp_path / "t.png", img)
    jpng._write_png_fallback(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_port_imports_no_jax():
    """A fresh interpreter renders through the port without loading jax or
    the JAX package, and no module of the port names either."""
    code = textwrap.dedent(
        """
        import sys
        import path_trace_golang_tpu_torch as pt
        from path_trace_golang_tpu_torch.scene import builtin
        img = pt.Renderer(contract="gpu", device="cpu").render(
            builtin.demo_cornell(), pt.RenderConfig(4, 4, 1, 2))
        assert img.shape == (4, 4, 3)
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "path_trace_golang_tpu."))
               or m == "path_trace_golang_tpu"]
        print("BAD", bad)
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    pkg = os.path.join(REPO, "path_trace_golang_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
                assert "path_trace_golang_tpu." not in src.replace("path_trace_golang_tpu_torch", ""), f


def test_kernel_rejects_what_it_does_not_run():
    """On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
    tensor it runs the plain version (checked here without a card)."""
    sc = TB.demo_cornell()
    pack = tpt.pack_scene(sc, 8, 8, device="cpu")
    tcfg = TI.trace_config_for_scene(pack, sc, 2, "gpu")
    idx = torch.arange(64, dtype=torch.int32)
    before = cuda_trace.PLAIN_CALLS
    col, segs = cuda_trace.render_pass(
        pack, 1, idx % 8, idx // 8, tcfg=tcfg, width=8, height=8, n_strata=4, samples=16,
        has_aperture=False, normalize_pass=False,
    )
    assert cuda_trace.PLAIN_CALLS == before + 1 and col.x.shape == (64,) and int(segs) > 0
    # the classic loop renders one pass a launch, like its plain version
    classic = TI.TraceConfig(max_depth=2, contract="cpu", regen=False)
    with pytest.raises(ValueError, match="regeneration"):
        cuda_trace.render_pass_cuda(
            pack, 1, idx % 8, idx // 8, tcfg=classic, width=8, height=8, n_strata=1, samples=1,
            has_aperture=False, normalize_pass=False, n_passes=2,
        )
    # host tensors never reach a kernel: their pointers would be read on the card
    for cfg in (tcfg, classic):
        with pytest.raises(ValueError, match="CUDA tensors"):
            cuda_trace.render_pass_cuda(
                pack, 1, idx % 8, idx // 8, tcfg=cfg, width=8, height=8, n_strata=4, samples=16,
                has_aperture=False, normalize_pass=False,
            )
    o = V3(*(torch.zeros(4) for _ in range(3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_trace.trace_grid_cuda(o, o, torch.zeros(4, dtype=torch.int64), pack, classic)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo_showcase", "demo_cornell"])
@pytest.mark.parametrize("n_passes", [1, 2])
def test_kernel_matches_plain_on_card(name, n_passes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    w, h = 64, 36
    sc = getattr(TB, name)()
    pack = tpt.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(pack, sc, 6, "gpu")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False, n_passes=n_passes)
    launches = cuda_trace.LAUNCHES
    ck, sk = cuda_trace.render_pass(pack, 5, idx % w, idx // w, **kw)
    assert cuda_trace.LAUNCHES == launches + 1
    cp, sp = cuda_trace.render_pass_plain(pack, 5, idx % w, idx // w, **kw)
    torch.cuda.synchronize()
    a, b = ck.to_rows(), cp.to_rows()
    ok = ((a - b).abs() <= 1e-3 * b.abs() + 1e-3).all(dim=-1)
    assert ok.double().mean().item() >= 0.95
    assert abs(int(sk) - int(sp)) <= 0.02 * int(sp)
    assert torch.all((a.double().mean(0) - b.double().mean(0)).abs() <= 0.01 * b.double().mean(0).abs())
    img = TR.Renderer(contract="gpu", seed=2).render(sc, TR.RenderConfig(w, h, n_passes, 6))
    assert img.shape == (h, w, 3)


def _accum_of(monkeypatch, renderer, sc, cfg):
    """Render and return (the accumulator as the gpu contract's finish
    receives it, the statistics)."""
    box = []
    real = TR.finalize_gpu_contract
    monkeypatch.setattr(TR, "finalize_gpu_contract",
                        lambda flat, *a, **k: box.append(flat.clone()) or real(flat, *a, **k))
    renderer.render(sc, cfg)
    return box[-1], renderer.stats


@pytest.fixture(scope="module")
def lanes_in_one_call():
    """A 16x16 showcase window (depth 4, 2 passes, frame seed 5) traced as
    one call over all its lanes: (colors f32[256, 3], segments)."""
    sc = TB.demo_showcase()
    pack = tpt.pack_scene(sc, 16, 16, device="cpu")
    tcfg = TI.trace_config_for_scene(pack, sc, 4, "gpu")
    col, segs = TR.trace_pass_lanes(pack, 5, torch.arange(16 * 16), tcfg=tcfg, width=16, height=16, n_strata=4,
                                    samples=16, has_aperture=sc.camera.aperture > 0, normalize_pass=False,
                                    n_passes=2)
    return col, int(segs)


@pytest.mark.parametrize("chunk", [64, 128, 16 * 16])
def test_gpu_contract_is_independent_of_the_chunk(chunk, monkeypatch, lanes_in_one_call):
    """The premise of one launch a window: the gpu contract's accumulator is
    the lanes' own pass-window colors whatever the chunk (64, 128, the whole
    16x16 frame), bit for bit, and the segments are the same."""
    renderer = tpt.Renderer(contract="gpu", seed=5, chunk=chunk, device="cpu")
    accum, stats = _accum_of(monkeypatch, renderer, TB.demo_showcase(), tpt.RenderConfig(16, 16, 2, 4))
    want, segs = lanes_in_one_call
    assert torch.equal(accum.reshape(-1, 3).view(torch.int32), want.view(torch.int32))
    assert stats.ray_segments == segs and stats.passes == 2


def _card_case(name, w, h, depth=6):
    sc = getattr(TB, name)()
    pack = tpt.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(pack, sc, depth, "gpu")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0,
              normalize_pass=False)
    return pack, idx % w, torch.div(idx, w, rounding_mode="floor"), kw


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [1, 8])
def test_fog_kernel_matches_plain_on_card(n_passes):
    """The fog kernel's terms against the plain fog prepass of
    pass_body_grid (render.fog_pass_terms), bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    pack, px, py, kw = _card_case("demo_showcase", 256, 144)
    launches = cuda_trace.FOG_LAUNCHES
    got = cuda_trace.fog_pass(pack, 3, px, py, n_passes=n_passes, **kw)
    assert cuda_trace.FOG_LAUNCHES == launches + 1
    want = TR.fog_pass_terms(pack, 3, px, py, width=256, height=144, samples=16, has_aperture=kw["has_aperture"],
                             n_passes=n_passes)
    want = torch.stack([torch.stack([t.x, t.y, t.z]) for t in want])
    torch.cuda.synchronize()
    assert got.shape == (n_passes, 3, 256 * 144)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,refill", [pytest.param("demo_showcase", False, id="demo_showcase"),
                                         pytest.param("bench_mesh", False, id="bench_mesh"),
                                         pytest.param("bench_mesh", True, id="bench_mesh_refill")])
def test_window_kernel_matches_plain_on_card(name, refill):
    """B1 in one launch against the plain version bit for bit, segments
    equal: on 2,065 lanes (not a multiple of the block; depth 6, 2 passes)
    one thread a lane on demo_showcase, and on bench_mesh (paged) persistent
    blocks whose grid holds a thread for every lane; with ``refill``, on
    twice the lanes that the paged grid holds (4 blocks an SM) plus a
    part-full warp (depth 2, one pass), so that most threads take a second
    lane from the launch's counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    if refill:
        pack, px, py, kw = _card_case(name, 512, 512, depth=2)
        n = 2 * 4 * torch.cuda.get_device_properties(0).multi_processor_count * 128 + 17
        assert n <= px.numel()
        px, py, n_passes = px[:n], py[:n], 1
    else:
        pack, px, py, kw = _card_case(name, 64, 36)
        px, py, n_passes = px.repeat(2)[:2065], py.repeat(2)[:2065], 2
    ck, sk = cuda_trace.render_pass(pack, 4, px, py, n_passes=n_passes, **kw)
    cp, sp = cuda_trace.render_pass_plain(pack, 4, px, py, n_passes=n_passes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ck.to_rows().view(torch.int32), cp.to_rows().view(torch.int32))
    assert int(sk) == int(sp)


def test_fog_pass_runs_the_plain_version_on_cpu():
    """On CPU tensors the fog kernel's wrapper returns the plain fog-once
    terms, f32[passes, 3, N], and counts a plain call."""
    sc = TB.demo_showcase()
    pack = tpt.pack_scene(sc, 8, 4, device="cpu")
    tcfg = TI.trace_config_for_scene(pack, sc, 3, "gpu")
    idx = torch.arange(32, dtype=torch.int32)
    before = cuda_trace.FOG_PLAIN_CALLS
    got = cuda_trace.fog_pass(pack, 2, idx % 8, idx // 8, tcfg=tcfg, width=8, height=4, samples=16,
                              has_aperture=sc.camera.aperture > 0, n_passes=2)
    want = TR.fog_pass_terms(pack, 2, idx % 8, idx // 8, width=8, height=4, samples=16,
                             has_aperture=sc.camera.aperture > 0, n_passes=2)
    assert cuda_trace.FOG_PLAIN_CALLS == before + 1 and got.shape == (2, 3, 32)
    assert torch.equal(got[1, 2], want[1].z) and bool((got >= 0).all()) and float(got.sum()) > 0


def test_b1_split_arithmetic():
    """B1's split follows from the counting build's tallies of a frame's
    launches: stage shares of B1's cycles, NEE active lanes, launch tail,
    hash rounds a segment and the bound in FFMA slots."""
    launch = dict(segments=10, ops=2000, cycles=1000, fog_cycles=100, isect_cycles=200, nee_cycles=150,
                  lite_cycles=50, loop_cycles=900, nee_active=48, nee_entries=3, warp_tail_cycles=40,
                  rng_rounds=200, first_start_ns=0, first_end_ns=80, last_end_ns=100, last_start_ns=10)
    sp = cuda_trace.b1_split([launch, launch])
    assert sp["share_rest"] == pytest.approx((900 - 400 - 40) / 1000) and sp["share_fog"] == pytest.approx(0.1)
    assert sp["nee_active_share"] == 0.5 and sp["launch_tail_share"] == pytest.approx(0.2)
    assert sp["rng_rounds_per_segment"] == 20 and sp["bound_slots_ms"] == pytest.approx(
        (4000 + 16 * 400) / cuda_trace.UNFUSED_SLOTS * 1e3)
    assert "NEE active-lane share 50.00%" in cuda_trace.split_line(sp)
