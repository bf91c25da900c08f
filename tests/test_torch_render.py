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
from pathlib import Path

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
    """The port's zlib writer gives the JAX package's fallback bytes; save_png
    (native encoder first, as the JAX package's) writes the same bytes as the
    JAX package's native encoder where the library loads."""
    from path_trace_golang_tpu import io_png as jpng
    from path_trace_golang_tpu.utils import native as jnative
    from path_trace_golang_tpu_torch import io_png as tpng

    img = np.random.default_rng(13).integers(0, 256, size=(9, 7, 3)).astype(np.uint8)
    jpng._write_png_fallback(str(tmp_path / "j.png"), img)
    assert tpng.encode_png_zlib(img) == (tmp_path / "j.png").read_bytes()
    tpt.save_png(tmp_path / "t.png", img)
    want = jnative.encode_png(img) if jnative.available() else (tmp_path / "j.png").read_bytes()
    assert (tmp_path / "t.png").read_bytes() == want


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo_showcase", "bench_mesh"])
def test_a_window_after_the_first_does_not_synchronise_on_card(name):
    """After one call of render_pass_cuda on a pack, the next (a window of
    the same render) launches without synchronising the card: its camera
    basis and scene arguments are the pack's.  Its colours and segments are
    those of a call on a fresh pack of the same scene, bit for bit.  The
    showcase marches its fog in the fog kernel; bench_mesh walks pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    w, h = 64, 36
    sc = getattr(TB, name)()
    pack = tpt.pack_scene(sc, w, h, device="cuda")
    assert (pack.paged is not None) == (name == "bench_mesh")
    tcfg = TI.trace_config_for_scene(pack, sc, 6, "gpu")
    assert tcfg.enable_fog_march == (name == "demo_showcase")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    px, py = idx % w, idx // w
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False, n_passes=2)
    cuda_trace.render_pass_cuda(pack, 4, px, py, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        col, segs = cuda_trace.render_pass_cuda(pack, 5, px, py, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, want_segs = cuda_trace.render_pass_cuda(tpt.pack_scene(sc, w, h, device="cuda"), 5, px, py, **kw)
    assert torch.equal(col.to_rows().view(torch.int32), want.to_rows().view(torch.int32))
    assert int(segs) == int(want_segs) > 0


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


def _fog_scene(case):
    """The fog scenes of the fog march's card tests: the showcase; the
    showcase with a noise scale that takes sinf past |x| = 105,615 (its slow
    reduction); twelve lights, one an emissive box that the estimator lists
    but cannot sample, over a floor with spheres that block shadow rays; the
    same with 20 more spheres (35 objects: the march culls nothing above
    31); and a scene some 10^3 from the origin whose far, small lights cast
    shadow rays of 10^3 past small spheres, where the plain sphere test
    reports hits well outside a sphere (the cull's margin grows with the
    rays' length: common.cuh, shadow_cull)."""
    from path_trace_golang_tpu_torch.scene.model import Color, Fog, Material, Object, Scene, Sky, Vec3
    from path_trace_golang_tpu_torch.scene.model import Camera as Cam

    if case in ("showcase", "partial_warp"):
        return TB.demo_showcase()
    if case == "loud_noise":
        sc = TB.demo_showcase()
        sc.fog.noise_scale = 200.0
        return sc
    if case == "far":
        return _far_scene()
    mats = [Material(id="floor", type="lambert", albedo=Color(0.8, 0.8, 0.8)),
            Material(id="matte", type="lambert", albedo=Color(0.7, 0.3, 0.2)),
            Material(id="steel", type="metal", albedo=Color(0.8, 0.8, 0.85), smoothness=0.6)]
    objs = [Object(id="p", type="plane", position=Vec3(0, 0, 0), size=Vec3(0, 0, 0), material_id="floor"),
            Object(id="a", type="sphere", position=Vec3(-1.2, 1, 0), size=Vec3(1, 0, 0), material_id="matte"),
            Object(id="b", type="sphere", position=Vec3(1.2, 1, 0), size=Vec3(1, 0, 0), material_id="steel")]
    for i in range(12):
        mats.append(Material(id=f"L{i}", type="emissive", emit=Color(1, 1, 1), power=2.0 + i * 0.1))
        kind, size = ("box", Vec3(0.4, 0.4, 0.4)) if i == 5 else ("sphere_light", Vec3(0.3, 0, 0))
        objs.append(Object(id=f"l{i}", type=kind, position=Vec3(i - 5.5, 4, -2), size=size, material_id=f"L{i}"))
    if case == "many_objects":
        for i in range(20):
            objs.append(Object(id=f"s{i}", type="sphere", position=Vec3(i % 5 - 2.0, 2.5 + i // 5 * 0.4, -1),
                               size=Vec3(0.15, 0, 0), material_id="matte"))
    return Scene(name=case, camera=Cam(position=Vec3(0, 1, 5), target=Vec3(0, 1, 0), up=Vec3(0, 1, 0), fov=60),
                 sky=Sky(type="solid", color=Color(0, 0, 0)), materials=mats, objects=objs,
                 fog=Fog(sigma_s=0.02, sigma_a=0.01, g=0.3, color=Color(1, 1, 1), scatter=1.0, density=0.01,
                         gpu_volumetric=True, hetero_strength=0.5, noise_scale=3.0, noise_octaves=4))


def _far_scene():
    """The ``far`` fog scene: the world moved to (300, 100, -700), one near
    sphere light and two lights of radius 1 some 1,000 away, an
    icosahedron mesh, and 24 spheres of radius 0.01-0.05 strewn 0.2-1.5 off
    the lines to the far lights, 300 to 900 along them."""
    from path_trace_golang_tpu_torch.scene.model import Color, Fog, Material, Object, Scene, Sky, Vec3
    from path_trace_golang_tpu_torch.scene.model import Camera as Cam

    rng = np.random.default_rng(11)
    org = np.array([300.0, 100.0, -700.0])

    def at(*v):
        return Vec3(*(float(x) for x in org + np.asarray(v, dtype=np.float64)))

    mats = [Material(id="floor", type="lambert", albedo=Color(0.8, 0.8, 0.8)),
            Material(id="matte", type="lambert", albedo=Color(0.7, 0.3, 0.2)),
            Material(id="L", type="emissive", emit=Color(1, 1, 1), power=3.0),
            Material(id="far", type="emissive", emit=Color(1, 0.9, 0.8), power=4e5)]
    objs = [Object(id="p", type="plane", position=at(0, 0, 0), size=Vec3(0, 0, 0), material_id="floor"),
            Object(id="a", type="sphere", position=at(-1.2, 1, 0), size=Vec3(1, 0, 0), material_id="matte"),
            Object(id="l0", type="sphere_light", position=at(0, 4, -1), size=Vec3(0.4, 0, 0), material_id="L"),
            TB._icosahedron("ico", "matte", pos=tuple(float(x) for x in org + (1.5, 1.2, -0.5)), scale=0.5)]
    far = [np.array([600.0, 700.0, -400.0]), np.array([-500.0, 800.0, -300.0])]
    for i, lc in enumerate(far):
        objs.append(Object(id=f"l{i + 1}", type="sphere_light", position=at(*lc), size=Vec3(1, 0, 0),
                           material_id="far"))
    for i in range(24):
        lc = far[i % 2]
        axis = lc / np.linalg.norm(lc)
        side = np.cross(axis, rng.normal(size=3))
        side /= np.linalg.norm(side)
        c = np.array([0.0, 1.5, 0.0]) + axis * rng.uniform(300, 900) + side * rng.uniform(0.2, 1.5)
        objs.append(Object(id=f"s{i}", type="sphere", position=at(*c), size=Vec3(float(rng.uniform(0.01, 0.05)), 0, 0),
                           material_id="matte"))
    return Scene(name="far", camera=Cam(position=at(0, 1.5, 6), target=at(0, 1.5, 0), up=Vec3(0, 1, 0), fov=60),
                 sky=Sky(type="solid", color=Color(0, 0, 0)), materials=mats, objects=objs,
                 fog=Fog(sigma_s=0.02, sigma_a=0.01, g=0.3, color=Color(1, 1, 1), scatter=1.0, density=0.01,
                         gpu_volumetric=True, hetero_strength=0.5, noise_scale=3.0, noise_octaves=3))


def _card_case(name, w, h, depth=6, scene=None):
    sc = scene if scene is not None else getattr(TB, name)()
    pack = tpt.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(pack, sc, depth, "gpu")
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0,
              normalize_pass=False)
    return pack, idx % w, torch.div(idx, w, rounding_mode="floor"), kw


FOG_CASES = [("showcase", 1), ("showcase", 8), ("loud_noise", 2), ("twelve_lights", 2), ("many_objects", 1),
             ("partial_warp", 2), ("far", 2)]


def _fog_lanes(case, w, h):
    """The card case of a fog scene: on ``partial_warp`` 1,041 lanes strided
    over the frame (a part-full last warp), else every lane."""
    pack, px, py, kw = _card_case(None, w, h, scene=_fog_scene(case))
    if case == "partial_warp":
        sub = torch.arange(1041, device="cuda") * 8
        px, py = px[sub], py[sub]
    return pack, px, py, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case,n_passes", FOG_CASES)
def test_fog_kernel_matches_plain_on_card(case, n_passes):
    """The fog kernel's terms against the plain fog prepass of
    pass_body_grid (render.fog_pass_terms), bit for bit, on scenes that
    reach every part of the march's design (the counting build shows that
    they do): blocked shadow tests, a light it cannot sample, sinf past
    its fast reduction, more objects than the shadow cull takes, a part-full
    warp, shadow rays of 10^3 that pass small spheres."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    w, h = (256, 144) if case == "showcase" else (128, 72)
    pack, px, py, kw = _fog_lanes(case, w, h)
    launches = cuda_trace.FOG_LAUNCHES
    got = cuda_trace.fog_pass(pack, 3, px, py, n_passes=n_passes, **kw)
    assert cuda_trace.FOG_LAUNCHES == launches + 1
    want = TR.fog_pass_terms(pack, 3, px, py, width=w, height=h, samples=16, has_aperture=kw["has_aperture"],
                             n_passes=n_passes)
    want = torch.stack([torch.stack([t.x, t.y, t.z]) for t in want])
    torch.cuda.synchronize()
    assert got.shape == (n_passes, 3, px.numel())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    counted = cuda_trace.fog_count_ops(pack, 3, px, py, n_passes=n_passes, **kw)
    assert counted["shadow_blocked"] > 0 and float(want.sum()) > 0
    if case == "loud_noise":
        assert counted["sin_large"] > counted["sin_calls"] // 2
    if case == "twelve_lights":  # 11 sphere lights tested, the box light never
        assert counted["shadow_lanes"] == 11 * 24 * n_passes * px.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted({c for c, _ in FOG_CASES}))
def test_classic_march_matches_plain_on_card(case):
    """Faithful fog's march kernel (with the sample kernel after it) on the
    fog march's card scenes against the plain version, bit for bit, segments
    equal: one pass of 16 samples in 3 chunks, the last padded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    sc = _fog_scene(case)
    w, h = 48, 27
    pack = tpt.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(pack, sc, 4, "gpu", faithful_fog=True)
    chunk = 347 if case == "partial_warp" else -(-w * h // 3) + 3  # 1,041 lanes: a part-full last warp
    idx = torch.arange(3 * chunk, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0,
              normalize_pass=False)
    got = torch.zeros((idx.numel(), 3), dtype=torch.float32, device="cuda")
    want = got.clone()
    marches = cuda_trace.MARCH_LAUNCHES
    sk = cuda_trace.classic_render(got, pack, 5, idx % w, idx // w, chunk=chunk, **kw)
    assert cuda_trace.MARCH_LAUNCHES == marches + 16
    sp = cuda_trace.classic_render_plain(want, pack, 5, idx % w, idx // w, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) and int(sk) == int(sp)


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


def test_march_split_arithmetic():
    """The fog march's split follows from the counting build's tallies of
    its launches: stage shares of the launches' lane cycles (the light
    stage without its shadow tests), the lanes that run a shadow test, the
    blocked share, visits a test and the sinf arguments past 105,615."""
    launch = dict(segments=0, ops=3000, cycles=1000, rng_rounds=100, march_hit_cycles=50, march_noise_cycles=150,
                  march_light_cycles=600, march_shadow_cycles=450, march_tail_cycles=20, advance_cycles=10,
                  camera_cycles=30, shadow_lanes=96, shadow_active=40, shadow_entries=2, shadow_blocked=10,
                  shadow_prims=600, shadow_nodes=80, sin_calls=400, sin_large=4, first_start_ns=0, first_end_ns=60,
                  last_end_ns=100, last_start_ns=40)
    launch.update(dict.fromkeys(("walk_ops", "walk_cycles", "fog_cycles", "isect_cycles", "nee_cycles",
                                 "lite_cycles", "loop_cycles", "nee_active", "nee_entries", "warp_tail_cycles"), 0))
    sp = cuda_trace.march_split([launch, launch])
    assert sp["share_light"] == pytest.approx(0.15) and sp["share_shadow"] == pytest.approx(0.45)
    assert sp["share_rest"] == pytest.approx((1000 - 50 - 150 - 600 - 20 - 40) / 1000)
    assert sp["shadow_lane_share"] == pytest.approx(40 / 96) and sp["shadow_warp_share"] == pytest.approx(40 / 64)
    assert sp["shadow_blocked_share"] == 0.25 and sp["prims_per_test"] == 15 and sp["nodes_per_test"] == 2
    assert sp["sin_large_share"] == 0.01 and sp["launch_tail_share"] == pytest.approx(0.4) and sp["launches"] == 2
    assert sp["bound_slots_ms"] == pytest.approx((6000 + 16 * 200) / cuda_trace.UNFUSED_SLOTS * 1e3)
    assert "shadow tests 45.00%" in cuda_trace.march_split_line(sp)


def test_counter_slots_match_common_cuh():
    """The counters of a launch name every slot of csrc/common.cuh: the
    march's split after the classic loop's, then the lane cursor, the walk's
    sweep counts last."""
    src = (Path(cuda_trace.__file__).resolve().parent.parent / "csrc" / "common.cuh").read_text()
    assert f"N_COUNTERS = {cuda_trace.N_COUNTERS}, CURSOR = 35" in src
    assert cuda_trace.N_COUNTERS == 36 + len(cuda_trace._SWEEP_NAMES)
    vals = torch.arange(cuda_trace.N_COUNTERS, dtype=torch.int64)
    c = cuda_trace._count_dict(vals)
    assert c["march_hit_cycles"] == 21 and c["march_tail_cycles"] == 33 and c["warp_segments"] == 20



@pytest.mark.parametrize("dist,radius", [(10.0, 0.01), (100.0, 0.01), (1000.0, 0.01), (5000.0, 0.15)])
def test_shadow_cull_sphere_margin_covers_rounding(dist, radius):
    """The fog march's shadow cull keeps a sphere within
    sqrt(r^2 + CULL_SPHERE_ERR (D^2 + r^2)) of the hull of the warp's rays
    (csrc/common.cuh, shadow_cull), D a bound on the distance from a ray's
    origin to the centre: the plain sphere test (the kernel's float32
    arithmetic, bit for bit) reports hits only that close.  Shadow rays from
    origins D away that pass just by a sphere, as the march makes them (the
    direction to the light's point times 1 / dist, t_max = dist - 0.002):
    every hit the test reports lies well inside that radius, while at
    D >= 1,000 some lie farther outside the sphere than a margin of
    1e-2 + 1e-4 D would reach."""
    import re

    from path_trace_golang_tpu_torch.ops import geometry as G
    from path_trace_golang_tpu_torch.scene.model import Color, Material, Object, Scene, Vec3
    from path_trace_golang_tpu_torch.scene.model import Camera as Cam

    src = (Path(cuda_trace.__file__).resolve().parent.parent / "csrc" / "common.cuh").read_text()
    err = float(re.search(r"constexpr float CULL_SPHERE_ERR = ([0-9.e+-]+)f;", src).group(1))
    assert err == 2.0 ** -16
    rng = np.random.default_rng(int(dist))
    n = 40000
    c = rng.uniform(-100, 100, 3)
    sc = Scene(name="one", camera=Cam(position=Vec3(0, 0, 5), target=Vec3(0, 0, 0), up=Vec3(0, 1, 0), fov=60),
               materials=[Material(id="m", type="lambert", albedo=Color(0.5, 0.5, 0.5))],
               objects=[Object(id="s", type="sphere", position=Vec3(*(float(x) for x in c)),
                               size=Vec3(radius, 0, 0), material_id="m")])
    pack = tpt.pack_scene(sc, 8, 8, device="cpu")
    c = pack.host("obj")[0, 4:7].astype(np.float64)
    r = float(pack.host("obj")[0, 8])
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    side = rng.normal(size=(n, 3))
    side -= (side * u).sum(1, keepdims=True) * u
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    o = (c + dist * u).astype(np.float32)
    miss = rng.uniform(0.0, r + 3e-3 * dist + 0.05, n)  # the exact line's distance from the centre, about
    lp = (c + side * miss[:, None] - u * dist * rng.uniform(0.2, 1.5, n)[:, None]).astype(np.float32)
    ot, lt = torch.from_numpy(o), torch.from_numpy(lp)
    to_l = V3(lt[:, 0] - ot[:, 0], lt[:, 1] - ot[:, 1], lt[:, 2] - ot[:, 2])
    dist_l = torch.sqrt(to_l.dot(to_l))
    d = to_l * (1.0 / dist_l)
    orig = V3(ot[:, 0], ot[:, 1], ot[:, 2])
    (_m, t, ok), = list(G._object_candidates(orig, d, pack, 0.001))
    ok = (ok & (t <= dist_l - 0.002)).numpy()
    assert ok.sum() > 100
    dd = np.stack([d.x.numpy(), d.y.numpy(), d.z.numpy()], 1).astype(np.float64)
    p = o.astype(np.float64) + t.numpy().astype(np.float64)[:, None] * dd
    big_d2 = ((o - c) ** 2).sum(1)
    over = (((p - c) ** 2).sum(1) - r * r) / (big_d2 + r * r)
    assert over[ok].max() <= err / 16
    line = np.linalg.norm(np.cross(c - o, dd / np.linalg.norm(dd, axis=1, keepdims=True)), axis=1)
    if dist >= 1000:
        assert (line[ok] - r).max() > 1e-2 + 1e-4 * dist
