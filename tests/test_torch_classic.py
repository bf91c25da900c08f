"""The classic per-sample loop of the PyTorch port against the JAX package:
the cpu contract (the JAX package's default backend), faithful fog and the
public ``trace()``, and on a card only kernel B3 and the classic instance
of the whole-pass kernel against their plain versions.

Both packages run on the CPU on the same inputs, made with numpy from a
seed; the JAX side takes its XLA path (``pallas_supported`` is False on the
CPU).  Tolerances:

* ``cosine_direction_onb``: abs 1e-6 / rel 1e-5;
* ``finalize_cpu_contract``: bit-equal bytes;
* ``_dielectric_exit_scan`` on a glass box, sphere and plane: ``found``
  equal on every ray, the exit point within rel 1e-5 (abs 1e-6);
* ``trace()`` / ``trace_grid``, 512 rays each, cpu contract and gpu
  contract on demo_cornell (depth 5, so that the longest path of the call
  is the depth limit), and the gpu contract with the in-trace fog march
  and an active mask on a small fog scene with the noise strength 0: >= 95%
  of lanes within |a-b| <= 1e-3|b| + 1e-3, segments equal, and the
  returned state bit-equal on every lane (it depends on the call's longest
  path, integrator.trace_grid);
* the classic ``pass_body_grid`` (cpu contract on demo_cornell; faithful fog
  on the fog scene, 16 samples chained through the returned state): the
  lane, segment and channel-mean bands of tests/test_torch_integrator.py,
  against the program that the JAX Renderer compiles for that image
  (``render._render_pass_chunk``), which also renders the JAX images whose
  statistics tests/torch_goldens.json records;
* Renderer images: the golden bands (mean rel 1.5% / abs 1.0, std rel 6% /
  abs 1.5) of those records.

Measured on an x86-64 CPU (one PyTorch thread) in the comments of each
test.  The fog scene's noise strength is 0 because XLA's CPU backend fuses
``fog.hash31``'s multiply-adds under jit and the port does not
(tests/test_torch_ops.py::test_hash31_fma_witness).
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_trace_golang_tpu as jpt
from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import post as jpost
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import scene as JS
from path_trace_golang_tpu import soa as jsoa
from path_trace_golang_tpu.ops import sampling as jsampling
from path_trace_golang_tpu.ops.vec import V3 as JV3
from path_trace_golang_tpu.scene import builtin as JB

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import post as tpost
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.ops import cuda_trace
from path_trace_golang_tpu_torch.ops import sampling as tsampling
from path_trace_golang_tpu_torch.ops.vec import V3 as TV3
from path_trace_golang_tpu_torch.scene import builtin as TB

RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_goldens.json")
N = 512
# the cpu contract on demo_cornell; faithful fog on the small fog scene
CW, CH, CSPP, CDEPTH, CSEED = 32, 24, 4, 6, 5
FW, FH, FSPP, FDEPTH, FSEED = 24, 16, 1, 4, 3
CPU_KEY = f"demo_cornell:cpu:{CW}x{CH}:spp{CSPP}:d{CDEPTH}:seed{CSEED}"
FOG_KEY = f"fog_small:gpu-faithful:{FW}x{FH}:spp{FSPP}:d{FDEPTH}:seed{FSEED}"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside other test workers on the same cores, PyTorch's splitting of
    the plain loops' lane ops across threads costs more than it saves."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# scenes, built alike in both packages
# ---------------------------------------------------------------------------


def _fog_scene(S):
    """Faithful fog at a small size: a floor, a rough-metal and a glass
    sphere, one sphere light, homogeneous fog (noise strength 0)."""
    C, V = S.Color, S.Vec3
    return S.Scene(
        name="fog_small",
        camera=S.Camera(position=V(0.0, 1.6, 6.0), target=V(0.0, 1.0, 0.0), up=V(0, 1, 0), fov=45.0),
        materials=[
            S.Material(id="floor", type="lambert", albedo=C(0.6, 0.6, 0.62)),
            S.Material(id="steel", type="metal", albedo=C(0.8, 0.8, 0.85), smoothness=0.55),
            S.Material(id="glass", type="dielectric", ior=1.5, absorption=C(0.3, 0.1, 0.05), absorption_scale=0.5),
            S.Material(id="lamp", type="emissive", emit=C(1.0, 0.9, 0.8), power=4.0),
        ],
        objects=[
            S.Object(id="ground", type="plane", position=V(0, 0, 0), size=V(0, 0, 0), material_id="floor"),
            S.Object(id="ball", type="sphere", position=V(-0.9, 0.8, 0.0), size=V(0.8, 0, 0), material_id="steel"),
            S.Object(id="bead", type="sphere", position=V(0.9, 0.7, 0.4), size=V(0.7, 0, 0), material_id="glass"),
            S.Object(id="sun", type="sphere_light", position=V(0.5, 3.5, 1.0), size=V(0.5, 0, 0),
                     material_id="lamp"),
        ],
        sky=S.Sky(type="gradient", horizon=C(0.3, 0.28, 0.26), zenith=C(0.04, 0.06, 0.1)),
        fog=S.Fog(density=0.04, color=C(0.9, 0.9, 1.0), scatter=0.8, sigma_s=0.05, sigma_a=0.02, g=0.3,
                  hetero_strength=0.0, noise_scale=1.0, noise_octaves=2, gpu_volumetric=True),
    )


def _glass_scene(S, kind):
    """One glass object of ``kind`` (box, sphere or plane) and a matte
    sphere, which the exit scan must pass over."""
    C, V = S.Color, S.Vec3
    size = {"box": V(2.0, 1.5, 1.0), "sphere": V(1.0, 0, 0), "plane": V(0, 0, 0)}[kind]
    return S.Scene(
        name=f"glass_{kind}",
        camera=S.Camera(position=V(0, 0, 6), target=V(0, 0, 0), up=V(0, 1, 0), fov=45.0),
        materials=[S.Material(id="glass", type="dielectric", ior=1.5),
                   S.Material(id="clay", type="lambert", albedo=C(0.5, 0.5, 0.5))],
        objects=[S.Object(id="g", type=kind, position=V(0.1, -0.2, 0.05), size=size, material_id="glass"),
                 S.Object(id="c", type="sphere", position=V(0.3, 0.2, 0.1), size=V(0.4, 0, 0), material_id="clay")],
        sky=S.Sky(type="solid", color=C(0, 0, 0)),
    )


def _jax_rows(a):
    return jnp.asarray(np.asarray(a).reshape(-1, 128))


def _jv(a3):
    return JV3(*(_jax_rows(a3[:, k]) for k in range(3)))


def _tv(a3):
    return TV3(*(torch.from_numpy(np.ascontiguousarray(a3[:, k])) for k in range(3)))


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# lane ops
# ---------------------------------------------------------------------------


def test_cosine_direction_onb_matches_jax():
    rng = np.random.default_rng(31)
    n = _unit(rng.normal(size=(N, 3)))
    n[:16, 0] = np.sign(n[:16, 0]) * 0.95  # the other axis of the frame
    n = _unit(n)
    u1, u2 = rng.random((2, N)).astype(np.float32)
    want = jsampling.cosine_direction_onb(_jv(n), _jax_rows(u1), _jax_rows(u2))
    got = tsampling.cosine_direction_onb(_tv(n), torch.from_numpy(u1), torch.from_numpy(u2))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1), rtol=1e-5, atol=1e-6)


def test_finalize_cpu_contract_matches_jax():
    rng = np.random.default_rng(32)
    accum = (rng.gamma(1.0, 0.6, size=(24, 40, 3)) * 3).astype(np.float32)
    accum[0, :4] = np.array([0.0, 1e-9, 2.99, 50.0])[:, None]  # black, tiny, just below and far above white
    want = np.asarray(jpost.finalize_cpu_contract(jnp.asarray(accum), jnp.asarray(3)))
    got = tpost.finalize_cpu_contract(torch.from_numpy(accum), 3).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def _glass_rays(kind, rng):
    """Half the rays start on the glass object's surface and point into it,
    as the refracted rays that the exit scan serves do; the other half start
    anywhere near it."""
    c = np.array([0.1, -0.2, 0.05])
    o = rng.uniform(-1.2, 1.2, size=(N, 3)) + c
    d = _unit(rng.normal(size=(N, 3)))
    h = N // 2
    if kind == "sphere":
        nrm = _unit(rng.normal(size=(h, 3)))
        o[:h] = c + nrm
        d[:h] = np.where((d[:h] * nrm).sum(1, keepdims=True) > 0, -d[:h], d[:h])
    elif kind == "box":
        half = np.array([1.0, 0.75, 0.5])
        axis, sign = rng.integers(0, 3, h), rng.choice([-1.0, 1.0], h)
        o[:h] = c + rng.uniform(-1, 1, size=(h, 3)) * half
        o[np.arange(h), axis] = c[axis] + sign * half[axis]
        inward = -sign * np.abs(d[np.arange(h), axis])
        d[np.arange(h), axis] = inward
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", ["box", "sphere", "plane"])
def test_dielectric_exit_scan_matches_jax(kind):
    """found and the exit point against eager JAX (measured: bit-equal on
    every ray).  Rays that find an exit: sphere 64%, plane 22%, box 2%: the
    scan takes a box's entry distance, which for a ray starting on or in the
    box is t_min, and keeps it only where rounding puts the squared distance
    above 1e-8, in both packages alike."""
    rng = np.random.default_rng({"box": 41, "sphere": 42, "plane": 43}[kind])
    o, d = _glass_rays(kind, rng)
    jp = jsoa.pack_scene(_glass_scene(JS, kind), 16, 16)
    tp = tsoa.pack_scene(_glass_scene(TS, kind), 16, 16, device="cpu")
    with jax.disable_jit():
        jf, jx = JI._dielectric_exit_scan(_jv(o), _jv(d), jp)
    tf, tx = TI._dielectric_exit_scan(_tv(o), _tv(d), tp)
    jf = np.asarray(jf).reshape(-1)
    print(f"exit scan {kind}: {jf.mean():.4%} of rays find an exit")
    assert np.array_equal(tf.numpy(), jf) and jf.any() and not jf.all(), jf.mean()
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a.numpy()[jf], np.asarray(b).reshape(-1)[jf], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# trace() and trace_grid
# ---------------------------------------------------------------------------


def _trace_case(case):
    """(scene builder, contract, faithful fog, rays and states, active mask or None)."""
    rng = np.random.default_rng({"cpu": 51, "gpu": 52, "gpu_fog_active": 53}[case])
    state = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    if case == "gpu_fog_active":
        o = np.tile(np.array([0.0, 1.6, 6.0], np.float32), (N, 1))
        d = _unit(np.stack([rng.uniform(-0.5, 0.5, N), rng.uniform(-0.45, 0.1, N), -np.ones(N)], axis=1))
        active = rng.random(N) < 0.8
        return (lambda S: _fog_scene(S)), "gpu", True, o, d, state, active
    # from inside the Cornell box, every direction
    o = (rng.uniform(-3.0, 3.0, size=(N, 3)) + np.array([0.0, 2.5, 0.0])).astype(np.float32)
    d = _unit(rng.normal(size=(N, 3)))
    return (lambda S: (JB if S is JS else TB).demo_cornell()), case, False, o, d, state, None


@pytest.fixture(scope="module")
def jax_traces():
    cache = {}

    def get(case):
        if case not in cache:
            scene, contract, faithful, o, d, state, active = _trace_case(case)
            sc = scene(JS)
            jp = jsoa.pack_scene(sc, 64, 64)
            cfg = JI.trace_config_for_scene(jp, sc, CDEPTH - 1, contract, faithful_fog=faithful)
            if active is None:
                rad, st, segs = jax.jit(lambda p, a, b, s: JI.trace(a, b, s, p, cfg))(
                    jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(state))
                rad = np.asarray(rad)
            else:
                rad, st, segs = jax.jit(lambda p, a, b, s, m: JI.trace_grid(a, b, s, p, cfg, m))(
                    jp, _jv(o), _jv(d), _jax_rows(state), _jax_rows(active))
                rad = np.stack([np.asarray(c).reshape(-1) for c in rad], axis=-1)
            cache[case] = (rad, np.asarray(st).reshape(-1).astype(np.int64), int(segs))
        return cache[case]

    return get


@pytest.mark.parametrize("case", ["cpu", "gpu", "gpu_fog_active"])
def test_trace_matches_jax(jax_traces, case):
    """Measured: cpu 100.0%, gpu 99.8%, gpu with the fog march and 20% of the
    lanes inactive 100.0% of lanes in the band; segments and every returned
    state equal."""
    jrad, jst, jsegs = jax_traces(case)
    scene, contract, faithful, o, d, state, active = _trace_case(case)
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, 64, 64, device="cpu")
    cfg = TI.trace_config_for_scene(tp, sc, CDEPTH - 1, contract, faithful_fog=faithful)
    assert cfg.contract == contract and (cfg.enable_fog_march and cfg.fog_in_trace) == faithful
    st_in = torch.from_numpy(state.astype(np.int64))
    plain = cuda_trace.TRACE_PLAIN_CALLS
    if active is None:
        rad, st, segs = TI.trace(torch.from_numpy(o), torch.from_numpy(d), st_in, tp, cfg)
        rad = rad.numpy()
    else:
        rad, st, segs = TI.trace_grid(_tv(o), _tv(d), st_in, tp, cfg, torch.from_numpy(active))
        rad = rad.to_rows().numpy()
        assert not rad[~active].any()
    assert cuda_trace.TRACE_PLAIN_CALLS == plain + 1
    assert np.isfinite(rad).all() and rad.shape == (N, 3)
    ok = (np.abs(rad - jrad) <= 1e-3 * np.abs(jrad) + 1e-3).all(axis=-1)
    print(f"trace {case}: {ok.mean():.4%} of lanes in the band, segments {int(segs)} vs {jsegs}")
    assert ok.mean() >= 0.95
    assert int(segs) == jsegs
    assert st.dtype == torch.int64 and np.array_equal(st.numpy(), jst)


# ---------------------------------------------------------------------------
# the classic pass body and the Renderer
# ---------------------------------------------------------------------------


def _classic(name):
    """(scene builder, contract, faithful fog, w, h, spp, depth, seed, n_strata, samples, record key)."""
    if name == "cpu":
        return (lambda S: (JB if S is JS else TB).demo_cornell()), "cpu", False, CW, CH, CSPP, CDEPTH, CSEED, 1, 1, CPU_KEY
    return _fog_scene, "gpu", True, FW, FH, FSPP, FDEPTH, FSEED, 4, 16, FOG_KEY


@pytest.fixture(scope="module")
def jax_passes():
    """The JAX Renderer's program for each image (``render._render_pass_chunk``
    at the Renderer's arguments, one chunk), compiled once and run on its
    first pass."""
    cache = {}

    def get(name):
        if name not in cache:
            scene, contract, faithful, w, h, _spp, depth, seed, n_strata, samples, _key = _classic(name)
            sc = scene(JS)
            jp = jsoa.pack_scene(sc, w, h)
            tcfg = JI.trace_config_for_scene(jp, sc, depth, contract, faithful_fog=faithful)
            assert not JI.regen_enabled(tcfg)
            accum, segs = JR._render_pass_chunk(
                jnp.zeros((w * h, 3), jnp.float32), jp, jnp.uint32(seed), jnp.int32(0), tcfg=tcfg, width=w,
                height=h, n_strata=n_strata, samples=samples, has_aperture=sc.camera.aperture > 0, chunk=w * h,
                normalize_pass=False, n_passes=1)
            cache[name] = (np.asarray(accum), int(segs))
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["cpu", "faithful_fog"])
def test_pass_body_classic_matches_jax(jax_passes, name):
    """Measured: cpu contract 100.0%, faithful fog 99.7% of lanes in the
    band, segments equal."""
    jc, js = jax_passes(name)
    scene, contract, faithful, w, h, _spp, depth, seed, n_strata, samples, _key = _classic(name)
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, w, h, device="cpu")
    tcfg = TI.trace_config_for_scene(tp, sc, depth, contract, faithful_fog=faithful)
    assert not TI.regen_enabled(tcfg)
    idx = torch.arange(w * h, dtype=torch.int32)
    col, segs = TR.pass_body_grid(
        tp, seed, idx % w, idx // w, tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
        has_aperture=sc.camera.aperture > 0, normalize_pass=False)
    tc = col.to_rows().numpy()
    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    print(f"classic pass body {name}: {ok.mean():.4%} of lanes in the band, segments {int(segs)} vs {js}")
    assert ok.mean() >= 0.95
    assert abs(int(segs) - js) <= 0.02 * js
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj) + 1e-6), (mt, mj)


PAD_CHUNK = 230  # about 0.6 of the faithful-fog frame's 384 lanes: two chunks, the second padded by 76 lanes


def test_renderer_traces_the_padded_last_chunk(monkeypatch):
    """The Renderer traces its last chunk at the full ``chunk`` lanes, as the
    JAX Renderer does (``n_chunks * chunk`` lanes; the lanes past w*h are
    off-frame pixel rows, py >= h, that trace like real ones): the
    faithful-fog frame in two chunks of 230 lanes, the second padded by 76.
    ``ray_segments`` equal the JAX Renderer's, and the second chunk's lanes,
    its real pixels and its padding, are in the pass-body band against the
    program that the JAX Renderer runs for that chunk.  Under faithful fog
    the padding lanes take part in the chunk's longest path, whose trips
    advance every lane's state between samples, so a Renderer that traced
    only the 154 real lanes of that chunk counts fewer segments and can draw
    other samples for its pixels.  Measured (x86-64): segments equal (12,650),
    100% of the second chunk's lanes in the band; a Renderer that stopped
    the chunk at w*h counted 10,196 segments (its pixels stayed in the band
    here: depth 4 bounds the longest path either way)."""
    scene, contract, faithful, w, h, spp, depth, seed, n_strata, samples, _key = _classic("faithful_fog")
    chunk = PAD_CHUNK
    assert w * h < 2 * chunk
    sc = scene(JS)
    jp = jsoa.pack_scene(sc, w, h)
    tcfg = JI.trace_config_for_scene(jp, sc, depth, contract, faithful_fog=faithful)
    accum, jsegs = jnp.zeros((2 * chunk, 3), jnp.float32), 0
    for c in range(2):
        accum, segs = JR._render_pass_chunk(
            accum, jp, jnp.uint32(seed), jnp.int32(c * chunk), tcfg=tcfg, width=w, height=h, n_strata=n_strata,
            samples=samples, has_aperture=sc.camera.aperture > 0, chunk=chunk, normalize_pass=False, n_passes=1)
        jsegs += int(segs)
    jc = np.asarray(accum)
    jr = jpt.Renderer(contract=contract, seed=seed, chunk=chunk, faithful_fog=faithful)
    jr.render(sc, jpt.RenderConfig(w, h, spp, depth))
    assert jr.stats.ray_segments == jsegs

    seen = []
    traced = TR.trace_pass_lanes

    def spy(pack, frame_seed, idx, **kw):
        col, segs = traced(pack, frame_seed, idx, **kw)
        seen.append((idx.tolist(), col.numpy().copy(), int(segs)))
        return col, segs

    monkeypatch.setattr(TR, "trace_pass_lanes", spy)
    r = tpt.Renderer(contract=contract, seed=seed, chunk=chunk, faithful_fog=faithful, device="cpu")
    img = r.render(scene(TS), tpt.RenderConfig(w, h, spp, depth))
    assert img.shape == (h, w, 3) and r.stats.nonfinite == 0
    assert [s[0] for s in seen] == [list(range(0, chunk)), list(range(chunk, 2 * chunk))]
    tc = seen[1][1]
    ok = (np.abs(tc - jc[chunk:]) <= 1e-3 * np.abs(jc[chunk:]) + 1e-3).all(axis=-1)
    print(f"padded last chunk: {ok.mean():.4%} of its lanes in the band ({ok[:w * h - chunk].mean():.4%} of "
          f"its pixels), segments {r.stats.ray_segments} vs {jr.stats.ray_segments}")
    assert r.stats.ray_segments == jr.stats.ray_segments == sum(s[2] for s in seen)
    assert ok[:w * h - chunk].mean() >= 0.95 and ok.mean() >= 0.95


WIN_W, WIN_H, WIN_PASSES, WIN_DEPTH = 8, 6, 60, 3  # 60 passes: progress every 3rd (passes // 20)


def _window_run(monkeypatch, window, cancel_after=None):
    """A cpu-contract render of WIN_PASSES passes with ``PATHTRACER_PASS_WINDOW``
    at ``window`` and two chunks, the second padded: the passes at which
    ``progress`` came, the accumulator it saw each time, the segments and the
    passes done."""
    monkeypatch.setenv("PATHTRACER_PASS_WINDOW", str(window))
    seen, calls = [], []
    monkeypatch.setattr(TR, "finalize_cpu_contract", lambda flat, count: (
        seen.append((count, flat.clone())), tpost.finalize_cpu_contract(flat, count))[1])
    cancel = None
    if cancel_after is not None:
        cancel = lambda: (calls.append(1), len(calls) >= cancel_after)[1]  # noqa: E731
    r = tpt.Renderer(contract="cpu", seed=CSEED, chunk=30, device="cpu")
    progress = []
    img = r.render(TB.demo_cornell(), tpt.RenderConfig(WIN_W, WIN_H, WIN_PASSES, WIN_DEPTH),
                   progress=lambda p, im: progress.append(p), cancel=cancel)
    return progress, seen, r.stats, img


def test_cpu_contract_window_equals_pass_by_pass(monkeypatch):
    """The cpu contract's pass window (PATHTRACER_PASS_WINDOW 2, which the
    progress cadence splits, and 8, which it cuts) against one pass a
    window, bit for bit: the accumulator at every progress call and at the
    end, the segments, the passes at which ``progress`` is called (every
    3rd: a window ends there) and the pass at which ``cancel`` stops (a
    cancel callback keeps the window at one pass, as the JAX Renderer
    checks it after every classic pass)."""
    want = _window_run(monkeypatch, 1)
    assert want[0] == list(range(3, WIN_PASSES + 1, 3)) and want[2].passes == WIN_PASSES
    for window in (2, 8):
        got = _window_run(monkeypatch, window)
        assert got[0] == want[0]
        assert [c for c, _a in got[1]] == [c for c, _a in want[1]]
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for (_c, a), (_d, b) in zip(got[1], want[1]))
        assert got[2].ray_segments == want[2].ray_segments and np.array_equal(got[3], want[3])
    stop = _window_run(monkeypatch, 1, cancel_after=7)
    got = _window_run(monkeypatch, 8, cancel_after=7)
    assert got[2].passes == stop[2].passes == 7 and got[0] == stop[0] == [3, 6]
    assert got[2].ray_segments == stop[2].ray_segments and np.array_equal(got[3], stop[3])


def test_classic_render_plain_equals_chunk_by_chunk():
    """The all-chunks entry of the classic instance (``classic_render``,
    here its plain version on CPU tensors) equals chunk-by-chunk
    ``pass_body_grid`` calls bit for bit under faithful fog: 3 chunks of the
    fog scene's 384 lanes, the last padded to 150 lanes by off-frame rows,
    added into a non-zero accumulator; segments equal."""
    scene, contract, faithful, w, h, _spp, depth, seed, n_strata, samples, _key = _classic("faithful_fog")
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, w, h, device="cpu")
    tcfg = TI.trace_config_for_scene(tp, sc, depth, contract, faithful_fog=faithful)
    chunk = 150
    idx = torch.arange(3 * chunk, dtype=torch.int32)
    assert 2 * chunk < w * h < 3 * chunk
    px, py = idx % w, idx // w
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False)
    start = torch.from_numpy(np.random.default_rng(61).random((3 * chunk, 3)).astype(np.float32))
    want, want_segs = start.clone(), 0
    for c0 in range(0, 3 * chunk, chunk):
        col, segs = TR.pass_body_grid(tp, seed, px[c0:c0 + chunk], py[c0:c0 + chunk], **kw)
        want[c0:c0 + chunk] += col.to_rows()
        want_segs += int(segs)
    got, whole = start.clone(), start.clone()
    plain = cuda_trace.PLAIN_CALLS
    segs = cuda_trace.classic_render(got, tp, seed, px, py, chunk=chunk, **kw)
    assert cuda_trace.PLAIN_CALLS == plain + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) and int(segs) == want_segs
    # the chunks' longest paths matter here: the lanes as one chunk draw other samples on most lanes
    cuda_trace.classic_render(whole, tp, seed, px, py, chunk=3 * chunk, **kw)
    assert (whole != want).any(dim=-1).double().mean() > 0.5


def test_classic_split_arithmetic():
    """The classic instance's split follows from the counting build's
    tallies of a frame's launches (two launches merged as one call's):
    stage shares of all cycles, the segments the warps ran for, the launch
    tail, hash rounds a segment and the bound in FFMA slots."""
    launch = dict(segments=10, ops=2000, walk_ops=0, walk_cycles=0, cycles=1000, fog_cycles=100, isect_cycles=200,
                  nee_cycles=150, lite_cycles=50, loop_cycles=700, nee_active=48, nee_entries=3, warp_tail_cycles=40,
                  rng_rounds=200, first_start_ns=0, first_end_ns=80, last_end_ns=100, last_start_ns=10,
                  advance_cycles=50, camera_cycles=70, warp_segments=40)
    merged = cuda_trace._merge_counts([launch, launch])
    assert merged["launches"] == 2 and merged["launch_span_ns"] == 200 and merged["cycles"] == 2000
    sp = cuda_trace.classic_split([merged, launch])
    assert sp["launches"] == 3 and sp["share_advance"] == pytest.approx(0.05)
    assert sp["share_rest"] == pytest.approx((700 - 200 - 150 - 50 - 40) / 1000)
    assert sp["share_outside"] == pytest.approx((1000 - 50 - 70 - 100 - 700) / 1000)
    assert sp["simt"] == 0.25 and sp["launch_tail_share"] == pytest.approx(0.2)
    assert sp["rng_rounds_per_segment"] == 20 and sp["bound_slots_ms"] == pytest.approx(
        (6000 + 16 * 600) / cuda_trace.UNFUSED_SLOTS * 1e3)
    assert "warps ran for 25.00%" in cuda_trace.classic_split_line(sp)


def test_trace_split_arithmetic():
    """B3's split follows from the counting build's tallies of its launches
    (the march launch merged with the bounces'): the stages' shares of the
    lane time (the threads' cycles and the warp tail that follows their
    last ray), and the state advance's hash rounds apart from the trace's."""
    common = dict(segments=0, ops=1000, walk_ops=0, walk_cycles=0, fog_cycles=0, isect_cycles=0, nee_cycles=0,
                  lite_cycles=0, loop_cycles=0, nee_active=0, nee_entries=0, warp_tail_cycles=0, advance_cycles=0,
                  camera_cycles=0, warp_segments=0, first_start_ns=0, first_end_ns=50, last_end_ns=100,
                  last_start_ns=20)
    march = dict(common, cycles=1000, fog_cycles=800, rng_rounds=100, advance_rounds=0)
    bounce = dict(common, segments=20, cycles=1000, isect_cycles=300, nee_cycles=100, loop_cycles=900,
                  warp_tail_cycles=200, warp_segments=40, rng_rounds=400, advance_rounds=300)
    sp = cuda_trace.trace_split([cuda_trace._merge_counts([bounce, march])])
    lane = 2000 + 200  # the threads' cycles and their wait for the warp after the last ray
    assert sp["launches"] == 2 and sp["share_march"] == pytest.approx(800 / lane)
    assert sp["share_isect"] == pytest.approx(300 / lane) and sp["share_warp_tail"] == pytest.approx(200 / lane)
    assert sp["share_rest"] == pytest.approx((900 - 300 - 100) / lane)
    assert sp["share_outside"] == pytest.approx((2000 - 800 - 900) / lane)
    assert sp["simt"] == 0.5 and sp["launch_tail_share"] == pytest.approx(0.5)
    assert sp["rng_rounds_advance"] == 300 and sp["rng_rounds_trace"] == 200 and sp["advance_round_share"] == 0.6
    assert "in the state advance (60.00%)" in cuda_trace.trace_split_line(sp)


def test_trace_counter_slots_match_classic_cu():
    """B3's counters name the slots that csrc/common.cuh and csrc/classic.cu
    write: the state advance's hash rounds in ADVANCE_ROUNDS besides the
    total (slot 13), and the paged bounces' ray cursor after it, the walk's
    sweep counts last."""
    csrc = Path(cuda_trace.__file__).resolve().parent.parent / "csrc"
    common, classic = (csrc / "common.cuh").read_text(), (csrc / "classic.cu").read_text()
    n = cuda_trace.N_COUNTERS
    assert f"N_COUNTERS = {n}, CURSOR = 35, ADVANCE_ROUNDS = 34, SWEEP_COUNTS = {n - 6};" in common
    assert "atomicAdd(counters + 13, rounds);" in classic and "atomicAdd(counters + ADVANCE_ROUNDS, rounds);" in classic
    assert "lane = PAGED ? (int)atomicAdd(counters + CURSOR, 1ull)" in classic
    c = cuda_trace._count_dict(torch.arange(n, dtype=torch.int64))
    assert c["advance_rounds"] == 34 and c["rng_rounds"] == 13 and c["march_tail_cycles"] == 33


def test_trace_reads_rays_in_place():
    """B3's wrapper hands the kernel the rays where they lie: the columns of
    trace()'s [N, 3] rows as views of stride 3, contiguous planes at stride
    1, and copies only where the components' strides differ."""
    rows = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    cols, stride = cuda_trace._components(TV3(rows[:, 0], rows[:, 1], rows[:, 2]), 10)
    assert stride == 3 and [c.data_ptr() for c in cols] == [rows.data_ptr() + 4 * k for k in range(3)]
    planes = TV3(*(torch.rand(2, 5) for _ in range(3)))
    cols, stride = cuda_trace._components(planes, 10)
    assert stride == 1 and cols[1].data_ptr() == planes.y.data_ptr()
    mixed, stride = cuda_trace._components(TV3(rows[:, 0], planes.y.reshape(-1), rows[:, 2]), 10)
    assert stride == 1 and all(c.is_contiguous() for c in mixed) and torch.equal(mixed[2], rows[:, 2])
    one, stride = cuda_trace._components(TV3(rows[:1, 0], rows[:1, 1], rows[:1, 2]), 1)
    assert stride == 1 and float(one[2]) == 2.0


def test_trace_rows_equal_trace_grid():
    """trace() returns trace_grid's radiance as rows and its state and
    segments as they are (the plain version on the CPU; on a card the
    kernel writes the rows itself)."""
    scene, contract, faithful, o, d, state, active = _trace_case("cpu")
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, 64, 64, device="cpu")
    cfg = TI.trace_config_for_scene(tp, sc, 6, contract, faithful_fog=faithful)
    st = torch.from_numpy(state.astype(np.int64))
    rows, st_r, seg_r = TI.trace(torch.from_numpy(o), torch.from_numpy(d), st, tp, cfg)
    rad, st_g, seg_g = TI.trace_grid(_tv(o), _tv(d), st, tp, cfg)
    assert rows.shape == (N, 3) and torch.equal(rows, rad.to_rows())
    assert torch.equal(st_r, st_g) and int(seg_r) == int(seg_g) > 0


def _stats(img):
    f = np.asarray(img).astype(np.float64)
    return {"mean": [round(float(x), 4) for x in f.mean(axis=(0, 1))],
            "std": [round(float(x), 4) for x in f.std(axis=(0, 1))]}


def _in_bands(img, key):
    want = json.load(open(RECORD))[key]
    got = _stats(img)
    for ch in range(3):
        assert got["mean"][ch] == pytest.approx(want["mean"][ch], rel=0.015, abs=1.0), (key, got)
        assert got["std"][ch] == pytest.approx(want["std"][ch], rel=0.06, abs=1.5), (key, got)


@pytest.mark.parametrize("name", ["cpu", "faithful_fog"])
def test_jax_renderer_classic_record(jax_passes, name):
    """The JAX Renderer's image, whose statistics the port's Renderer is held
    to, still has the recorded statistics (abs 0.1 of a u8 level).
    PATHTRACER_RECORD_GOLDENS=1 rewrites the record."""
    jax_passes(name)  # the compiled program the Renderer reuses
    scene, contract, faithful, w, h, spp, depth, seed, _ns, _s, key = _classic(name)
    img = jpt.Renderer(contract=contract, seed=seed, chunk=w * h, faithful_fog=faithful).render(
        scene(JS), jpt.RenderConfig(w, h, spp, depth))
    got = _stats(img)
    if os.environ.get("PATHTRACER_RECORD_GOLDENS", "") in ("1", "true", "on"):
        record = json.load(open(RECORD)) if os.path.exists(RECORD) else {}
        record[key] = got
        with open(RECORD, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    want = json.load(open(RECORD))[key]
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], atol=0.1, rtol=0, err_msg=f"{k}: {got}")


def test_renderer_cpu_contract_within_golden_bands():
    r = tpt.Renderer(contract="cpu", seed=CSEED, device="cpu")
    img = r.render(TB.demo_cornell(), tpt.RenderConfig(CW, CH, CSPP, CDEPTH))
    assert img.shape == (CH, CW, 3) and img.dtype == np.uint8
    assert r.stats.passes == CSPP and r.stats.samples_per_pixel == CSPP and r.stats.nonfinite == 0
    _in_bands(img, CPU_KEY)


def test_default_renderer_is_the_cpu_contract(monkeypatch):
    """Renderer() follows the backend switch, whose default is the cpu
    contract, like the JAX package's; progress comes every 5% of passes."""
    monkeypatch.setattr(TR, "_backend", TR.BACKEND_CPU)
    assert tpt.get_backend() == "cpu"
    seen = []
    img = tpt.Renderer(seed=CSEED, device="cpu").render(
        TB.demo_cornell(), tpt.RenderConfig(CW, CH, CSPP, CDEPTH), progress=lambda p, im: seen.append(p))
    assert seen == [1, 2, 3, 4]
    assert np.array_equal(img, tpt.Renderer(contract="cpu", seed=CSEED, device="cpu").render(
        TB.demo_cornell(), tpt.RenderConfig(CW, CH, CSPP, CDEPTH)))
    _in_bands(img, CPU_KEY)
    tpt.set_backend("gpu")
    assert tpt.get_backend() == "gpu"
    with pytest.raises(ValueError):
        tpt.set_backend("tpu")
    with pytest.raises(ValueError):
        tpt.Renderer(contract="tpu", device="cpu").render(TB.demo_cornell(), tpt.RenderConfig(4, 4, 1, 2))


def test_renderer_faithful_fog_within_golden_bands():
    r = tpt.Renderer(contract="gpu", seed=FSEED, faithful_fog=True, device="cpu")
    img = r.render(_fog_scene(TS), tpt.RenderConfig(FW, FH, FSPP, FDEPTH))
    assert r.stats.passes == FSPP and r.stats.samples_per_pixel == 16 * FSPP and r.stats.nonfinite == 0
    _in_bands(img, FOG_KEY)


# ---------------------------------------------------------------------------
# on a card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cpu", "gpu", "gpu_fog_active"])
def test_trace_grid_kernel_bit_equal_to_plain_on_card(case):
    _card()
    scene, contract, faithful, o, d, state, active = _trace_case(case)
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, 64, 64, device="cuda")
    cfg = TI.trace_config_for_scene(tp, sc, 12, contract, faithful_fog=faithful)
    ov, dv = (TV3(*(c.cuda() for c in v)) for v in (_tv(o), _tv(d)))
    st = torch.from_numpy(state.astype(np.int64)).cuda()
    act = None if active is None else torch.from_numpy(active).cuda()
    launches = cuda_trace.TRACE_LAUNCHES
    rk, sk, gk = cuda_trace.trace_grid(ov, dv, st, tp, cfg, act)
    assert cuda_trace.TRACE_LAUNCHES == launches + 1
    rp, sp, gp = cuda_trace.trace_grid_plain(ov, dv, st, tp, cfg, act)
    torch.cuda.synchronize()
    assert torch.equal(rk.to_rows(), rp.to_rows()) and torch.equal(sk, sp) and int(gk) == int(gp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cpu", "faithful_fog"])
def test_classic_kernel_matches_plain_on_card(name):
    _card()
    scene, contract, faithful, w, h, _spp, depth, seed, n_strata, samples, _key = _classic(name)
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(tp, sc, depth, contract, faithful_fog=faithful)
    idx = torch.arange(w * h, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False)
    # one launch of the window kernel a window of passes (cpu contract), or of the sample kernel a sample,
    # each after one of the march kernel (faithful fog)
    per_pass = 1 if samples == 1 else samples
    launches, marches = cuda_trace.CLASSIC_LAUNCHES, cuda_trace.MARCH_LAUNCHES
    ck, sk = cuda_trace.render_pass(tp, seed, idx % w, idx // w, **kw)
    assert cuda_trace.CLASSIC_LAUNCHES == launches + per_pass
    assert cuda_trace.MARCH_LAUNCHES == marches + (0 if samples == 1 else samples)
    cp, spl = cuda_trace.render_pass_plain(tp, seed, idx % w, idx // w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ck.to_rows(), cp.to_rows()) and int(sk) == int(spl)
    launches = cuda_trace.CLASSIC_LAUNCHES
    img = TR.Renderer(contract=contract, faithful_fog=faithful, seed=seed).render(sc, TR.RenderConfig(w, h, 2, depth))
    assert img.shape == (h, w, 3) and cuda_trace.CLASSIC_LAUNCHES == launches + (1 if samples == 1 else 2 * per_pass)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cpu", "faithful_fog"])
def test_classic_render_bit_equal_to_plain_on_card(name):
    """The classic instance as the Renderer launches it on the card against
    its plain version (``pass_body_grid`` pass by pass and chunk by chunk):
    all of a frame's lanes in chunks, the last padded by off-frame rows,
    added into a non-zero accumulator; the cpu contract in 3 chunks as one
    window of 3 passes in one launch of persistent blocks, faithful fog in
    11 chunks of 37 lanes, one launch of the sample kernel a sample over all
    chunks (after one of the march kernel).  Accumulator bit for bit,
    segments equal."""
    _card()
    scene, contract, faithful, w, h, _spp, depth, seed, n_strata, samples, _key = _classic(name)
    sc = scene(TS)
    tp = tsoa.pack_scene(sc, w, h, device="cuda")
    tcfg = TI.trace_config_for_scene(tp, sc, depth, contract, faithful_fog=faithful)
    # faithful fog in chunks of 37 lanes, so that warps straddle chunks whose longest paths differ
    n_chunks = 3 if samples == 1 else 11
    chunk = -(-w * h // n_chunks) + (5 if samples == 1 else 2)
    assert (n_chunks - 1) * chunk < w * h < n_chunks * chunk
    idx = torch.arange(n_chunks * chunk, dtype=torch.int32, device="cuda")
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=n_strata, samples=samples,
              has_aperture=sc.camera.aperture > 0, normalize_pass=False)
    n_passes = 3 if samples == 1 else 1
    start = torch.from_numpy(np.random.default_rng(62).random((n_chunks * chunk, 3)).astype(np.float32)).cuda()
    got, want = start.clone(), start.clone()
    launches = cuda_trace.CLASSIC_LAUNCHES
    sk = cuda_trace.classic_render(got, tp, seed, idx % w, idx // w, chunk=chunk, n_passes=n_passes, **kw)
    assert cuda_trace.CLASSIC_LAUNCHES == launches + (1 if samples == 1 else samples)
    sp = cuda_trace.classic_render_plain(want, tp, seed, idx % w, idx // w, chunk=chunk, n_passes=n_passes, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) and int(sk) == int(sp)
