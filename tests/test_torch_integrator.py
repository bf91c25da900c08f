"""Parity of the port's gpu-contract integrator with the JAX package.

Both packages run on the CPU with the same inputs; the JAX side takes its
XLA path (``pallas_supported`` is False on the CPU).  Depth 4, 16
stratified samples per pass.

* demo_cornell: 256 pixel lanes of a 64x36 frame (chosen with numpy from a
  seed), one pass and a 2-pass window.  The scene has no fog, so the JAX
  whole-pass body (``render.pass_body_grid``) is exactly
  ``integrator.pass_regen_gpu`` and serves the tests of both.
* demo_showcase: every lane of a 32x16 frame, one 2-pass window at frame
  seed 3.  The JAX program is ``render._render_pass_chunk`` as the JAX
  Renderer compiles it for that image (spp 2, chunk 256 lanes), so one XLA
  compile of the showcase pass body (about 2 minutes on one core) serves
  every showcase test here and the JAX Renderer's image.  That image's
  statistics are recorded in tests/torch_goldens.json; test_torch_render
  holds the port's Renderer to the record, and
  test_jax_renderer_showcase_record holds the record to the JAX Renderer.
  With the fog block's gpu_volumetric slot cleared, the fog term is gated
  to zero and the body returns exactly ``pass_regen_gpu``.

Tolerances: >= 95% of lanes within |a-b| <= 1e-3|b| + 1e-3 on all three
channels, segments within 2%, per-channel means within 1%.  Lanes outside
the band are branch flips from last-bit differences: XLA's and PyTorch's
exp/log/sqrt/sin round differently, and XLA's CPU backend always allows
FMA fusion under jit while PyTorch rounds every multiply and add.  Measured
on an x86-64 CPU: demo_cornell 97.7% / 95.3% of lanes (1 pass / 2-pass
window, 16 / 32 samples per lane, segments equal); demo_showcase 98.8%
with the fog gated off or its noise off.

demo_showcase's fog noise (``fog.hash31``, fract(sin(q) * 43758.5453) with
|q| ~ 6e3) is chaotic in the last bit of q.  Under jax.jit, XLA's CPU
backend fuses q's multiply-adds into FMAs; the port, like JAX run op by op,
rounds each once.  tests/test_torch_ops.py::test_hash31_fma_witness shows
it on fog-march positions: jitted JAX takes the fused value on 27% of
them, the port never, and each agrees with a numpy float32 evaluation of
its own rounding.  Most fogged lanes then land ~0.5% apart (measured:
69% of lanes in the band, segments equal, channel means 0.02% apart).
So that scene is held to the lane band with the noise's strength set to 0
in the fog block (the march, the volume lights and the phase function
still run), and to the segment and mean bands as it is.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_trace_golang_tpu as jpt
from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import soa as jsoa
from path_trace_golang_tpu.scene import builtin as JB

from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.ops import rng as trng
from path_trace_golang_tpu_torch.scene import builtin as TB

DEPTH = 4
# demo_cornell: 256 lanes of a 64x36 frame
W, H, SEED = 64, 36, 7
LANES = np.random.default_rng(11).choice(W * H, 256, replace=False).astype(np.int32)
# demo_showcase: the JAX Renderer's image of tests/test_torch_render.py
SW, SH, SSEED, SPASSES, SCHUNK = 32, 16, 3, 2, 256
SLANES = np.arange(SW * SH, dtype=np.int32)
FOG_HETERO, FOG_VOLUMETRIC = 11, 3  # fog block slots (soa.py)
RECORD = os.path.join(os.path.dirname(__file__), "torch_goldens.json")
RECORD_KEY = f"demo_showcase:gpu:{SW}x{SH}:spp{SPASSES}:d{DEPTH}:seed{SSEED}"


def _kw(sc, w, h, n_passes):
    return dict(width=w, height=h, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0, n_passes=n_passes)


def _jax_lanes():
    return jnp.asarray((LANES % W).reshape(2, 128)), jnp.asarray((LANES // W).reshape(2, 128))


def _torch_lanes(lanes, w):
    return torch.from_numpy(lanes % w), torch.from_numpy(lanes // w)


def _rows(col):
    return np.stack([np.asarray(c).reshape(-1) for c in col], axis=-1)


def _with_fog(pack, slot, value):
    """The pack with one fog-block slot replaced (JAX pack: a new array)."""
    import dataclasses

    fog = np.asarray(pack.fog).copy()
    fog[slot] = value
    return dataclasses.replace(pack, fog=jnp.asarray(fog))


def _torch_pack(name, w, h, fog_edits=()):
    pack = tsoa.pack_scene(getattr(TB, name)(), w, h, device="cpu")
    for slot, value in fog_edits:
        pack.fog[slot] = value
    return pack


class _Ref:
    """JAX references, each computed once per module."""

    def __init__(self):
        self.cache = {}

    def cornell(self, n_passes):
        key = ("cornell", n_passes)
        if key not in self.cache:
            sc = JB.demo_cornell()
            jp = jsoa.pack_scene(sc, W, H)
            tcfg = JI.trace_config_for_scene(jp, sc, DEPTH, "gpu")
            assert not tcfg.enable_fog_march  # the body is then pass_regen_gpu alone
            fn = jax.jit(lambda pack, px, py: JR.pass_body_grid(
                pack, jnp.uint32(SEED), px, py, tcfg=tcfg, trace_fn=None,
                normalize_pass=False, **_kw(sc, W, H, n_passes)))
            col, segs = fn(jp, *_jax_lanes())
            self.cache[key] = (_rows(col), int(segs))
        return self.cache[key]

    def showcase(self, fog_edits=()):
        """Every lane of the showcase image through the JAX Renderer's program."""
        key = ("showcase", fog_edits)
        if key not in self.cache:
            sc = JB.demo_showcase()
            jp = jsoa.pack_scene(sc, SW, SH)
            for slot, value in fog_edits:
                jp = _with_fog(jp, slot, value)
            tcfg = JI.trace_config_for_scene(jp, sc, DEPTH, "gpu")
            kw = _kw(sc, SW, SH, SPASSES)
            accum, segs = jnp.zeros((SW * SH, 3), jnp.float32), 0
            for start in range(0, SW * SH, SCHUNK):
                accum, s = JR._render_pass_chunk(
                    accum, jp, jnp.uint32(SSEED), jnp.int32(start), tcfg=tcfg, chunk=SCHUNK,
                    normalize_pass=False, **kw)
                segs += int(s)
            self.cache[key] = (np.asarray(accum), segs)
        return self.cache[key]


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _check(got, want, *, lanes=True):
    (tc, ts), (jc, js) = got, want
    tc = np.asarray(tc)
    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    if lanes:
        assert ok.mean() >= 0.95, f"lanes matching {ok.mean():.4f}"
    assert abs(ts - js) <= 0.02 * js, (ts, js)
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj)), (mt, mj)
    return ok.mean()


def _torch_body(name, w, h, lanes, seed, n_passes, fog_edits=()):
    sc = getattr(TB, name)()
    tp = _torch_pack(name, w, h, fog_edits)
    tcfg = TI.trace_config_for_scene(tp, sc, DEPTH, "gpu")
    col, segs = TR.pass_body_grid(
        tp, seed, *_torch_lanes(lanes, w), tcfg=tcfg, normalize_pass=False, **_kw(sc, w, h, n_passes))
    return col.to_rows().numpy(), int(segs)


def _torch_regen(name, w, h, lanes, seed, n_passes):
    sc = getattr(TB, name)()
    tp = _torch_pack(name, w, h)
    tcfg = TI.trace_config_for_scene(tp, sc, DEPTH, "gpu")
    px, py = _torch_lanes(lanes, w)
    col, _st, segs = TI.pass_regen_gpu(
        tp, px, py, trng.seed_lanes(px, py, seed), cfg=tcfg, frame_seed=seed, **_kw(sc, w, h, n_passes)
    )
    return col.to_rows().numpy(), int(segs)


@pytest.mark.parametrize("n_passes", [1, 2])
def test_pass_regen_gpu_cornell(ref, n_passes):
    _check(_torch_regen("demo_cornell", W, H, LANES, SEED, n_passes), ref.cornell(n_passes))


@pytest.mark.parametrize("n_passes", [1, 2])
def test_pass_body_cornell(ref, n_passes):
    _check(_torch_body("demo_cornell", W, H, LANES, SEED, n_passes), ref.cornell(n_passes))


def test_pass_regen_gpu_showcase(ref):
    # the JAX body with the fog gated off is exactly pass_regen_gpu (module doc)
    want = ref.showcase(fog_edits=((FOG_VOLUMETRIC, 0.0),))
    _check(_torch_regen("demo_showcase", SW, SH, SLANES, SSEED, SPASSES), want)


def test_pass_body_showcase_noise_off(ref):
    edits = ((FOG_HETERO, 0.0),)
    _check(_torch_body("demo_showcase", SW, SH, SLANES, SSEED, SPASSES, edits), ref.showcase(edits))


def test_pass_body_showcase(ref):
    # the fog noise differs between jitted XLA and PyTorch by FMA fusion
    # (module doc): held to the segment and channel-mean bands, lanes reported only
    _check(_torch_body("demo_showcase", SW, SH, SLANES, SSEED, SPASSES), ref.showcase(), lanes=False)


def _image_stats(img):
    f = np.asarray(img).astype(np.float64)
    return {"mean": [round(float(x), 4) for x in f.mean(axis=(0, 1))],
            "std": [round(float(x), 4) for x in f.std(axis=(0, 1))]}


def test_jax_renderer_showcase_record(ref):
    """The JAX Renderer's showcase image, whose statistics test_torch_render
    holds the port's Renderer to, still has the recorded statistics (abs
    0.1 of a u8 level; one pixel's channel moving by one level moves a mean
    by 0.002).  PATHTRACER_RECORD_GOLDENS=1 rewrites the record."""
    ref.showcase()  # the compiled program the Renderer reuses
    img = jpt.Renderer(contract="gpu", seed=SSEED, chunk=SCHUNK).render(
        JB.demo_showcase(), jpt.RenderConfig(SW, SH, SPASSES, DEPTH))
    got = _image_stats(img)
    if os.environ.get("PATHTRACER_RECORD_GOLDENS", "") in ("1", "true", "on"):
        record = json.load(open(RECORD)) if os.path.exists(RECORD) else {}
        record[RECORD_KEY] = got
        with open(RECORD, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
    want = json.load(open(RECORD))[RECORD_KEY]
    for k in ("mean", "std"):
        np.testing.assert_allclose(got[k], want[k], atol=0.1, rtol=0, err_msg=f"{k}: {got}")


@pytest.mark.parametrize("name", ["demo_cornell", "demo_showcase"])
def test_trace_config_flags_match(name):
    jsc, tsc = getattr(JB, name)(), getattr(TB, name)()
    jc = JI.trace_config_for_scene(jsoa.pack_scene(jsc, W, H), jsc, 12, "gpu")
    tc = TI.trace_config_for_scene(_torch_pack(name, W, H), tsc, 12, "gpu")
    for f in ("max_depth", "contract", "enable_fog_march", "fog_in_trace", "enable_nee",
              "has_rough_metal", "has_dielectric", "rr_threshold", "regen"):
        assert getattr(jc, f) == getattr(tc, f), f
    assert TI.regen_enabled(tc) == JI.regen_enabled(jc)
