"""Fuzzed scenes through the PyTorch port against the JAX package.

The four scenes of tests/test_fuzz.py (``random_scene`` at seeds 11, 23,
37 and 59: random materials of all five types, spheres, boxes, sphere
lights, a triangle or a tiny mesh, sky, fog, aperture) reach the port
through the scene JSON: tests/torch_fuzz_scenes.json holds each as the JAX
package's writer (``scene/io.py``) prints it, and the first test holds the
file to ``random_scene``, so that chip_smoke.py can load the same scenes
without the JAX package.

Both packages then render every lane of a 32x24 frame, depth 4, one pass,
under both contracts on the CPU: the gpu contract (16 stratified samples,
the regeneration loop) and the cpu contract (one sample, the classic
loop), the JAX side through the program that its Renderer compiles for the
image (``render._render_pass_chunk``), the port through its plain pass body
(``render.pass_body_grid``).  The fog noise's strength is set to 0 in both
packs: XLA's CPU backend fuses ``fog.hash31``'s multiply-adds under jit and
the port does not (tests/test_torch_ops.py::test_hash31_fma_witness).

Gate (that of tests/test_torch_integrator.py): >= 95% of lanes within
|a-b| <= 1e-3|b| + 1e-3 on all three channels, segments within 2%,
channel means within 1%.  Measured on an x86-64 CPU: 100% of lanes in the
band and segments equal on all eight renders; about a minute for the file,
most of it the JAX compiles.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import scene as JS
from path_trace_golang_tpu import soa as jsoa

from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch import soa as tsoa

from test_fuzz import random_scene

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fuzz_scenes.json")
SEEDS = (11, 23, 37, 59)
W, H, DEPTH, FRAME_SEED = 32, 24, 4, 3
FOG_HETERO = 11  # the fog block's noise-strength slot (soa.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside other test workers on the same cores, PyTorch's splitting of
    the plain loops' lane ops across threads costs more than it saves."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene_text(seed):
    with open(SCENES) as f:
        return json.dumps(json.load(f)["scenes"][str(seed)])


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_scene_json_is_random_scene(seed):
    """The committed JSON is random_scene(seed) through the JAX writer, and
    the port reads it back to the same JSON."""
    text = _scene_text(seed)
    assert json.loads(JS.dumps(random_scene(np.random.RandomState(seed)))) == json.loads(text)
    assert json.loads(TS.dumps(TS.loads(text))) == json.loads(text)


@pytest.mark.parametrize("contract", ["gpu", "cpu"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_scene_matches_jax(seed, contract):
    text = _scene_text(seed)
    jsc, tsc = JS.loads(text), TS.loads(text)
    n_strata, samples = (4, 16) if contract == "gpu" else (1, 1)
    kw = dict(width=W, height=H, n_strata=n_strata, samples=samples, has_aperture=jsc.camera.aperture > 0,
              normalize_pass=False, n_passes=1)

    jp = jsoa.pack_scene(jsc, W, H)
    fog = np.asarray(jp.fog).copy()
    fog[FOG_HETERO] = 0.0
    jp = dataclasses.replace(jp, fog=jnp.asarray(fog))
    tcfg = JI.trace_config_for_scene(jp, jsc, DEPTH, contract)
    accum, js = JR._render_pass_chunk(jnp.zeros((W * H, 3), jnp.float32), jp, jnp.uint32(FRAME_SEED), jnp.int32(0),
                                      tcfg=tcfg, chunk=W * H, **kw)
    jc, js = np.asarray(accum), int(js)

    tp = tsoa.pack_scene(tsc, W, H, device="cpu")
    tp.fog[FOG_HETERO] = 0.0
    idx = torch.arange(W * H, dtype=torch.int32)
    col, ts = TR.pass_body_grid(tp, FRAME_SEED, idx % W, idx // W,
                                tcfg=TI.trace_config_for_scene(tp, tsc, DEPTH, contract), **kw)
    tc, ts = col.to_rows().numpy(), int(ts)

    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    print(f"fuzz seed {seed}, {contract} contract: {ok.mean():.4%} of lanes in the band, segments {ts} vs {js}")
    assert ok.mean() >= 0.95
    assert abs(ts - js) <= 0.02 * js
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj)), (mt, mj)
