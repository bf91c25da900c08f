"""``PATHTRACER_NO_REGEN`` in the port, against the JAX package.

Both packages run on the CPU; the JAX side takes its XLA path.  Under
``NO_REGEN`` the gpu contract runs the classic per-sample loop (JAX
``integrator.py:134-138``), one pass a window (JAX ``render.py:644-650``).

* The port's plain pass body (the fog once, then the classic loop) equals
  the JAX pass body within the band of tests/test_torch_integrator.py
  (>= 95% of lanes within |a-b| <= 1e-3|b| + 1e-3, segments within 2%,
  channel means within 1%): demo_showcase at 32x16, depth 4, frame seed 3,
  through the JAX Renderer's own program (the lane band with the fog
  noise's strength at 0, ROADMAP Queue C's FMA witness; the segment and
  mean bands as it is), and demo_mesh (16x8) with every mesh on the paged
  walk, whose image differs from the regeneration loop's.
* The port's Renderer lies within the goldens' bands (mean 1.5%, std 6%) of
  the JAX Renderer's image (32x16, 2 passes, depth 4, seed 3), and calls
  the pass body once a pass and chunk.
* A 2x1 mesh (a gloo world of 2) gives the single Renderer's image and
  accumulator bit for bit (the single Renderer's chunk is the mesh's px
  block), segments equal.
* The checkpoint digest is the JAX package's, hex for hex, and the same
  with and without ``NO_REGEN`` (a fault of the reference, ROADMAP Queue C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import path_trace_golang_tpu as jpt
from path_trace_golang_tpu import integrator as JI
from path_trace_golang_tpu import render as JR
from path_trace_golang_tpu import soa as jsoa
from path_trace_golang_tpu.scene import builtin as JB
from path_trace_golang_tpu.utils import checkpoint as jck

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch.ops import cuda_trace
from path_trace_golang_tpu_torch.parallel.launch import run_world
from path_trace_golang_tpu_torch.scene import builtin as TB
from path_trace_golang_tpu_torch.scene import io as TS
from path_trace_golang_tpu_torch.utils import checkpoint as tck

import torch_mesh_ranks as ranks
from torch_jax_bodies import DEPTH, band, jax_body, pass_kw, port_body, with_fog

SW, SH, SSEED, SCHUNK = 32, 16, 3, 256  # the showcase, as tests/test_torch_integrator.py's
MW, MH, MSEED = 16, 8, 5  # demo_mesh
FOG_HETERO = 11  # the fog block's noise strength (soa.py)
NOISE_OFF = ((FOG_HETERO, 0.0),)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The plain versions here run on tensors of a few hundred lanes, where more threads only contend with
    the other test workers; the worker's count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("PATHTRACER_NO_REGEN", "PATHTRACER_BVH_DYNAMIC", "PATHTRACER_NO_WALK_SKIP"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def showcase():
    """JAX's NO_REGEN showcase pass through the JAX Renderer's own program
    (``_render_pass_chunk``, chunks of 256 lanes; one compile, ~160 s on one
    core), the fog noise as it is and at strength 0; then the JAX
    Renderer's image, which reuses the program."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHTRACER_NO_REGEN", "1")
    out = {}
    try:
        sc = JB.demo_showcase()
        for edits in ((), NOISE_OFF):
            jp = with_fog(jsoa.pack_scene(sc, SW, SH), edits)
            tcfg = JI.trace_config_for_scene(jp, sc, DEPTH, "gpu")
            assert not tcfg.regen
            accum, segs = jnp.zeros((SW * SH, 3), jnp.float32), 0
            for start in range(0, SW * SH, SCHUNK):
                accum, s = JR._render_pass_chunk(accum, jp, jnp.uint32(SSEED), jnp.int32(start), tcfg=tcfg,
                                                 chunk=SCHUNK, **pass_kw(sc, SW, SH, "gpu"))
                segs += int(s)
            out[edits] = (np.asarray(accum), segs)
        out["image"] = jpt.Renderer(contract="gpu", seed=SSEED, chunk=SCHUNK).render(
            sc, jpt.RenderConfig(SW, SH, 2, DEPTH))
    finally:
        mp.undo()
    return out


def test_noregen_pass_body_showcase_noise_off(monkeypatch, showcase):
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    band(port_body(TB.demo_showcase(), SW, SH, SSEED, "gpu", NOISE_OFF), showcase[NOISE_OFF])


def test_noregen_pass_body_showcase(monkeypatch, showcase):
    # the fog noise differs between jitted XLA and PyTorch by FMA fusion (ROADMAP Queue C): the lanes are
    # held with the noise off above; here the segment and channel-mean bands
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    band(port_body(TB.demo_showcase(), SW, SH, SSEED, "gpu"), showcase[()], lanes=False)


def test_noregen_pass_body_paged_mesh(monkeypatch):
    monkeypatch.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    regen = port_body(TB.demo_mesh(), MW, MH, MSEED, "gpu")
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    got = port_body(TB.demo_mesh(), MW, MH, MSEED, "gpu")
    band(got, jax_body(JB.demo_mesh(), MW, MH, MSEED, "gpu"))
    assert not np.array_equal(got[0], regen[0])


def test_noregen_renderer_within_goldens_bands(monkeypatch, showcase):
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    r = tpt.Renderer(contract="gpu", seed=SSEED, chunk=SCHUNK, device="cpu")
    img = r.render(TB.demo_showcase(), tpt.RenderConfig(SW, SH, 2, DEPTH)).astype(np.float64)
    want = np.asarray(showcase["image"]).astype(np.float64)
    assert r.stats.passes == 2 and r.stats.samples_per_pixel == 32 and r.stats.nonfinite == 0
    m, mj = img.mean(axis=(0, 1)), want.mean(axis=(0, 1))
    s, sj = img.std(axis=(0, 1)), want.std(axis=(0, 1))
    assert np.all(np.abs(m - mj) <= 0.015 * mj), (m, mj)
    assert np.all(np.abs(s - sj) <= 0.06 * sj), (s, sj)


def test_noregen_renderer_runs_the_classic_loop(monkeypatch):
    """One call of the whole-pass body a pass and chunk (the classic loop, one pass a window), as the JAX
    Renderer dispatches it (render.py:644-650)."""
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    calls = []
    orig = cuda_trace.render_pass_plain
    monkeypatch.setattr(cuda_trace, "render_pass_plain",
                        lambda *a, **k: calls.append(k["n_passes"]) or orig(*a, **k))
    tpt.Renderer(contract="gpu", seed=1, chunk=64, device="cpu").render(TB.demo_cornell(),
                                                                          tpt.RenderConfig(16, 8, 3, 2))
    assert calls == [1] * 6  # 3 passes x 2 chunks, one pass each


def test_noregen_mesh_2x1_bit_equal_to_single(monkeypatch):
    w, h, passes, depth = 24, 16, 2, 3
    case = dict(kind="render", mesh=(2, 1), scene=TS.dumps(TB.demo_showcase()), cfg=(w, h, passes, depth),
                kw=dict(contract="gpu", seed=7), runs=[{"env": {"PATHTRACER_NO_REGEN": "1"}}])
    results = run_world(ranks.run_cases, 2, ([case],), backend="gloo", timeout=600)
    monkeypatch.setenv("PATHTRACER_NO_REGEN", "1")
    r = tpt.Renderer(contract="gpu", seed=7, chunk=w * h // 2, device="cpu")
    with ranks.final_accum(TR) as box:
        img = r.render(TB.demo_showcase(), tpt.RenderConfig(w, h, passes, depth))
    for rank in results:
        got = rank[0][0]
        assert np.array_equal(got["img"], img)
        assert np.array_equal(got["accum"], box["accum"])
        assert got["stats"]["ray_segments"] == r.stats.ray_segments


@pytest.mark.parametrize("contract", ["gpu", "cpu"])
def test_scene_digest_covers_neither_no_regen_nor_faithful_fog(monkeypatch, contract):
    """The digest is the JAX package's, hex for hex, and the same with and
    without NO_REGEN: a NO_REGEN render's checkpoint resumes into a render
    with regeneration (the JAX package's fault, kept so that checkpoints
    load across the packages)."""
    cfg = tpt.RenderConfig(40, 30, 3, 5)
    samples = 16 if contract == "gpu" else 1
    got = []
    for raw in ("", "1"):
        monkeypatch.setenv("PATHTRACER_NO_REGEN", raw)
        want = jck.scene_digest(JB.demo_showcase(), cfg, contract, False, samples)
        got.append(tck.scene_digest(TB.demo_showcase(), cfg, contract, False, samples))
        assert got[-1] == want
    assert got[0] == got[1]
