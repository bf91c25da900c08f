"""The port's measurement tools and the knobs they drive, against the JAX package.

Both packages run on the CPU (the JAX side as tests/conftest.py sets it
up); the port's tools run with ``--device cpu`` on their plain versions.

* ``PATHTRACER_BVH_DROP``: the strict parser and ``trace_config_for_scene``
  give the JAX package's ``debug_drop``; for each drop the port's plain
  pass body equals JAX ``render.pass_body_grid`` on demo_mesh (16x8, depth
  4, one pass, ``PATHTRACER_BVH_DYNAMIC=1``) within the band of
  tests/test_torch_integrator.py (>= 95% of lanes within |a-b| <=
  1e-3|b| + 1e-3, segments within 2%, channel means within 1%; measured:
  99.2-100% of lanes, segments equal), and differs from the undropped
  image.  The launch flags mirror csrc/common.cuh.
* tri_scaling's triangles and pages equal JAX ``pack_scene``'s at all
  three sizes (exact); many_lights' 64-light scene equals the JAX tool's,
  object for object (exact, captured from the JAX tool's own main with a
  stand-in Renderer); fixed_cost's fit is the JAX tool's arithmetic
  (exact).
* The mesh tools in a gloo world of 4 at 16x8, 2 passes, depth 2: every
  px-only shape's accumulator and image equal the 1x1 shape's bit for bit,
  spp shapes within |a-b| <= 1e-5|b| a entry (test_torch_parallel.py's rule); mesh_attrib's
  model is n_dev * shard_wall + tiny_wall (exact).
* The phase table of ``PATHTRACER_TIME_PHASES`` names the JAX Renderer's
  phases in its order for the same tiny render (names only).
* ``graft_entry.entry()``'s pass equals JAX ``__graft_entry__.entry()``'s
  within the integrator band (the JAX jit takes ~18 s on one core).
* No module under ``path_trace_golang_tpu_torch/tools/`` imports ``jax`` or
  the JAX package (a subprocess with both blocked).
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

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

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import graft_entry
from path_trace_golang_tpu_torch import integrator as TI
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.ops import cuda_trace
from path_trace_golang_tpu_torch.scene import builtin as TB
from path_trace_golang_tpu_torch.tools.perf import (
    fixed_cost, many_lights, mesh_attrib, mesh_scaling, timing, tri_scaling, walk_attrib,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The plain versions here run on tensors of a few hundred lanes, where more threads only contend with
    the other test workers and this file's ranks; the worker's count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
DROPS = ["closest", "shadow", "spec", "closest,shadow,spec"]
W, H, DEPTH, SEED = 16, 8, 4, 5  # the drop images: demo_mesh


def _jax_tool(name):
    """A JAX tool script of tools/perf/ as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(ROOT, "tools", "perf", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _band(tc, ts, jc, js):
    assert np.isfinite(tc).all()
    ok = (np.abs(tc - jc) <= 1e-3 * np.abs(jc) + 1e-3).all(axis=-1)
    assert ok.mean() >= 0.95, f"lanes matching {ok.mean():.4f}"
    assert abs(ts - js) <= 0.02 * js, (ts, js)
    mt, mj = tc.astype(np.float64).mean(0), jc.astype(np.float64).mean(0)
    assert np.all(np.abs(mt - mj) <= 0.01 * np.abs(mj) + 1e-6), (mt, mj)


# ---------------------------------------------------------------------------
# PATHTRACER_BVH_DROP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "closest", " spec , shadow ", "closest,shadow,spec", "spec,closest,,"])
def test_parse_bvh_drop_matches_jax(raw):
    assert TI._parse_bvh_drop(raw) == JI._parse_bvh_drop(raw)


@pytest.mark.parametrize("raw", ["closet", "shadow,specular", "all", "CLOSEST"])
def test_parse_bvh_drop_typo_raises_as_jax(raw):
    with pytest.raises(ValueError) as jerr:
        JI._parse_bvh_drop(raw)
    with pytest.raises(ValueError) as terr:
        TI._parse_bvh_drop(raw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("raw", ["", "shadow", "spec,closest"])
def test_trace_config_debug_drop_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("PATHTRACER_BVH_DROP", raw)
    jsc, tsc = JB.bench_mesh(12, 8), TB.bench_mesh(12, 8)
    jc = JI.trace_config_for_scene(jsoa.pack_scene(jsc, W, H), jsc, DEPTH, "gpu")
    tc = TI.trace_config_for_scene(tsoa.pack_scene(tsc, W, H, device="cpu"), tsc, DEPTH, "gpu")
    assert tc.debug_drop == jc.debug_drop


def test_drop_flags_mirror_common_cuh():
    src = open(os.path.join(ROOT, "path_trace_golang_tpu_torch", "csrc", "common.cuh")).read()
    got = {m.group(1).lower(): int(m.group(2)) for m in re.finditer(r"FLAG_DROP_(\w+) = (\d+)", src)}
    assert got == cuda_trace.FLAG_DROP
    taken = [int(v) for v in re.findall(r"FLAG_\w+ = (\d+)", src)]
    assert len(set(taken)) == len(taken) and all(v & (v - 1) == 0 for v in taken)
    tcfg = TI.TraceConfig(max_depth=2, debug_drop=("closest", "spec"))
    pack = tsoa.pack_scene(TB.demo_mesh(), W, H, device="cpu")
    assert cuda_trace._flags(pack, tcfg) & sum(cuda_trace.FLAG_DROP.values()) == 1024 + 4096


@pytest.fixture(scope="module")
def drop_images():
    """(JAX, port) pass bodies of demo_mesh for no drop and every drop, with every mesh on the paged walk."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    out = {}
    try:
        jsc, tsc = JB.demo_mesh(), TB.demo_mesh()
        jp, tp = jsoa.pack_scene(jsc, W, H), tsoa.pack_scene(tsc, W, H, device="cpu")
        kw = dict(width=W, height=H, n_strata=4, samples=16, has_aperture=jsc.camera.aperture > 0, n_passes=1)
        jidx = jnp.arange(W * H, dtype=jnp.int32).reshape(1, 128)
        tidx = torch.arange(W * H, dtype=torch.int32)
        for drop in [""] + DROPS:  # the undropped image on the port's side only
            mp.setenv("PATHTRACER_BVH_DROP", drop)
            tcfg = TI.trace_config_for_scene(tp, tsc, DEPTH, "gpu")
            tcol, tsegs = TR.pass_body_grid(tp, SEED, tidx % W, tidx // W, tcfg=tcfg, normalize_pass=False, **kw)
            out[drop] = [(tcol.to_rows().numpy(), int(tsegs))]
            if drop:
                jcfg = JI.trace_config_for_scene(jp, jsc, DEPTH, "gpu")
                col, segs = jax.jit(lambda p, px, py, jcfg=jcfg: JR.pass_body_grid(
                    p, jnp.uint32(SEED), px, py, tcfg=jcfg, trace_fn=None, normalize_pass=False, **kw))(
                    jp, jidx % W, jidx // W)
                out[drop].append((np.stack([np.asarray(c).reshape(-1) for c in col], axis=-1), int(segs)))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("drop", DROPS)
def test_drop_pass_body_matches_jax(drop_images, drop):
    (tc, ts), (jc, js) = drop_images[drop]
    _band(tc, ts, jc, js)
    assert not np.array_equal(tc, drop_images[""][0][0]), "the drop left the image as it was"


def test_drop_inert_under_cpu_contract(monkeypatch):
    """The knob names walks of the gpu contract: the cpu contract's image is the same with it."""
    sc = TB.bench_mesh(12, 8)
    imgs = []
    for drop in ("", "closest,shadow,spec"):
        monkeypatch.setenv("PATHTRACER_BVH_DROP", drop)
        imgs.append(tpt.Renderer(contract="cpu", seed=2, device="cpu").render(sc, tpt.RenderConfig(8, 8, 2, 4)))
    assert np.array_equal(imgs[0], imgs[1])


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------


def test_tri_scaling_counts_match_jax():
    for n_lat, n_lon in tri_scaling.SIZES:
        jp = jsoa.pack_scene(JB.bench_mesh(n_lat, n_lon), 512, 512)
        tp = tsoa.pack_scene(TB.bench_mesh(n_lat, n_lon), 512, 512, device="cpu")
        assert (tp.n_triangles, tp.paged.n_pages) == (jp.n_triangles, jp.paged.n_pages)
    assert [2 * a * b for a, b in tri_scaling.SIZES] == [10240, 40960, 100000]


def test_tri_scaling_runs_on_cpu(capsys):
    assert tri_scaling.main(["--sizes", "12x8,20x16", "--size", "8", "--reps", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(r["triangles"], r["pages"]) for r in line["rows"]] == [(192, 2), (640, 5)]
    assert all(r["mrays"] > 0 and r["walk_ms"] > 0 for r in line["rows"]) and "p_pad" in line["note"]


def test_many_lights_scene_matches_jax_tool(monkeypatch):
    """The JAX tool's own main, with a stand-in Renderer that records the scenes it is given."""
    seen = []

    class Stub:
        def __init__(self, **_kw):
            self.stats = type("S", (), {"mrays_per_sec": 1.0})()

        def render(self, sc, cfg):
            seen.append(sc)
            return np.zeros((2, 2, 3))

    monkeypatch.setattr(jpt, "Renderer", Stub)
    monkeypatch.setattr(sys, "argv", ["many_lights.py", "1", "8", "8", "1"])
    assert _jax_tool("many_lights").main() == 0
    jbase, jmany = seen[0], seen[1]
    base, _label = timing.scene_named("gpu_showcase", "demo_showcase")
    many = many_lights.many_light_scene(base)
    assert [o.to_json() for o in many.objects] == [o.to_json() for o in jmany.objects]
    assert [o.to_json() for o in base.objects] == [o.to_json() for o in jbase.objects]
    assert sum(o.type == "sphere_light" for o in many.objects) == 64


def test_many_lights_runs_on_cpu(monkeypatch, capsys):
    """Above 8 lights (the NEE window), on demo_cornell (one light, no fog): the showcase's fog march tests
    every light at every step and would take most of the CPU's time."""
    copies = many_lights.many_light_scene
    monkeypatch.setattr(timing, "scene_named", lambda name, fallback: (TB.demo_cornell(), "demo_cornell"))
    monkeypatch.setattr(many_lights, "many_light_scene", lambda base: copies(base, 9))
    assert many_lights.main(["1", "8", "4", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["lights"] == [1, 9] and line["slowdown"] > 0


@pytest.mark.parametrize("t1s,t4s", [([0.5], [0.8]), ([0.31, 0.3, 0.33], [0.62, 0.61, 0.7]), ([1.0, 0.9], [0.95])])
def test_fixed_cost_fit_is_jax_arithmetic(t1s, t4s):
    t1, t4 = min(t1s), min(t4s)  # JAX fixed_cost.py:59-64
    slope = (t4 - t1) / 3.0
    assert fixed_cost.fit(t1s, t4s) == (t1 - slope, slope)


def test_fixed_cost_runs_on_cpu(monkeypatch, capsys):
    small = TB.bench_mesh
    monkeypatch.setattr(TB, "bench_mesh", lambda: small(12, 8))
    assert fixed_cost.main(["1", "--size", "8", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["fixed_s"] == fixed_cost.fit(line["spp1_s"], line["spp4_s"])[0]
    assert line["accounted_s"] == line["finalize_s"] + line["nonfinite_s"]


def test_walk_attrib_runs_on_cpu(monkeypatch, capsys):
    """Every configuration renders with its drop set, and the knob does not outlive the tool."""
    from path_trace_golang_tpu_torch.tools.perf import bvh_bench

    monkeypatch.setattr(walk_attrib, "uv_sphere", lambda a, b: bvh_bench.uv_sphere(12, 8))
    monkeypatch.delenv("PATHTRACER_BVH_DROP", raising=False)
    assert walk_attrib.main(["1", "--size", "8", "--device", "cpu"]) == 0
    assert "PATHTRACER_BVH_DROP" not in os.environ
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["rows"]
    assert [r["config"] for r in rows] == [n for n, _ in walk_attrib.CONFIGS]
    seg = {r["config"]: r["segments"] for r in rows}
    assert seg["-closest"] != seg["base"] and seg["-shadow"] == seg["base"]


SHAPES = [(1, 1), (4, 1), (2, 2), (1, 2)]  # px only, both axes, spp only: a world of 4


def test_mesh_scaling_px_bits_spp_close():
    res = mesh_scaling.run(16, 8, 2, 2, "demo_cornell", SHAPES, "cpu", reps=1, keep_accum=True)
    assert res["world"] == 4 and res["backend"] == "gloo" and res["scene"] == "demo_cornell(builtin)"
    rows = {r["mesh"]: r for r in res["rows"]}
    one = rows["1x1"]
    for name, r in rows.items():
        assert r["passes"] == 2 and r["nonfinite"] == 0 and r["segments"] == one["segments"]
        if name.endswith("x1"):
            assert np.array_equal(r["accum"].view(np.int32), one["accum"].view(np.int32)), name
            assert np.array_equal(r["img"], one["img"]), name
        else:
            assert np.all(np.abs(r["accum"] - one["accum"]) <= 1e-5 * np.abs(one["accum"])), name
    assert rows["1x1"]["vs_1dev"] == 1.0


def test_mesh_attrib_model(capsys):
    shapes = SHAPES[:3]
    assert mesh_attrib.main(["16", "8", "2", "--depth", "2", "--scene", "demo_cornell", "--reps", "1",
                             "--shapes", ",".join(f"{a}x{b}" for a, b in shapes), "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["world"] == 4 and [r["mesh"] for r in line["rows"]] == [f"{a}x{b}" for a, b in shapes]
    for r in line["rows"]:
        assert r["serialized_model"] == r["devices"] * r["shard_wall"] + r["tiny_wall"]
        assert len(r["band_walls"]) == int(r["mesh"].split("x")[0])
        assert r["band_imbalance"] == r["wall"] / max(r["band_walls"])
    assert mesh_attrib.default_shapes(8) == [(1, 1), (8, 1), (4, 2), (1, 8)]


def test_time_phases_names_match_jax(monkeypatch, capsys):
    monkeypatch.setenv("PATHTRACER_TIME_PHASES", "1")
    names = []
    for render in (
        lambda: jpt.Renderer(contract="gpu", seed=1).render(JB.demo_cornell(), jpt.RenderConfig(8, 8, 2, 2),
                                                            progress=lambda p, im: None),
        lambda: tpt.Renderer(contract="gpu", seed=1, device="cpu").render(
            TB.demo_cornell(), tpt.RenderConfig(8, 8, 2, 2), progress=lambda p, im: None),
    ):
        capsys.readouterr()
        render()
        names.append([ln.split()[1] for ln in capsys.readouterr().err.splitlines() if ln.startswith("  phase ")])
    assert names[1] == names[0] and names[0][0] == "pack_scene" and names[0][-1] == "final_fetch"
    assert "interval@2" in names[0]
    monkeypatch.delenv("PATHTRACER_TIME_PHASES")
    tpt.Renderer(contract="gpu", seed=1, device="cpu").render(TB.demo_cornell(), tpt.RenderConfig(8, 8, 1, 2))
    assert "phase" not in capsys.readouterr().err


def test_graft_entry_matches_jax():
    cache = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        spec = importlib.util.spec_from_file_location("jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
        jmod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jmod)
    finally:  # the JAX module sets its own compile cache; this process keeps the test harness's
        jax.config.update("jax_compilation_cache_dir", cache[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", cache[1])
    jfn, jargs = jmod.entry()
    jout, jsegs = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    out, segs = fn(*args)
    assert tuple(out.shape) == tuple(jout.shape) == (graft_entry.WIDTH * graft_entry.HEIGHT, 3)
    _band(out.numpy(), int(segs), np.asarray(jout), int(jsegs))


def test_graft_entry_dryrun_on_cpu(capsys):
    assert graft_entry.main(["--devices", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh px=1 spp=2" in out and "full-contract ok" in out
    assert json.loads(out.strip().splitlines()[-1])["entry_shape"] == [6144, 3]


def test_tools_import_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['path_trace_golang_tpu'] = None\n"
        "import path_trace_golang_tpu_torch.tools as t\n"
        "names = [m.name for m in pkgutil.walk_packages(t.__path__, t.__name__ + '.')]\n"
        "names.append('path_trace_golang_tpu_torch.graft_entry')\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'path_trace_golang_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip()) >= 21  # tools/perf (16), tools/repro (4), graft_entry
