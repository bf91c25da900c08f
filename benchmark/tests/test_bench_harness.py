"""The harness's arithmetic, its discovery by name, the import check, the
launch guard, and BENCHMARK.json against the rules it is written to."""

from __future__ import annotations

import json
import re
import shutil
import statistics
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import check, core, runs, spec, stats, trace
from benchmark.reference import editor

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


# --------------------------------------------------------------------------- arithmetic


def test_percentile_is_nearest_rank_with_its_count_beyond():
    xs = list(range(1, 201))  # 200 frames: the 190th value, 10 above it
    assert stats.percentile(xs, 95) == (190, 10)
    assert stats.percentile(xs, 90) == (180, 20)
    assert stats.percentile([5.0], 90) == (5.0, 0)
    assert stats.percentile([3, 1, 2, 2], 90) == (3, 0)
    assert stats.percentile(list(range(1, 167)), 90) == (150, 16)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_union_of_overlapping_intervals_and_the_gaps_between():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert stats.union_seconds(iv) == pytest.approx(4.0)
    assert stats.idle_gaps(iv, -1.0, 8.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    assert stats.union_seconds([]) == 0


def test_window_rate_takes_the_frozen_work_of_every_render_over_all_the_time():
    renders = [runs.Render(i, None, None, segments=s, nonfinite=0, wall_s=1.0, latency_s=1.0, phases=[])
               for i, s in enumerate((3_000_000, 5_000_000))]
    w = runs.Window(renders, start=10.0, end=12.5)
    work = {"frame_segments": {"value": 4_000_000}}  # the program's own counts are not read
    assert spec.find_loop("final").quantities(w, work)["mrays_per_s"] == pytest.approx(8.0 / 2.5)


def test_frame_latency_tail_counts_the_frames_beyond_it():
    renders = [runs.Render(0, None, None, 0, 0, 0.0, latency_s=ms / 1e3, phases=[]) for ms in range(1, 201)]
    q = spec.find_loop("preview").quantities(runs.Window(renders, 0.0, 1.0), None)
    assert q["frame_ms_p95"] == pytest.approx(190.0) and q["frames_beyond_p95"] == 10 and q["frames"] == 200


def test_sub_seed_takes_any_whole_seed():
    assert stats.sub_seed(2**31 + 7, 0, 1) == stats.sub_seed(2**31 + 7, 0, 1)
    assert stats.sub_seed(2**31 + 7, 0, 1) != stats.sub_seed(2**31 + 7, 0, 2)
    assert 0 <= stats.sub_seed(2**40, 3) < 2**32


# --------------------------------------------------------------------------- the loops' inputs


def test_editor_keys_come_back_and_each_round_is_one_multiset():
    traffic = json.loads((spec.BENCH_DIR / "traffic" / "preview-gpu-keys.json").read_text())
    keys = traffic["keys"]
    per_round = sum(2 * m for m in keys["lengths"]) * (len(keys["moves"]) + len(keys["turns"]))
    preview = spec.find_loop("preview")
    a, b = preview.key_stream(keys, 1), preview.key_stream(keys, 2)
    ra = [next(a) for _ in range(per_round)]
    rb = [next(b) for _ in range(per_round)]
    assert sorted(ra) == sorted(rb) and ra != rb
    cam = types.SimpleNamespace(position=types.SimpleNamespace(x=0.0, y=2.8, z=11.0),
                                target=types.SimpleNamespace(x=0.0, y=1.4, z=0.0))
    for k in ra:
        editor.apply_key(cam, k)
    assert (cam.position.x, cam.position.y, cam.position.z) == pytest.approx((0.0, 2.8, 11.0))
    assert (cam.target.x, cam.target.y, cam.target.z) == pytest.approx((0.0, 1.4, 0.0), abs=1e-9)


def test_resolve_settings_takes_the_scene_block_where_asked():
    scene = {"settings": {"width": 800, "height": 450, "samples_per_px": 16, "max_depth": 0}}
    t = {"width": "scene", "height": "scene", "passes": "scene", "depth": "scene"}
    assert spec.resolve_settings(t, scene) == {"width": 800, "height": 450, "passes": 16, "depth": 20}
    t = {"width": 1920, "height": 1080, "passes": 64, "depth": 12}
    assert spec.resolve_settings(t, scene) == t


def test_draw_sample_patches_stay_in_the_frame():
    s = check.draw_sample(np.random.default_rng(0), "gpu", 5, 4, 200)
    assert s.pix.shape == (1800, 2) and s.patches.shape == (200, 3, 3)
    py, px = s.pix[:, 0], s.pix[:, 1]
    assert (py >= 0).all() and (py < 4).all() and (px >= 0).all() and (px < 5).all()
    centres = s.pix[s.patches[:, 1, 1]]
    assert s.valid[s.patches[:, 1, 1]].all()
    assert not s.valid.all()  # border centres have neighbours outside
    off = s.pix[s.patches[:, 0, 2]] - centres
    ok = s.valid[s.patches[:, 0, 2]]
    assert (off[ok] == [-1, 1]).all()
    c = check.draw_sample(np.random.default_rng(0), "cpu", 5, 4, 7)
    assert c.patches is None and c.valid.all() and c.pix.shape == (7, 2)


# --------------------------------------------------------------------------- discovery by name


def _copy_benchmark(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


ONE_RENDER_LOOP = '''"""A loop added as a file of its own: the final loop, one render a window."""
from benchmark.harness import spec

_final = spec.find_loop("final")


class Loop(_final.Loop):
    def window(self, seconds, phases):
        return super().window(0.0, phases)


compared = _final.compared
quantities = _final.quantities
'''


def test_a_new_config_traffic_loop_and_metric_are_found_by_their_files_alone(tmp_path):
    root = _copy_benchmark(tmp_path)
    bd = root / "benchmark"
    before = {p: p.read_bytes() for p in bd.rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((bd / "configs" / "showcase.json").read_text())
    cfg["name"] = "showcase_dim"
    (bd / "configs" / "showcase_dim.json").write_text(json.dumps(cfg))
    traffic = json.loads((bd / "traffic" / "final-gpu-1024spp-d12.json").read_text())
    traffic["passes"] = 8
    (bd / "traffic" / "final-gpu-128spp-d12.json").write_text(json.dumps(traffic))
    (bd / "limits" / "showcase_dim-gpu-final.json").write_text((bd / "limits" / "showcase-gpu-final.json").read_text())
    (bd / "metrics" / "render_count.final.py").write_text("def read(run):\n    return float(len(run.renders))\n")
    (bd / "loops" / "final_once.py").write_text(ONE_RENDER_LOOP)
    once = dict(traffic, loop="final_once", width=12, height=8, passes=2, depth=2)
    (bd / "traffic" / "final-once-tiny.json").write_text(json.dumps(once))
    for d in ("limits", "work"):
        (bd / d / "showcase_dim-once.json").write_text((bd / d / "showcase-gpu-final.json").read_text())
    bench["configs"].append({"name": "showcase_dim", "source": "x", "file": "benchmark/configs/showcase_dim.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "showcase_dim-gpu-final", "config": "showcase_dim",
                               "traffic": "final-gpu-128spp-d12", "chips": 1, "why": "x"})
    bench["workloads"].append({"name": "showcase_dim-once", "config": "showcase_dim",
                               "traffic": "final-once-tiny", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "mrays_per_s":
            m["workloads"] += ["showcase_dim-gpu-final", "showcase_dim-once"]
    bench["per_layer"].append({"name": "render_count.final", "unit": "renders", "better": "higher",
                               "source": "program_counter", "layer": "Facade: render.Renderer",
                               "moves": "mrays_per_s"})
    bench["per_layer"].append({"name": "pack_ms.dim", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "Scene pack: soa.pack_scene", "moves": "mrays_per_s",
                               "workloads": ["showcase_dim-once"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell(spec.load_benchmark(root), "showcase_dim-gpu-final", root, bd)
    assert cell.traffic["passes"] == 8 and cell.config["name"] == "showcase_dim"
    assert [m["name"] for m in cell.end_to_end] == ["mrays_per_s", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["render_count.final"]  # the new metric has no workloads key: it follows what it moves
    run = types.SimpleNamespace(renders=[1, 2, 3])
    assert spec.metric_reader("render_count.final", bd)(run) == 3.0
    # an existing cell picks the new metric up too, since it reports mrays_per_s
    old = spec.find_cell(spec.load_benchmark(root), "showcase-gpu-final", root, bd)
    assert "render_count.final" in [m["name"] for m in old.per_layer]
    # a metric split by cells takes its quantity's reader
    assert spec.metric_reader("pack_ms.dim", bd) is not None and not (bd / "metrics" / "pack_ms.dim.py").exists()
    # a new loop, found by its file, drives a whole run: one render a window, whatever its length
    new = spec.find_cell(spec.load_benchmark(root), "showcase_dim-once", root, bd)
    res = core.run_cell(new, 2**31 + 3, 5.0, trace=False, device="cpu")
    assert res.line["attempted"] == 1 and res.line["correct"], res.line["checks"]
    assert set(res.line["metrics"]) == {"mrays_per_s", "setup_s"}
    # and no file that was there changed
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_traffic_mix_passes_its_renderer_keys_through():
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.scene import builtin

    traffic = {"contract": "gpu", "renderer": {"faithful_fog": True, "chunk": 64}}
    st = {"width": 8, "height": 4, "passes": 1, "depth": 2}
    for name in ("final", "preview"):
        loop = spec.find_loop(name).Loop(pt, builtin.demo_showcase(), st, dict(traffic, keys=None), 1, "cpu")
        assert (loop.renderer.contract, loop.renderer.faithful_fog, loop.renderer.chunk) == ("gpu", True, 64)


# --------------------------------------------------------------------------- the import check


@pytest.mark.parametrize("name,found", [
    ("path_trace_golang_tpu_torch", []),
    ("path_trace_golang_tpu_torch.render", []),
    ("path_trace_golang_tpu_torchvision", []),
    ("jaxtyping", []),
    ("path_trace_golang_tpu", ["path_trace_golang_tpu"]),
    ("path_trace_golang_tpu.render", ["path_trace_golang_tpu"]),
    ("jax.numpy", ["jax"]),
    ("jaxlib", ["jaxlib"]),
    ("flax.linen", ["flax"]),
])
def test_the_import_check_compares_whole_top_level_names(monkeypatch, name, found):
    for k in [k for k in sys.modules if k.split(".")[0] in core.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert core.forbidden_modules() == found


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    pat = re.compile(r"^\s*(?:from|import)\s+([A-Za-z_][\w.]*)", re.M)
    for path in spec.BENCH_DIR.rglob("*.py"):
        for mod in pat.findall(path.read_text()):
            assert mod.split(".")[0] not in core.FORBIDDEN, (path, mod)
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for mod in pat.findall(path.read_text()):
            assert not mod.startswith("path_trace_golang_tpu"), (path, mod)
            assert not mod.startswith("benchmark"), (path, mod)


# --------------------------------------------------------------------------- the launch guard


def _ops(*names):
    return [(n, float(i), i + 0.5) for i, n in enumerate(names)]


def test_launch_guard_holds_the_profiler_to_the_counters():
    before = dict.fromkeys(trace.LAUNCH_COUNTERS + trace.PLAIN_COUNTERS, 0)
    after = dict(before, LAUNCHES=2, FOG_LAUNCHES=2)
    ops = _ops("void fog_pass_kernel<false>(Tables, Params)", "void render_pass_kernel<false>(Tables, Params)",
               "void fog_pass_kernel<false>(Tables, Params)", "void render_pass_kernel<false>(Tables, Params)",
               "Memcpy DtoH (Device -> Pageable)")
    assert trace.launch_mismatches(ops, before, after) == []
    short = trace.launch_mismatches(ops[:3], before, after)
    assert len(short) == 1 and "render_pass_kernel: the profiler saw 1, the port launched 2" in short[0]
    paged = dict(after, PAGED_LAUNCHES=2)
    assert trace.launch_mismatches(ops, before, paged) == ["paged instances: the profiler saw 0, the port launched 2"]
    ops_paged = [(n.replace("render_pass_kernel<false>", "render_pass_kernel<true, false>"), s, e) for n, s, e in ops]
    assert trace.launch_mismatches(ops_paged, before, paged) == []
    plain = dict(after, PLAIN_CALLS=1)
    assert "PLAIN_CALLS moved by 1" in trace.launch_mismatches(ops, before, plain)[0]
    classic = dict(before, LAUNCHES=3, CLASSIC_LAUNCHES=3)
    assert trace.launch_mismatches(_ops(*["void classic_window_kernel<false>(Tables)"] * 3), before, classic) == []


def test_breakdown_names_the_gaps_by_the_host_op_running():
    prof = trace.Profiled(False)
    prof.window = (0.0, 10.0)
    prof.device_ops = [("k1", 1.0, 3.0), ("k2", 2.0, 4.0), ("k1", 6.0, 7.0)]
    prof.host_ops = [("outer", 4.0, 6.0), ("aten::copy_", 4.5, 5.5)]
    assert prof.busy_s == pytest.approx(4.0)
    b = trace.breakdown(prof)
    assert b["device_ops"][0] == ["k1", 3.0]
    assert b["idle_gaps"][0] == ["host: python", 3.0]  # (7, 10)
    assert ["host: aten::copy_", 2.0] in b["idle_gaps"]


# --------------------------------------------------------------------------- BENCHMARK.json


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        cell = spec.find_cell(BENCH, w["name"])
        assert (spec.BENCH_DIR / "loops" / f"{cell.traffic['loop']}.py").exists()
        if cell.traffic["loop"] == "final":
            assert cell.work["frame_segments"]["value"] > 0
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert set(cell.limits) >= {"bytes_off", "nonfinite", "plain_calls"}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and callable(spec.metric_reader(m["name"]))
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m.get("workloads", []):
            assert c in e2e[m["moves"]].get("workloads", [c])
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
            for c in m["workloads"]:
                assert (spec.BENCH_DIR / "work" / f"{c}.json").exists()
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_config_files_hold_the_scenes_they_stand_in_for():
    from path_trace_golang_tpu_torch.scene import builtin
    from path_trace_golang_tpu_torch.scene.model import Scene

    for name, builder in (("showcase", builtin.demo_showcase), ("mesh10k", builtin.bench_mesh)):
        cfg = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
        scene = Scene.from_json(cfg["scene"])
        if name == "showcase":  # its settings block is left at 0: the editor takes the upstream's preview preset
            assert scene.settings.is_zero()
            scene.settings = builder().settings
        assert scene == builder()
        assert cfg["assumed"]
