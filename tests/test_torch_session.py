"""The port's checkpoint/resume, metrics log, facade functions, CLI and
interactive session (utils/checkpoint.py, utils/metrics.py, render.py,
cli.py, interactive.py) against the JAX package's, on the CPU at tiny
frames; on a card only, resume and the CLI on the card's kernels.

Tolerances: none.  The digest is hex-equal to the JAX package's;
checkpoints load across the two packages field for field; a resumed
render is bit for bit the uninterrupted render with the same checkpoint
settings (under the cpu contract also the render without checkpointing);
the metrics records' pass indices and segments equal the JAX Renderer's
(segments are exact in the port and f32 sums in the JAX package, equal at
these sizes); the session behaviours are tests/test_session.py:26-105's.
"""

import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import cli as tcli
from path_trace_golang_tpu_torch import render as TR
from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch.interactive import PITCH_LIMIT, InteractiveSession
from path_trace_golang_tpu_torch.scene import builtin as TB
from path_trace_golang_tpu_torch.scene.model import RenderSettings
from path_trace_golang_tpu_torch.utils import checkpoint as ck
from path_trace_golang_tpu_torch.utils import metrics as tmetrics

from torch_png import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port(jsc):
    """The port's copy of a scene built with the JAX package's scene model."""
    from path_trace_golang_tpu import scene as JS

    return TS.loads(JS.dumps(jsc))


def _floor():
    from helpers import lambert_floor_scene

    return _port(lambert_floor_scene())


def _full():
    from helpers import full_feature_scene

    return _port(full_feature_scene())


def _session(sc=None, **kw):
    sc = sc or _floor()
    sc.settings = RenderSettings(width=32, height=24, samples_per_px=1, max_depth=3)
    kw.setdefault("renderer", tpt.Renderer(device="cpu"))
    return InteractiveSession(sc, mode="preview", **kw)


# ---------------------------------------------------------------------------
# the session (tests/test_session.py:26-105)
# ---------------------------------------------------------------------------


def test_session_settings_merge():
    """Scene settings override the mode preset where nonzero (app.go:61-70)."""
    sc = _floor()
    sc.settings = RenderSettings(width=100, height=0, samples_per_px=5, max_depth=0)
    s = InteractiveSession(sc, mode="preview", renderer=tpt.Renderer(device="cpu"))
    assert s.settings.width == 100  # from scene
    assert s.settings.height == 225  # preview preset fallback
    assert s.settings.samples_per_px == 5
    assert s.settings.max_depth == 20


def test_session_render_and_final_scaling():
    s = _session()
    img = s.render_now(final=False)
    assert img.shape == (24, 32, 3) and s.error is None
    assert s.fps > 0
    # final = spp x4, depth x2 (app.go:72-75)
    cfg = s._config(final=True)
    assert cfg.samples_per_px == 4 and cfg.max_depth == 6


def test_session_camera_keys():
    s = _session()
    cam = s.scene.camera
    x0, z0 = cam.position.x, cam.position.z
    tz0 = cam.target.z
    assert s.move_key("w")
    assert cam.position.z == z0 - 0.5 and cam.target.z == tz0 - 0.5
    assert s.move_key("d")
    assert cam.position.x == x0 + 0.5
    assert not s.move_key("z")


def test_session_rotation_preserves_distance_and_clamps_pitch():
    s = _session()
    cam = s.scene.camera
    d0 = math.dist(cam.position.as_tuple(), cam.target.as_tuple())
    for _ in range(100):
        s.rotate(d_pitch=0.05)  # pitch up far past the clamp
    d1 = math.dist(cam.position.as_tuple(), cam.target.as_tuple())
    assert d1 == pytest.approx(d0, rel=1e-4)
    dy = cam.target.y - cam.position.y
    dxz = math.hypot(cam.target.x - cam.position.x, cam.target.z - cam.position.z)
    assert math.atan2(dy, dxz) == pytest.approx(PITCH_LIMIT, abs=1e-3)


def test_session_scene_editing():
    s = _session(_full())
    assert s.edit_material("red", rough=0.5)
    assert [m for m in s.scene.materials if m.id == "red"][0].rough == 0.5
    assert not s.edit_material("nope", rough=0.5)
    with pytest.raises(AttributeError):
        s.edit_material("red", bogus=1)

    assert s.edit_object("ball", material_id="grey")
    s.add_object(TS.Object(id="extra", type="sphere", position=TS.Vec3(0, 5, 0), size=TS.Vec3(0.5, 0, 0),
                           material_id="grey"))
    assert any(o.id == "extra" for o in s.scene.objects)
    assert s.remove_object("extra")
    assert not s.remove_object("extra")

    s.edit_fog(density=0.5)
    assert s.scene.fog.density == 0.5
    s.edit_settings(samples_per_px=2)
    assert s.settings.samples_per_px == 2


def test_session_save_scene_and_image(tmp_path):
    s = _session()
    p = s.save_scene(str(tmp_path / "edited.json"))
    assert TS.load(p) == s.scene
    out = s.save_image(str(tmp_path / "final.png"))
    with open(out, "rb") as f:
        assert decode_png(f.read()).shape == (24, 32, 3)
    assert s.last_final is not None


def test_session_debounce_coalesces():
    s = _session()
    frames = []
    s.on_frame = lambda p, im: frames.append(p)
    for _ in range(5):
        s.request_render(False)  # 5 rapid edits -> one render
    time.sleep(0.1)
    with s._lock:
        gen = s._generation
    assert gen == 5  # every request bumped the generation
    time.sleep(0.5)
    if s._render_thread is not None:
        s._render_thread.join(timeout=300)
    assert s.last_preview is not None


def test_session_render_error_reaches_the_status():
    """A render that raises in the session's thread is reported on the
    status line and kept in ``error``, not swallowed."""

    class Failing(TR.Renderer):
        def render(self, *a, **k):
            raise RuntimeError("kernel launch failed: boom")

    status = []
    s = _session(renderer=Failing(device="cpu"), on_status=status.append)
    assert s.render_now(False) is None
    assert isinstance(s.error, RuntimeError) and any("boom" in m for m in status)


def test_session_image_equals_a_direct_render():
    """The session's frame is the Renderer's at the session's settings."""
    s = _session(renderer=tpt.Renderer(device="cpu", seed=4))
    img = s.render_now(False)
    want = tpt.Renderer(device="cpu", seed=4).render(_floor(), tpt.RenderConfig(32, 24, 1, 3))
    assert np.array_equal(img, want)


# ---------------------------------------------------------------------------
# checkpoints (tests/test_session.py:121-232)
# ---------------------------------------------------------------------------


def test_checkpoint_rotation(tmp_path):
    """keep=N shifts prior checkpoints into .1...N before each save; the
    oldest generation falls off the end."""
    path = str(tmp_path / "r.ckpt")
    for p_i in (1, 2, 3, 4):
        accum = np.full((4, 3), float(p_i), np.float32)
        ck.save_checkpoint(path, ck.Checkpoint(accum, passes=p_i, seed=7, digest="d", width=2, height=2), keep=2)
    assert ck.load_checkpoint(path).passes == 4
    assert ck.load_checkpoint(path + ".1").passes == 3
    assert ck.load_checkpoint(path + ".2").passes == 2
    assert not os.path.exists(path + ".3")

    # keep=0 (default) rotates nothing
    single = str(tmp_path / "s.ckpt")
    for p_i in (1, 2):
        ck.save_checkpoint(
            single, ck.Checkpoint(np.zeros((4, 3), np.float32), passes=p_i, seed=1, digest="d", width=2, height=2))
    assert not os.path.exists(single + ".1")


def test_checkpoint_load_falls_back_to_rotation(tmp_path):
    """A missing or corrupt head checkpoint resumes from the newest
    rotation generation instead of silently restarting from scratch."""
    path = str(tmp_path / "r.ckpt")
    for p_i in (1, 2, 3):
        ck.save_checkpoint(
            path, ck.Checkpoint(np.zeros((4, 3), np.float32), passes=p_i, seed=7, digest="d", width=2, height=2),
            keep=2)
    os.remove(path)  # a crash window / lost head
    back = ck.load_checkpoint(path, keep=2)
    assert back is not None and back.passes == 2  # newest surviving generation

    with open(path, "wb") as f:
        f.write(b"corrupt")  # unreadable head -> same fallback
    back = ck.load_checkpoint(path, keep=2)
    assert back is not None and back.passes == 2


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "r.ckpt")
    accum = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    ck.save_checkpoint(path, ck.Checkpoint(accum, passes=3, seed=7, digest="abc", width=8, height=8))
    back = ck.load_checkpoint(path)
    assert back is not None and back.passes == 3 and back.seed == 7 and back.digest == "abc"
    np.testing.assert_array_equal(back.accum, accum)
    assert ck.load_checkpoint(str(tmp_path / "missing.ckpt")) is None


SCENES = ["demo_cornell", "demo_showcase", "demo_mesh", "bench_mesh"]


@pytest.mark.parametrize("contract", ["cpu", "gpu"])
@pytest.mark.parametrize("name", SCENES)
def test_scene_digest_equals_the_jax_packages(name, contract):
    from path_trace_golang_tpu.scene import builtin as JB
    from path_trace_golang_tpu.utils import checkpoint as jck

    samples = 16 if contract == "gpu" else 1
    for cfg in (tpt.RenderConfig(1920, 1080, 1000, 80), tpt.RenderConfig(40, 30, 3, 5)):
        for normalize in (False, True):
            want = jck.scene_digest(getattr(JB, name)(), cfg, contract, normalize, samples)
            assert ck.scene_digest(getattr(TB, name)(), cfg, contract, normalize, samples) == want


def test_checkpoints_load_across_the_packages(tmp_path):
    """The JAX package's save_checkpoint loads in the port's load_checkpoint
    and the other way round, rotation included, field for field."""
    from path_trace_golang_tpu.utils import checkpoint as jck

    accum = np.random.default_rng(5).standard_normal((96, 3)).astype(np.float32)
    fields = dict(passes=9, seed=3, digest="f" * 64, width=12, height=8)
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jck.save_checkpoint(jpath, jck.Checkpoint(accum, **fields))
    ck.save_checkpoint(tpath, ck.Checkpoint(accum, **fields))
    for back in (ck.load_checkpoint(jpath), jck.load_checkpoint(tpath)):
        assert back is not None and back.accum.dtype == np.float32
        np.testing.assert_array_equal(back.accum, accum)
        assert {k: getattr(back, k) for k in fields} == fields
    ck.save_checkpoint(jpath, ck.Checkpoint(accum * 2, **dict(fields, passes=10)), keep=1)
    assert jck.load_checkpoint(jpath).passes == 10 and jck.load_checkpoint(jpath + ".1").passes == 9


def test_port_resumes_a_checkpoint_of_the_jax_packages_format(tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint, with the
    JAX package's digest, resumes in the port's Renderer bit for bit."""
    from path_trace_golang_tpu.scene import builtin as JB
    from path_trace_golang_tpu.utils import checkpoint as jck

    cfg = tpt.RenderConfig(16, 8, 6, 3)
    sc = TB.demo_cornell()
    mine = str(tmp_path / "t.ckpt")
    full = tpt.Renderer(contract="cpu", seed=2, device="cpu", checkpoint_path=mine).render(sc, cfg)
    done = ck.load_checkpoint(mine)
    part = str(tmp_path / "p.ckpt")
    calls = []
    tpt.Renderer(contract="cpu", seed=2, device="cpu", checkpoint_path=part).render(
        sc, cfg, cancel=lambda: calls.append(1) or len(calls) >= 3)
    saved = ck.load_checkpoint(part)
    jpath = str(tmp_path / "j.ckpt")
    digest = jck.scene_digest(JB.demo_cornell(), cfg, "cpu", False, 1)
    jck.save_checkpoint(jpath, jck.Checkpoint(saved.accum, passes=saved.passes, seed=2, digest=digest, width=16,
                                              height=8))
    r = tpt.Renderer(contract="cpu", seed=2, device="cpu", checkpoint_path=jpath)
    img = r.render(sc, cfg)
    assert r.stats.resumed_from == saved.passes == 3
    assert np.array_equal(img, full)
    np.testing.assert_array_equal(ck.load_checkpoint(jpath).accum, done.accum)


# the three paths: the cpu contract (classic loop, one sample a pass), the gpu
# contract (the regeneration loop, a window of passes) and faithful fog
# (classic loop, 16 samples a pass, a fog scene); the cpu and gpu contracts'
# passes chosen so that the update cadence is 2 passes (the gpu contract's
# windows are 2 passes under checkpointing)
RESUME = {
    "cpu": (dict(contract="cpu"), TB.demo_cornell, tpt.RenderConfig(8, 4, 40, 4)),
    "gpu": (dict(contract="gpu"), _floor, tpt.RenderConfig(8, 8, 20, 3)),
    "faithful_fog": (dict(contract="gpu", faithful_fog=True), _full, tpt.RenderConfig(4, 4, 2, 2)),
}


def _accum_at_finish(monkeypatch, renderer, sc, cfg, **kw):
    """Render; return (image, the accumulator the finish received)."""
    box = []
    for name in ("finalize_cpu_contract", "finalize_gpu_contract"):
        real = getattr(TR, name)
        monkeypatch.setattr(TR, name, lambda flat, *a, _r=real, **k: box.append(flat.clone()) or _r(flat, *a, **k))
    img = renderer.render(sc, cfg, **kw)
    return img, box[-1]


def resume_case(case, tmp, device):
    """Interrupt a render through cancel near its middle, resume it, and
    return what a test compares: (the uninterrupted render's image and
    checkpoint, the resumed render's, the passes saved, resumed_from)."""
    opts, make, cfg = RESUME[case] if isinstance(case, str) else case
    sc = make()
    a = os.path.join(tmp, "uninterrupted.ckpt")
    full = tpt.Renderer(seed=7, device=device, checkpoint_path=a, **opts).render(sc, cfg)
    b = os.path.join(tmp, "interrupted.ckpt")
    half = cfg.samples_per_px // 2
    tpt.Renderer(seed=7, device=device, checkpoint_path=b, **opts).render(sc, cfg, cancel=lambda: halfway(b, half))
    saved = ck.load_checkpoint(b)
    r = tpt.Renderer(seed=7, device=device, checkpoint_path=b, **opts)
    resumed = r.render(sc, cfg)
    return full, ck.load_checkpoint(a), resumed, ck.load_checkpoint(b), saved, r.stats


def halfway(path, half):
    """cancel(): True once the checkpoint at ``path`` holds ``half`` passes."""
    saved = ck.load_checkpoint(path)
    return saved is not None and saved.passes >= half


@pytest.mark.parametrize("case", list(RESUME))
def test_resume_is_bit_equal_to_the_uninterrupted_render(case, tmp_path, monkeypatch):
    full, full_ck, resumed, resumed_ck, saved, stats = resume_case(case, str(tmp_path), "cpu")
    passes = RESUME[case][2].samples_per_px
    assert saved is not None and 0 < saved.passes < passes
    assert stats.resumed_from == saved.passes and stats.passes == passes
    assert resumed_ck.passes == full_ck.passes == passes
    assert np.array_equal(resumed, full)
    assert np.array_equal(resumed_ck.accum.view(np.int32), full_ck.accum.view(np.int32))
    if case == "cpu":
        # the cpu contract adds pass by pass whatever the window: checkpointing changes nothing
        opts, make, cfg = RESUME[case]
        plain, acc = _accum_at_finish(monkeypatch, tpt.Renderer(seed=7, device="cpu", **opts), make(), cfg)
        assert np.array_equal(plain, full)
        assert np.array_equal(acc.reshape(-1, 3).numpy().view(np.int32),
                              full_ck.accum[:cfg.width * cfg.height].view(np.int32))


def test_checkpoint_digest_mismatch_ignored(tmp_path):
    """A checkpoint from a different scene/config must not be resumed."""
    sc = _full()
    cfg = tpt.RenderConfig(width=16, height=8, samples_per_px=2, max_depth=3)
    path = str(tmp_path / "x.ckpt")
    tpt.Renderer(contract="gpu", seed=1, checkpoint_path=path, device="cpu").render(sc, cfg)
    # different depth -> different digest -> fresh start
    r2 = tpt.Renderer(contract="gpu", seed=1, checkpoint_path=path, device="cpu")
    r2.render(sc, tpt.RenderConfig(width=16, height=8, samples_per_px=2, max_depth=4))
    assert r2.stats.resumed_from == 0


def test_checkpoint_of_another_padding_starts_fresh(tmp_path, monkeypatch):
    """The digest does not cover the chunk: a checkpoint whose accumulator
    has another padding (n_pad) starts the render fresh, it does not fail."""
    sc, cfg = TB.demo_cornell(), tpt.RenderConfig(10, 7, 4, 3)
    path = str(tmp_path / "c.ckpt")
    calls = []
    tpt.Renderer(contract="cpu", chunk=32, device="cpu", checkpoint_path=path).render(
        sc, cfg, cancel=lambda: calls.append(1) or len(calls) >= 2)
    assert ck.load_checkpoint(path).accum.shape == (96, 3)
    r = tpt.Renderer(contract="cpu", chunk=64, device="cpu", checkpoint_path=path)
    img = r.render(sc, cfg)
    assert r.stats.resumed_from == 0 and r.stats.passes == 4
    assert np.array_equal(img, tpt.Renderer(contract="cpu", chunk=64, device="cpu").render(sc, cfg))


def test_digest_is_made_only_under_checkpointing(tmp_path, monkeypatch):
    """The digest serializes the whole scene (a mesh's every triangle): a
    render without checkpointing does not make it."""
    monkeypatch.delenv("PATHTRACER_CHECKPOINT", raising=False)
    calls = []
    digest = ck.scene_digest
    monkeypatch.setattr(ck, "scene_digest", lambda *a: calls.append(1) or digest(*a))
    sc, cfg = TB.demo_cornell(), tpt.RenderConfig(8, 4, 2, 2)
    tpt.Renderer(contract="cpu", device="cpu").render(sc, cfg, progress=lambda *a: None)
    assert calls == []
    tpt.Renderer(contract="cpu", device="cpu", checkpoint_path=str(tmp_path / "d.ckpt")).render(sc, cfg)
    assert calls == [1]


def test_checkpoint_variables(tmp_path, monkeypatch):
    path = str(tmp_path / "env.ckpt")
    monkeypatch.setenv("PATHTRACER_CHECKPOINT", path)
    monkeypatch.setenv("PATHTRACER_CHECKPOINT_KEEP", "2")
    r = tpt.Renderer(contract="cpu", device="cpu")
    assert r.checkpoint_path == path and r.checkpoint_keep == 2
    r.render(TB.demo_cornell(), tpt.RenderConfig(8, 4, 3, 2))
    assert ck.load_checkpoint(path).passes == 3 and ck.load_checkpoint(path + ".2").passes == 1


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    """The JAX Renderer's interval records (pass index, segments) on tiny
    renders, each contract with checkpointing and a metrics sink (the
    window capped at the update cadence), and the gpu contract with a sink
    alone (its window uncapped)."""
    import path_trace_golang_tpu as jpt
    from path_trace_golang_tpu import scene as JS

    out = {}
    for key, contract, make, cfg, with_ckpt in METRIC_CASES:
        recs = []
        path = str(tmp_path_factory.mktemp("jck") / "j.ckpt") if with_ckpt else None
        r = jpt.Renderer(contract=contract, seed=3, metrics_sink=recs.append, checkpoint_path=path)
        r.render(JS.loads(TS.dumps(make())), jpt.RenderConfig(*cfg))
        out[key] = ([(x.pass_index, x.ray_segments, x.nonfinite) for x in recs], r.stats.ray_segments)
    return out


METRIC_CASES = [
    ("cpu", "cpu", TB.demo_cornell, (16, 8, 40, 3), True),
    ("gpu", "gpu", _floor, (16, 8, 20, 3), True),
    ("gpu_sink_only", "gpu", _floor, (16, 8, 16, 3), False),
]


@pytest.mark.parametrize("key,contract,make,cfg,with_ckpt", METRIC_CASES, ids=[c[0] for c in METRIC_CASES])
def test_metrics_records_equal_the_jax_renderers(jax_records, key, contract, make, cfg, with_ckpt, tmp_path):
    recs = []
    path = str(tmp_path / "t.ckpt") if with_ckpt else None
    r = tpt.Renderer(contract=contract, seed=3, metrics_sink=recs.append, checkpoint_path=path, device="cpu")
    r.render(make(), tpt.RenderConfig(*cfg))
    want, want_total = jax_records[key]
    assert [(x.pass_index, x.ray_segments, x.nonfinite) for x in recs] == want
    assert r.stats.ray_segments == want_total == sum(x.ray_segments for x in recs)
    assert r.metrics.records == recs and r.stats.nonfinite == 0


def test_metrics_jsonl_reads_through_metrics_report(tmp_path, monkeypatch):
    """PATHTRACER_METRICS gets one JSON line an interval, with the JAX
    package's keys, and tools/metrics_report.py reads it."""
    jsonl = tmp_path / "m.jsonl"
    monkeypatch.setenv("PATHTRACER_METRICS", str(jsonl))
    r = tpt.Renderer(contract="cpu", device="cpu")
    r.render(TB.demo_cornell(), tpt.RenderConfig(8, 4, 40, 2))
    lines = jsonl.read_text().splitlines()
    import json

    rows = [json.loads(x) for x in lines]
    assert [x["pass"] for x in rows] == list(range(2, 42, 2))
    assert all(set(x) == {"pass", "wall_s", "segments", "mrays_per_sec", "nonfinite"} for x in rows)
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), str(jsonl)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "20 intervals, last pass 40" in res.stdout and "accumulator finite in every interval" in res.stdout


def test_nonfinite_count():
    bad = torch.tensor([[1.0, float("nan"), float("inf")]])
    assert int(tmetrics.nonfinite_count(bad)) == 2
    assert int(tmetrics.nonfinite_count(np.array([1.0, -np.inf], np.float32))) == 1
    recs = []
    r = tpt.Renderer(contract="gpu", seed=1, metrics_sink=recs.append, device="cpu")
    r.render(_floor(), tpt.RenderConfig(width=16, height=8, samples_per_px=3, max_depth=3))
    assert recs and recs[-1].pass_index == 3
    assert sum(x.ray_segments for x in recs) == r.stats.ray_segments
    assert r.stats.nonfinite == 0


# ---------------------------------------------------------------------------
# the facade functions and the CLI
# ---------------------------------------------------------------------------


def test_render_scene_and_render_into_equal_the_renderer():
    sc = TB.demo_cornell()
    settings = RenderSettings(width=16, height=8, samples_per_px=2, max_depth=3)
    cfg = tpt.RenderConfig(16, 8, 2, 3)
    want = tpt.Renderer(device="cpu").render(sc, cfg)
    assert np.array_equal(tpt.render_scene(sc, settings, device="cpu"), want)
    seen = []
    assert np.array_equal(tpt.render_into(sc, cfg, progress=lambda p, im: seen.append(p), device="cpu"), want)
    assert seen == [1, 2]


def test_facade_functions_need_a_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc, settings = TB.demo_cornell(), RenderSettings(width=4, height=4, samples_per_px=1, max_depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.render_scene(sc, settings)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpt.render_into(sc, tpt.RenderConfig(4, 4, 1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["-scene", "demo_cornell", "-headless", "--width", "4", "--height", "4"])


def test_cli_options_equal_the_jax_clis_plus_device():
    from path_trace_golang_tpu import cli as jcli

    def options(parser):
        return {tuple(a.option_strings): (a.default, getattr(a, "choices", None)) for a in parser._actions}

    mine, theirs = options(tcli.build_parser()), options(jcli.build_parser())
    assert mine.pop(("--device",)) == ("cuda", None)
    assert mine == theirs


@pytest.mark.parametrize("gpu", [False, True], ids=["cpu_contract", "gpu_contract"])
def test_cli_headless_writes_the_renderers_png(gpu, tmp_path, capsys):
    out = tmp_path / "o.png"
    argv = ["-scene", "demo_cornell", "-headless", "-out", str(out), "--device", "cpu", "--width", "16",
            "--height", "8", "--spp", "2", "--depth", "3", "--seed", "5", "--json-stats"] + (["-gpu"] if gpu else [])
    try:
        assert tcli.main(argv) == 0
    finally:
        TR.set_backend(TR.BACKEND_CPU)
    import json

    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["width"] == 16 and stats["passes"] == 2 and stats["ray_segments"] > 0
    want = tpt.Renderer(contract="gpu" if gpu else "cpu", seed=5, device="cpu").render(
        TB.demo_cornell(), tpt.RenderConfig(16, 8, 2, 3))
    assert np.array_equal(decode_png(out.read_bytes()), want)


def test_cli_missing_scene_and_module_entry_point(tmp_path):
    assert tcli.main(["-scene", str(tmp_path / "nope.json"), "-headless", "--device", "cpu"]) == 1
    out = tmp_path / "m.png"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-m", "path_trace_golang_tpu_torch", "-scene", "demo_cornell", "-headless",
                          "--device", "cpu", "--width", "8", "--height", "4", "--spp", "1", "--depth", "2", "-out",
                          str(out)], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr
    assert decode_png(out.read_bytes()).shape == (4, 8, 3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


CARD_RESUME = {
    "cpu": (dict(contract="cpu"), TB.demo_showcase, tpt.RenderConfig(160, 90, 40, 20)),
    "gpu": (dict(contract="gpu"), TB.demo_showcase, tpt.RenderConfig(160, 90, 20, 8)),
    "faithful_fog": (dict(contract="gpu", faithful_fog=True), TB.demo_showcase, tpt.RenderConfig(160, 90, 4, 8)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_RESUME))
def test_resume_is_bit_equal_on_card(case, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from path_trace_golang_tpu_torch.ops import cuda_trace

    before = cuda_trace.LAUNCHES
    full, full_ck, resumed, resumed_ck, saved, stats = resume_case(CARD_RESUME[case], str(tmp_path), "cuda")
    assert cuda_trace.LAUNCHES > before
    assert 0 < saved.passes < CARD_RESUME[case][2].samples_per_px and stats.resumed_from == saved.passes
    assert np.array_equal(resumed, full)
    assert np.array_equal(resumed_ck.accum.view(np.int32), full_ck.accum.view(np.int32))


@pytest.mark.cuda
def test_cli_on_card(tmp_path, monkeypatch, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from path_trace_golang_tpu_torch.ops import cuda_trace

    jsonl = tmp_path / "m.jsonl"
    monkeypatch.setenv("PATHTRACER_METRICS", str(jsonl))
    before = cuda_trace.CLASSIC_LAUNCHES
    out = tmp_path / "o.png"
    assert tcli.main(["-scene", "demo_showcase", "-headless", "-out", str(out), "--width", "160", "--height", "90",
                      "--spp", "40", "--depth", "20", "--json-stats"]) == 0
    # one launch of the window kernel a window, the windows ending at the 20 interval passes (every 2nd)
    assert cuda_trace.CLASSIC_LAUNCHES - before == 20
    res = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), str(jsonl)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "20 intervals, last pass 40" in res.stdout
    assert "accumulator finite in every interval" in res.stdout
    monkeypatch.delenv("PATHTRACER_METRICS")
    want = tpt.Renderer(seed=1).render(TB.demo_showcase(), tpt.RenderConfig(160, 90, 40, 20))
    assert np.array_equal(decode_png(out.read_bytes()), want)
