"""The port's span recorder (utils/metrics.py) and the spans and counters
that render.py, soa.py, interactive.py and ops/cuda_trace.py record, on
the CPU at tiny frames.

Spans nest under their parents and share their request's id, on every
thread that works for it; self times add up to the root's duration; the
Renderer's ``syncs`` are the reads of the card that its code makes; the
recorder itself never reads or synchronises the card; the phase table of
``PATHTRACER_TIME_PHASES`` is printed from the spans, with the names,
order and boundaries of the JAX Renderer's; the paged build's cache counts
its hits and misses; and the benchmark's clock offset lays a span on the
profiler's record where a ``record_function`` range opened beside it lies.
"""

import os
import sys
import threading

import pytest
import torch

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import soa as tsoa
from path_trace_golang_tpu_torch.interactive import InteractiveSession
from path_trace_golang_tpu_torch.render import phase_table
from path_trace_golang_tpu_torch.scene import builtin as TB
from path_trace_golang_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASE_NAMES = {"render.pack", "render.config", "render.accum_init", "render.window", "render.interval",
               "render.finish"}


def _render(contract="gpu", passes=4, size=(8, 6), **kw):
    r = tpt.Renderer(contract=contract, seed=3, device="cpu", **{k: v for k, v in kw.items() if k != "progress"})
    img = r.render(TB.demo_cornell(), tpt.RenderConfig(size[0], size[1], passes, 2), progress=kw.get("progress"))
    return r, img


def _session(passes=2):
    s = InteractiveSession(TB.demo_cornell(), renderer=tpt.Renderer(contract="gpu", seed=1, device="cpu"))
    s.settings.width, s.settings.height, s.settings.samples_per_px, s.settings.max_depth = 8, 6, passes, 2
    return s


def _intervals(passes, gpu):
    """The Renderer's observed intervals: its windows end at every update pass."""
    every = max(1, passes // (10 if gpu else 20))
    return len({min(p, passes) for p in range(every, passes + every, every)})


# --------------------------------------------------------------------------- nesting, requests, self times


def test_spans_nest_under_their_parents():
    r, _ = _render(progress=lambda p, im: None)
    root = r.spans[0]
    assert root.name == "render" and root.parent is None
    seen = set()
    for sp in r.spans:
        if sp is not root:
            assert id(sp.parent) in seen  # a parent opens before its children
            assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns <= sp.parent.end_ns
        seen.add(id(sp))
    parent = {sp.name: sp.parent.name for sp in r.spans if sp.parent is not None}
    assert {n: parent[n] for n in PHASE_NAMES | {"render.progress"}} == dict.fromkeys(
        PHASE_NAMES | {"render.progress"}, "render")
    assert parent["pack.upload"] == "render.pack" and parent["callback"] == "render.progress"
    assert {sp.parent.name for sp in r.spans if sp.name == "read"} == {"render.interval", "render.finish"}
    assert {sp.parent.name for sp in r.spans if sp.name == "readback"} == {"render.progress", "render.finish"}
    assert {sp.parent.name for sp in r.spans if sp.name == "post.image"} == {"render.progress", "render.finish"}
    assert [sp.arg for sp in r.spans if sp.name == "render.window"] == [1, 2, 3, 4]


def test_one_request_id_per_render_and_per_editor_frame():
    r = tpt.Renderer(contract="gpu", seed=3, device="cpu")
    ids = []
    for _ in range(2):
        r.render(TB.demo_cornell(), tpt.RenderConfig(8, 6, 2, 2))
        ids.append({sp.request for sp in r.spans})
        assert [t.request for t in metrics.RECENT if t.spans == r.spans] == list(ids[-1])
    assert all(len(i) == 1 for i in ids) and ids[0] != ids[1]

    s = _session()
    s.render_now()
    s.move_key("w")
    img = s.render_now()
    assert img is not None
    frame = s.spans
    assert frame[0].name == "session.frame" and frame[0].parent is None and frame[0].end_ns is not None
    assert len({sp.request for sp in frame}) == 1
    names = [sp.name for sp in frame]
    for n in ("session.edit", "session.cancel", "session.handoff", "session.scene_copy", "render", "render.window",
              "session.publish"):
        assert n in names
    threads = {sp.name: sp.thread for sp in frame}
    assert threads["session.edit"] == threading.get_ident()
    assert threads["render"] == threads["render.window"] == threads["session.publish"] != threading.get_ident()
    render = next(sp for sp in frame if sp.name == "render")
    assert render.parent is frame[0]
    assert s.renderer.spans[0] is render and s.renderer.spans == metrics.subtree(frame, render)
    kept = [t for t in metrics.RECENT if t.spans is frame]  # another test's render thread may append after it
    assert len(kept) == 1 and kept[0].counters == {"debounce_scheduled": 1, "debounce_cancelled": 1, "syncs": 2 * 3 + 2,
                                                   "readback_bytes": 3 * (8 * 6 * 3) + (2 * 2 + 1) * 8}


@pytest.mark.parametrize("which", ["render", "frame"])
def test_self_times_add_up_to_the_root(which):
    if which == "render":
        spans = _render(progress=lambda p, im: None)[0].spans
    else:
        s = _session()
        s.arrow_key("left")
        s.render_now()
        spans = s.spans
    st = metrics.self_times(spans)
    assert all(v >= 0 for v in st.values())
    assert sum(st.values()) == spans[0].ns


# --------------------------------------------------------------------------- counters


@pytest.mark.parametrize("contract,observed", [("gpu", True), ("gpu", False), ("cpu", True), ("cpu", False),
                                               ("gpu", "checkpoint")])
def test_syncs_are_the_reads_the_code_makes(tmp_path, contract, observed):
    """Each observed interval reads the non-finite count and the segments, and
    the progress frame (or the checkpoint's accumulator); the finish reads
    the image and the segments, and, where nothing observed the intervals,
    the non-finite count."""
    passes, w, h = (40 if contract == "cpu" else 10), 8, 6
    kw = {}
    if observed is True:
        kw["progress"] = lambda p, im: None
    elif observed == "checkpoint":
        kw["checkpoint_path"] = str(tmp_path / "ck.npz")
    r, _ = _render(contract, passes, (w, h), **kw)
    n = _intervals(passes, contract == "gpu") if observed else 0
    assert len([sp for sp in r.spans if sp.name == "render.interval"]) == n
    assert r.counters["syncs"] == 3 * n + 2 + (0 if observed else 1)
    frame_bytes = w * h * 3
    chunk = min(r.chunk, w * h)
    big = frame_bytes if observed is True else -(-w * h // chunk) * chunk * 3 * 4  # the frame, or the accumulator
    assert r.counters["readback_bytes"] == n * (2 * 8 + big) + frame_bytes + 8 + (0 if observed else 8)
    reads = [sp for sp in r.spans if sp.name in ("read", "readback")]
    assert len(reads) == r.counters["syncs"]


def test_the_recorder_never_reads_or_synchronises_the_card(monkeypatch):
    calls = {"synchronize": 0, "cpu": 0, "item": 0}

    def counted(name, fn):
        def f(*a, **kw):
            # the plain versions' host tables (ScenePack.host, read once a pack) are no read of a card
            calls[name] += sys._getframe(1).f_code.co_name != "host"
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(torch.cuda, "synchronize", counted("synchronize", torch.cuda.synchronize))
    monkeypatch.setattr(torch.Tensor, "cpu", counted("cpu", torch.Tensor.cpu))
    monkeypatch.setattr(torch.Tensor, "item", counted("item", torch.Tensor.item))
    with metrics.request("outer") as rq:
        with metrics.span("a"):
            metrics.count("n", 2)
        with metrics.bound(rq.trace, rq.span), metrics.span("b"):
            pass
    metrics.self_times(rq.spans())
    metrics.subtree(rq.spans(), rq.span)
    assert calls == {"synchronize": 0, "cpu": 0, "item": 0}
    assert [sp.name for sp in rq.spans()] == ["outer", "a", "b"] and rq.counters() == {"n": 2}

    monkeypatch.delenv("PATHTRACER_TIME_PHASES", raising=False)
    r, _ = _render(progress=lambda p, im: None)
    assert calls["synchronize"] == 0 and "phase_sync" not in {sp.name for sp in r.spans}
    assert calls["cpu"] + calls["item"] == r.counters["syncs"]  # every read of the render's tensors is a span


def test_bvh_cache_counts_a_mesh_rendered_twice(monkeypatch):
    monkeypatch.setenv("PATHTRACER_BVH_DYNAMIC", "1")
    monkeypatch.setattr(tsoa, "_BVH_BUILD_CACHE", {})
    r = tpt.Renderer(contract="cpu", seed=1, device="cpu")
    names, counts = [], []
    for _ in range(2):
        r.render(TB.demo_mesh(), tpt.RenderConfig(2, 2, 1, 1))
        names.append([sp.name for sp in r.spans if sp.name.startswith("pack.")])
        counts.append({k: v for k, v in r.counters.items() if k.startswith("bvh_cache_")})
    assert counts == [{"bvh_cache_misses": 1}, {"bvh_cache_hits": 1}]
    assert names == [["pack.digest", "pack.bvh_build", "pack.upload"], ["pack.digest", "pack.upload"]]


def test_camera_basis_is_made_once_a_pack_and_frame_size():
    """The kernels' scene arguments, the camera basis among them, are made
    once a pack and frame size: a second call gives them again with no
    build, another frame size makes an entry of its own, and the kept basis
    is camera_basis's to the bit."""
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.ops.camera import camera_basis

    pack = tsoa.pack_scene(TB.demo_showcase(), 32, 18, device="cpu")
    with metrics.request("render") as rq:
        first = cuda_trace._camera_scene_args(pack, 32, 18)
        again = cuda_trace._camera_scene_args(pack, 32, 18)
    assert again is first and rq.counters() == {"camera_basis_builds": 1}
    with metrics.request("render") as rq:
        other = cuda_trace._camera_scene_args(pack, 16, 16)
        assert cuda_trace._camera_scene_args(pack, 32, 18) is first
    assert rq.counters() == {"camera_basis_builds": 1} and other != first
    for w, h in ((32, 18), (16, 16)):
        basis = camera_basis(pack.cam, w, h)
        kept = pack._host[("_camera_args", w, h)][0]
        assert torch.equal(kept.view(torch.int32), basis.view(torch.int32))
        assert cuda_trace._camera_scene_args(pack, w, h)[13] == kept.data_ptr()  # the basis argument


# --------------------------------------------------------------------------- the phase table


@pytest.mark.parametrize("contract", ["gpu", "cpu"])
def test_the_phase_table_is_printed_from_the_spans(monkeypatch, capsys, contract):
    monkeypatch.setenv("PATHTRACER_TIME_PHASES", "1")
    passes = 6
    r, _ = _render(contract, passes, progress=lambda p, im: None)
    rows = [ln.split() for ln in capsys.readouterr().err.splitlines() if ln.startswith("  phase ")]
    names = [row[1] for row in rows]
    table = phase_table(r.spans)
    assert names == [n for n, _ms in table]
    every = max(1, passes // (10 if contract == "gpu" else 20))
    ends = sorted({min(p, passes) for p in range(every, passes + every, every)})
    want = ["pack_scene", "trace_config", "accum_init"]
    for p in ends:
        want += [f"pass_window@{p}", f"interval@{p}"]
    assert names == want + ["final_fetch"]
    assert [float(row[2]) for row in rows] == [float(f"{ms:.1f}") for _n, ms in table]
    total = sum(ms for _n, ms in table)
    assert 0 <= r.stats.wall_seconds * 1e3 - total < 5.0  # the phases run to the finish's end
    syncs = [sp for sp in r.spans if sp.name == "phase_sync"]
    assert len(syncs) == 1 + len(ends) and {sp.parent.name for sp in syncs} == {"render.accum_init", "render.window"}
    assert r.counters["syncs"] == 3 * len(ends) + 2  # the table's own synchronise is no read of the card


# --------------------------------------------------------------------------- the device trace's clock


def test_the_offset_lays_a_span_where_the_profiler_saw_its_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, REPO)
    from benchmark.harness import spans as hs

    offset = hs.clock_offset_ns()
    ours = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.request("probe") as rq:
            for i in range(5):
                with record_function(f"probe{i}"), metrics.span(f"probe{i}") as sp:
                    torch.ones(8).sum()
                ours.append(sp)
    seen = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events() if e.name().startswith("probe")}
    errs = [abs((sp.start_ns + offset) - seen[sp.name]) for sp in ours]
    assert sorted(errs)[len(errs) // 2] < 200_000, errs
    assert rq.trace in metrics.RECENT
