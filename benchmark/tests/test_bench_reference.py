"""The reference against the port's plain versions on the CPU: every byte of
a tiny frame of each cell's contract and scene, the segments, the denoise
and the editor's keys."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import check, spec
from benchmark.reference import editor, lanes

from bench_tiny import TINY, tiny_cell


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_gives_every_byte_of_a_tiny_frame(name):
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.scene.model import Scene

    cell = tiny_cell(name)
    traffic, scene_json = cell.traffic, cell.config["scene"]
    st = spec.resolve_settings(traffic, scene_json)
    w, h, passes = st["width"], st["height"], st["passes"]
    module = spec.find_loop(traffic["loop"])
    loop = module.Loop(pt, Scene.from_json(scene_json), st, traffic, 5, "cpu")
    window = loop.window(0.0, phases=False)
    order, cameras, _ = module.compared(window, traffic, scene_json, np.random.default_rng(0))
    render = window.renders[order[0]]
    frame = lanes.Frame(lanes.load_scene(scene_json), traffic["contract"], w, h, st["depth"], "cpu")
    cy, cx = (a.reshape(-1) for a in np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    sample = (check.patch_sample(cy, cx, w, h) if traffic["contract"] == "gpu"
              else check.Sample(np.stack([cy, cx], 1), np.ones(len(cy), bool), None))
    cols, _ = check.trace_samples(frame, passes, render.seed, [sample], cameras, 0, np.random.default_rng(0), "cpu")
    ref = check.sample_bytes(sample, cols[0], traffic["contract"])
    prog = check.program_bytes(render, sample, traffic["contract"])
    assert check.bytes_off(prog, ref) == 0
    assert render.nonfinite == 0

    # the segments of every lane of the frame and every pass are the render's
    if traffic["loop"] == "final":
        px = torch.arange(w * h, dtype=torch.int32).repeat_interleave(passes)
        seeds = (render.seed + torch.arange(passes, dtype=torch.int64).repeat(w * h)) & 0xFFFFFFFF
        _c, segs = lanes.trace_lane_passes(frame, px % w, px // w, seeds)
        assert int(segs.sum()) == render.segments


def test_denoise_at_patch_centres_is_the_whole_image_filter():
    from path_trace_golang_tpu_torch.post import bilateral_denoise

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    img[2:5, 3:6] = 200  # a flat area as well as noise
    full = bilateral_denoise(torch.from_numpy(img)).numpy()
    cy, cx = (a.reshape(-1) for a in np.meshgrid(np.arange(7), np.arange(9), indexing="ij"))
    s = check.patch_sample(cy, cx, 9, 7)
    patches = torch.from_numpy(img[s.pix[:, 0], s.pix[:, 1]]).reshape(-1, 3, 3, 3)
    patches = torch.where(torch.from_numpy(s.valid).reshape(-1, 3, 3, 1), patches, 0)
    got = lanes.denoise_centres(patches, torch.from_numpy(s.valid[s.patches]))
    assert np.array_equal(got.numpy(), full[cy, cx])


def test_editor_keys_move_the_camera_as_the_session_does(monkeypatch):
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.interactive import InteractiveSession
    from path_trace_golang_tpu_torch.scene import builtin

    sess = InteractiveSession(builtin.demo_showcase(), renderer=pt.Renderer(device="cpu"))
    monkeypatch.setattr(sess, "request_render", lambda final=False: None)
    cam = builtin.demo_showcase().camera
    keys = ["w", "left", "up", "up", "e", "d", "right", "down", "q", "a", "s"] * 3
    for k in keys:
        (sess.move_key if k in editor.MOVES else sess.arrow_key)(k)
        editor.apply_key(cam, k)
        assert cam == sess.scene.camera
