"""The check fails what it has to fail: the control (the reference summed in
bfloat16) at a size a test can hold, and a whole run with the timed path
broken underneath, on the CPU with the port's plain versions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import core
from benchmark.tools.control import readings

from bench_tiny import tiny_cell

SEED = 2**31 + 99


@pytest.mark.parametrize("name", ["showcase-gpu-final", "mesh10k-gpu-final", "showcase-cpu-final",
                                  "showcase-gpu-preview"])
def test_the_control_in_the_programs_place_is_not_correct(name):
    """A whole run at a test's size with the cell's own sample and limits:
    judging the port it is correct; with the control (the reference summed
    in bfloat16) judged in the port's place through the same comparison,
    it is not."""
    cell = tiny_cell(name, sample=None, seg_lanes=None, frames=None)
    seconds = 0.5 if cell.traffic["loop"] == "preview" else 0.0  # the editor's check compares several frames
    prog = core.run_cell(cell, SEED, seconds, trace=False, device="cpu")
    ctrl = core.run_cell(cell, SEED, seconds, trace=False, device="cpu", control=torch.bfloat16)
    assert prog.line["correct"] is True, prog.line["checks"]
    assert ctrl.line["correct"] is False, ctrl.line["checks"]


def test_the_control_tool_reads_both_sides_through_the_check():
    r = readings(tiny_cell("showcase-cpu-final", sample=None, seg_lanes=None), SEED, 0.0, "cpu")
    assert r["program_correct"] and not r["control_correct"], r
    assert r["control"]["bytes_off"] > r["program"]["bytes_off"]


def _no_window(render_pass):
    def broken(pack, frame_seed, px, py, **kw):
        col, segs = render_pass(pack, frame_seed, px, py, **kw)
        if frame_seed % 4 == 1:  # a quarter of the passes return the state they were given: nothing added
            col = col * 0.0
        return col, segs
    return broken


def _half_passes(render_pass):
    def broken(pack, frame_seed, px, py, **kw):
        col, segs = render_pass(pack, frame_seed, px, py, **kw)
        keep = 2.0 if frame_seed % 2 == 0 else 0.0  # half the passes left out, the mean over the rest
        return col * keep, segs * int(keep > 0)
    return broken


def _altered(accum_image):
    def broken(*a, **kw):
        img = accum_image(*a, **kw).clone()
        img[..., 0] = torch.where(img[..., 0] < 255, img[..., 0] + 1, img[..., 0] - 1)
        return img
    return broken


@pytest.mark.parametrize("name,fault", [
    ("showcase-cpu-final", None), ("showcase-cpu-final", "no_window"), ("showcase-cpu-final", "half_passes"),
    ("showcase-cpu-final", "altered"), ("showcase-gpu-final", None), ("showcase-gpu-final", "altered"),
])
def test_a_run_with_the_timed_path_broken_is_not_correct(monkeypatch, name, fault):
    from path_trace_golang_tpu_torch import render
    from path_trace_golang_tpu_torch.ops import cuda_trace

    if fault == "no_window":
        monkeypatch.setattr(cuda_trace, "render_pass", _no_window(cuda_trace.render_pass))
    elif fault == "half_passes":
        monkeypatch.setattr(cuda_trace, "render_pass", _half_passes(cuda_trace.render_pass))
    elif fault == "altered":
        monkeypatch.setattr(render, "accum_image", _altered(render.accum_image))
    cell = tiny_cell(name, sample=None, seg_lanes=None)  # the cell's own sample: its limits are counts of it
    res = core.run_cell(cell, SEED, 0.0, trace=False, device="cpu")
    assert res.line["correct"] is (fault is None), res.line["checks"]
    assert list(res.line)[-1] == "checks"


def test_a_traced_editor_run_reads_its_per_layer_metrics():
    cell = tiny_cell("showcase-gpu-preview")
    res = core.run_cell(cell, SEED, 0.5, trace=True, device="cpu")
    assert res.line["correct"], res.line["checks"]
    assert {"session_ms.preview", "pack_ms.preview"} <= set(res.line["metrics"])
    assert np.isfinite(res.line["metrics"]["session_ms.preview"]["value"])
