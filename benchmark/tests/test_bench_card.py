"""On the card: every cell through the whole harness at a small frame, the
trace guard included, and the reference against the port's kernels on
every byte of a small frame.  Run with ``python -m pytest -m cuda
benchmark/tests -q``; without a card each test skips itself."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import check, spec
from benchmark.reference import lanes

from bench_tiny import tiny_cell

SMALL = {
    "showcase-gpu-final": dict(width=128, height=72, passes=4, depth=12),
    "mesh10k-gpu-final": dict(width=128, height=72, passes=2, depth=8),
    "showcase-cpu-final": dict(width=128, height=72, passes=64, depth=80),
    "showcase-gpu-preview": dict(width=128, height=72, passes=4, depth=12),
}


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _small(name):
    return tiny_cell(name, sample=64, seg_lanes=4096, frames=3, size=SMALL[name])


def _run_alone(name: str, seed: int, seconds: float, trace: bool) -> dict:
    """One run of a small cell in a process of its own, as the benchmark
    runs a cell: torch.profiler lost one frame's kernels in a process that
    had profiled three windows before (the trace guard caught it), which
    no benchmark run does."""
    here = Path(__file__).resolve().parent
    code = (f"import json, sys; sys.path[:0] = [{str(here.parents[1])!r}, {str(here)!r}]\n"
            "from benchmark.harness import core\nfrom test_bench_card import _small\n"
            f"print(json.dumps(core.run_cell(_small({name!r}), {seed}, {seconds}, trace={trace}, device='cuda').line))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_small_cell_runs_correct_on_the_card(name, trace):
    _card()
    line = _run_alone(name, 2**31 + 5, 2.0, trace)
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_reference_gives_every_byte_of_the_kernels_frame(name):
    _card()
    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.scene.model import Scene

    cell = _small(name)
    traffic, scene_json = cell.traffic, cell.config["scene"]
    st = spec.resolve_settings(traffic, scene_json)
    w, h = st["width"], st["height"]
    module = spec.find_loop(traffic["loop"])
    loop = module.Loop(pt, Scene.from_json(scene_json), st, traffic, 17, "cuda")
    window = loop.window(0.0, phases=False)
    order, cameras, _ = module.compared(window, traffic, scene_json, np.random.default_rng(0))
    render = window.renders[order[0]]
    frame = lanes.Frame(lanes.load_scene(scene_json), traffic["contract"], w, h, st["depth"], "cuda")
    cy, cx = (a.reshape(-1) for a in np.meshgrid(np.arange(h), np.arange(w), indexing="ij"))
    sample = (check.patch_sample(cy, cx, w, h) if traffic["contract"] == "gpu"
              else check.Sample(np.stack([cy, cx], 1), np.ones(len(cy), bool), None))
    cols, _ = check.trace_samples(frame, st["passes"], render.seed, [sample], cameras, 0,
                                  np.random.default_rng(0), "cuda")
    off = check.bytes_off(check.program_bytes(render, sample, traffic["contract"]),
                          check.sample_bytes(sample, cols[0], traffic["contract"]))
    assert off == 0
