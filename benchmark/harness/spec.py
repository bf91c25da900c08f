"""Cells found by name: BENCHMARK.json and the data files it points to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them, or to one per-layer metric, is a
file of its own, found by its name:

* ``configs/<config>.json`` (the path that ``configs[].file`` gives): the
  scene JSON as it is rendered, its source and what was assumed;
* ``traffic/<traffic>.json``: the parameters that the loop it
  names reads;
* ``loops/<loop>.py``: a loop (``harness/runs.py`` says what it
  defines);
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``; a
  metric split by cells (``pack_ms.mesh``) takes its quantity's reader
  (``metrics/pack_ms.py``) where it has none of its own;
* ``limits/<cell>.json``: the cell's correctness limits, with the readings
  they were set from;
* ``work/<cell>.json``: the frozen work counts of the cell's kernels.

A cell, configuration, traffic mix or metric is added by adding its files
and its entries; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_benchmark", "find_cell", "find_loop", "metric_reader",
           "resolve_settings"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    work: Optional[dict]
    bench_dir: Path = BENCH_DIR


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def find_cell(bench: dict, name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    cells = [w for w in bench["workloads"] if w["name"] == name]
    if not cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    work_path = bench_dir / "work" / f"{name}.json"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_json(root / cfg["file"]),
        traffic=_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
        limits=_json(bench_dir / "limits" / f"{name}.json"),
        work=_json(work_path) if work_path.exists() else None,
        bench_dir=bench_dir,
    )


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_loop(name: str, bench_dir: Path = BENCH_DIR):
    """The loop ``loops/<name>.py`` (see ``harness/runs.py``)."""
    return _module(bench_dir / "loops" / f"{name}.py", f"benchmark_loop_{name.replace('.', '_')}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The ``read(run)`` function of ``metrics/<name>.py``, or of the
    quantity's ``metrics/<name before the first dot>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        path = bench_dir / "metrics" / f"{name.split('.')[0]}.py"
    return _module(path, f"benchmark_metric_{path.stem.replace('.', '_')}").read


# the editor's preview preset where the scene's settings block leaves a value at 0 (util.go:25-42)
PREVIEW_PRESET = {"width": 400, "height": 225, "samples_per_px": 20, "max_depth": 20}


def resolve_settings(traffic: dict, scene: dict) -> dict:
    """The traffic's width, height, passes and depth, each either a number
    or "scene": the scene's settings block, over the preview preset where
    the block leaves a value at 0 (app.go:61-70)."""
    block = scene.get("settings") or {}
    keys = {"width": "width", "height": "height", "passes": "samples_per_px", "depth": "max_depth"}
    out = {}
    for k, sk in keys.items():
        v = traffic[k]
        if v == "scene":
            v = block.get(sk) or PREVIEW_PRESET[sk]
        out[k] = int(v)
    return out
