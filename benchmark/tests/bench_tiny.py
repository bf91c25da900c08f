"""Tiny versions of the benchmark's cells, for the tests on the CPU and a quick run on the card."""

from __future__ import annotations

from benchmark.harness import spec

# per cell: the frame, passes and depth the tests render, and the check's sample
TINY = {
    "showcase-gpu-final": dict(width=20, height=12, passes=2, depth=3),
    "mesh10k-gpu-final": dict(width=16, height=12, passes=2, depth=3),
    "showcase-cpu-final": dict(width=24, height=16, passes=100, depth=8),
    "showcase-gpu-preview": dict(width=16, height=10, passes=2, depth=3),
}


def tiny_cell(name: str, sample=6, seg_lanes=128, frames=2, size=None) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json cut to :data:`TINY`'s size: a
    traffic mix that sizes its frames itself gets the tiny numbers, one that
    takes the scene's settings block gets them in the scene.  The check's
    sample sizes become ``sample``, ``seg_lanes`` and ``frames``; None keeps
    the cell's own.  ``size`` replaces :data:`TINY`'s frame, passes and depth."""
    cell = spec.find_cell(spec.load_benchmark(), name)
    size = size or TINY[name]
    if cell.traffic["width"] == "scene":
        cell.config["scene"]["settings"] = {"width": size["width"], "height": size["height"],
                                            "samples_per_px": size["passes"], "max_depth": size["depth"]}
    else:
        cell.traffic.update(size)
    ck = cell.traffic["check"]
    for k, v in (("patches", sample), ("pixels", sample), ("segment_lanes", seg_lanes), ("frames", frames)):
        if k in ck and v is not None:
            ck[k] = v
    return cell
