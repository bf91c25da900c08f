"""Structured render metrics, NaN surveillance, and profiling hooks.

Counterpart of the JAX package's ``utils/metrics.py``: per-interval
records (pass index, wall-clock, Mrays/s, non-finite count) collected by
:class:`MetricsLog` and written to a JSONL sink (``PATHTRACER_METRICS=<path>``,
the keys of :meth:`PassRecord.to_json`, which ``tools/metrics_report.py``
reads) or a callback, and a ``torch.profiler`` context for on-demand
traces.

A pass is a pure function of (scene, seed, pass index), so the recovery
from a transient device fault is detect-nonfinite, then recompute the
pass; :func:`nonfinite_count` feeds that check, and the Renderer reports
it in ``RenderStats`` and the metrics log.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, List, Optional

import torch

__all__ = ["PassRecord", "MetricsLog", "nonfinite_count", "profile_trace"]


@dataclasses.dataclass
class PassRecord:
    pass_index: int
    wall_seconds: float
    ray_segments: int
    mrays_per_sec: float
    nonfinite: int = 0

    def to_json(self) -> str:
        return json.dumps(
            {
                "pass": self.pass_index,
                "wall_s": round(self.wall_seconds, 4),
                "segments": self.ray_segments,
                "mrays_per_sec": round(self.mrays_per_sec, 2),
                "nonfinite": self.nonfinite,
            }
        )


class MetricsLog:
    """Collects per-interval pass records; optionally tees to a JSONL file
    (PATHTRACER_METRICS env var) and/or a callback."""

    def __init__(self, sink: Optional[Callable[[PassRecord], None]] = None):
        self.records: List[PassRecord] = []
        self.sink = sink
        self._path = os.environ.get("PATHTRACER_METRICS", "")
        self._t_last = time.perf_counter()
        self._segs_last = 0

    @property
    def observed(self) -> bool:
        """Whether a record reaches anything but :attr:`records` (a sink or
        the JSONL file)."""
        return self.sink is not None or bool(self._path)

    def interval(self, pass_index: int, total_segments: int, nonfinite: int = 0) -> PassRecord:
        now = time.perf_counter()
        wall = now - self._t_last
        segs = total_segments - self._segs_last
        rec = PassRecord(
            pass_index=pass_index,
            wall_seconds=wall,
            ray_segments=segs,
            mrays_per_sec=(segs / wall / 1e6) if wall > 0 else 0.0,
            nonfinite=nonfinite,
        )
        self._t_last = now
        self._segs_last = total_segments
        self.records.append(rec)
        if self.sink is not None:
            self.sink(rec)
        if self._path:
            with open(self._path, "a", encoding="utf-8") as f:
                f.write(rec.to_json() + "\n")
        return rec


def nonfinite_count(arr) -> torch.Tensor:
    """Number of non-finite elements, a 0-d int64 tensor on ``arr``'s device
    (reading it is the caller's one sync)."""
    return (~torch.isfinite(torch.as_tensor(arr))).sum()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the host and, where there is
    one, the card), written to ``log_dir/trace.json`` (Chrome trace format)
    when the block ends.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
