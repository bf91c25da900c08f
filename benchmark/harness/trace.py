"""The traced run's reading of the device: torch.profiler over the window.

``Profiled`` records the window's device operations (kernels, copies,
memsets) and the host's ops; ``launch_mismatches`` holds the kernels that
the profiler saw to the port's own launch counters over the same renders,
so that a capture that lost events fails loudly instead of reading low.
"""

from __future__ import annotations

import collections
from typing import Optional

from .stats import idle_gaps, union_seconds

__all__ = ["Profiled", "LAUNCH_COUNTERS", "PLAIN_COUNTERS", "counters", "launch_mismatches", "breakdown"]

# the port's host-side counters (ops/cuda_trace.py)
LAUNCH_COUNTERS = ("LAUNCHES", "FOG_LAUNCHES", "MARCH_LAUNCHES", "PAGED_LAUNCHES", "CLASSIC_LAUNCHES",
                   "TRACE_LAUNCHES", "WALK_LAUNCHES")
PLAIN_COUNTERS = ("PLAIN_CALLS", "FOG_PLAIN_CALLS", "TRACE_PLAIN_CALLS", "WALK_PLAIN_CALLS")
WINDOW_SPAN = "benchmark_window"


def counters(cuda_trace) -> dict:
    return {k: int(getattr(cuda_trace, k, 0)) for k in LAUNCH_COUNTERS + PLAIN_COUNTERS}


class Profiled:
    """torch.profiler (host and device) around a block when ``on``.  After
    the block: ``device_ops`` and ``host_ops``, lists of (name, start s,
    end s) on the profiler's clock, and the block's own span ``window``
    (start s, end s) on the same clock."""

    def __init__(self, on: bool):
        self.on = on
        self.device_ops: list = []
        self.host_ops: list = []
        self.window: Optional[tuple] = None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            self._torch = torch
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._span = record_function(WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        # the raw records, without the profiler's own tree of function events, whose
        # building takes minutes for a window of many small operations
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            span = (name, e.start_ns() / 1e9, e.end_ns() / 1e9)
            if e.device_type() == DeviceType.CUDA:
                if name != WINDOW_SPAN:  # the span's own mark on the device timeline is no operation
                    self.device_ops.append(span)
            elif name == WINDOW_SPAN:
                self.window = span[1:]
            else:
                self.host_ops.append(span)
        return False

    @property
    def busy_s(self) -> float:
        a, b = self.window
        return union_seconds([(max(s, a), min(e, b)) for _n, s, e in self.device_ops if e > a and s < b])


def _first_template_arg(name: str, kernel: str) -> Optional[str]:
    rest = name[name.index(kernel) + len(kernel):]
    if not rest.startswith("<"):
        return None
    return rest[1:].split(",")[0].split(">")[0].strip()


def launch_mismatches(device_ops, before: dict, after: dict) -> list:
    """The port's kernels as the profiler saw them against its launch
    counters' growth over the same window: a list of what differs (empty
    when all agree), and the plain versions' calls, which must not move."""
    d = {k: after[k] - before[k] for k in after}
    seen = collections.Counter()
    paged = 0
    for name, _s, _e in device_ops:
        for kernel in ("render_pass_kernel", "fog_pass_kernel", "classic_window_kernel", "classic_sample_kernel",
                       "classic_march_kernel"):
            if kernel in name:
                seen[kernel] += 1
                if kernel != "fog_pass_kernel" and kernel != "classic_march_kernel":
                    paged += _first_template_arg(name, kernel) == "true"
    want = {
        "render_pass_kernel": d["LAUNCHES"] - d["CLASSIC_LAUNCHES"],
        "fog_pass_kernel": d["FOG_LAUNCHES"],
        "classic_window_kernel + classic_sample_kernel": d["CLASSIC_LAUNCHES"],
        "classic_march_kernel": d["MARCH_LAUNCHES"],
        "paged instances": d["PAGED_LAUNCHES"],
    }
    got = {
        "render_pass_kernel": seen["render_pass_kernel"],
        "fog_pass_kernel": seen["fog_pass_kernel"],
        "classic_window_kernel + classic_sample_kernel": seen["classic_window_kernel"] + seen["classic_sample_kernel"],
        "classic_march_kernel": seen["classic_march_kernel"],
        "paged instances": paged,
    }
    out = [f"{k}: the profiler saw {got[k]}, the port launched {want[k]}" for k in want if got[k] != want[k]]
    out += [f"{k} moved by {d[k]} in the window: the timed path ran a plain version" for k in PLAIN_COUNTERS
            if d[k]]
    return out


def breakdown(prof: Profiled, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the window, each named by the innermost host op that was running at
    its middle."""
    by_name = collections.Counter()
    for name, s, e in prof.device_ops:
        by_name[name[:120]] += e - s
    a, b = prof.window
    gaps = sorted(idle_gaps([(s, e) for _n, s, e in prof.device_ops], a, b), key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [(e - s, n) for n, s, e in prof.host_ops if s <= mid <= e]
        named.append([f"host: {min(inner)[1][:100]}" if inner else "host: python", g1 - g0])
    return {"device_ops": [[n, s] for n, s in by_name.most_common(top)], "idle_gaps": named}
