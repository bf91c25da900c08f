"""Arithmetic that the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader gets the traced run (``core.TracedRun``) and returns its number,
or None where the run holds nothing for it to read: the harness then
leaves the metric out of the line.
"""

from __future__ import annotations

from statistics import median

__all__ = ["phase_median", "kernel_roofline_pct", "idle_pct", "front_end_ms"]


def phase_median(run, select):
    """The median over the window's renders of the summed milliseconds of
    the Renderer's phases (``PATHTRACER_TIME_PHASES``) whose names
    ``select`` takes; None where no render has such a phase."""
    sums = [sum(ms for name, ms in r.phases if select(name)) for r in run.renders
            if any(select(name) for name, _ms in r.phases)]
    return median(sums) if sums else None


def kernel_roofline_pct(run, kernel: str):
    """A kernel's share of its roofline over the window: the bound of the
    frozen work of one render (``work/<cell>.json``: the larger of its f32
    operations at 67 TFLOP/s and its bytes at 3.35 TB/s) times the renders,
    over the kernel's device time in the profiler's record.  None where the
    cell has no frozen work for the kernel or the window ran none of it."""
    if run.work is None or kernel not in run.work.get("kernels", {}):
        return None
    busy = sum(e - s for name, s, e in run.device_ops if kernel in name)
    if busy <= 0:
        return None
    return 100.0 * run.work["kernels"][kernel]["bound_s"] * len(run.renders) / busy


def idle_pct(run):
    """The share of the traced window in which no operation ran on the card."""
    if run.window_s <= 0 or not run.device_ops:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)


def front_end_ms(run):
    """The median over the editor's frames of the key-to-frame latency less
    the Renderer's own wall: the session's share of a frame."""
    if not run.renders:
        return None
    return median((r.latency_s - r.wall_s) * 1e3 for r in run.renders)
