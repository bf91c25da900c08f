"""What every loop shares.

A loop is ``loops/<loop>.py``, found by the name that a traffic mix's
``loop`` key gives (``spec.find_loop``).  It defines

* ``Loop(pt, scene, settings, traffic, seed, device)``, with ``setup()``
  (the warm-up: one render or frame of the cell's own shape),
  ``window(seconds, phases)`` (renders until ``seconds`` have passed,
  finishing the one in flight; returns a :class:`Window`) and ``close()``;
* ``compared(window, traffic, scene_json, rng)``: what the check traces,
  (the compared renders' indices, their cameras or None for the scene's
  own, the segment estimate's lanes);
* ``quantities(window, work)``: the end-to-end quantities of a window, by
  the metrics' names before any dot.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import re
from typing import Optional

import numpy as np

__all__ = ["Render", "Window", "PhaseCapture", "renderer_args"]

_PHASE = re.compile(r"^\s*phase (\S+)\s+(-?[0-9.]+) ms$")


@dataclasses.dataclass
class Render:
    seed: int
    image: Optional[np.ndarray]
    progress: Optional[np.ndarray]  # the last progress frame the callback received
    segments: int
    nonfinite: int
    wall_s: float  # the Renderer's own wall (RenderStats.wall_seconds)
    latency_s: float  # the harness's clock around the call (a render; a key and its frame)
    phases: list
    keys: int = 0  # the editor's keys applied before this frame
    error: Optional[str] = None


@dataclasses.dataclass
class Window:
    renders: list
    start: float
    end: float
    keys: list = dataclasses.field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class PhaseCapture:
    """The Renderer's phase table (``PATHTRACER_TIME_PHASES=1``, printed on
    stderr) of the calls inside the block, when ``on``; else nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.phases: list = []

    def __enter__(self):
        if self.on:
            self._buf = io.StringIO()
            self._cm = contextlib.redirect_stderr(self._buf)
            self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._cm.__exit__(*exc)
            for line in self._buf.getvalue().splitlines():
                m = _PHASE.match(line)
                if m:
                    self.phases.append((m.group(1), float(m.group(2))))
        return False


def renderer_args(traffic: dict) -> dict:
    """The keyword arguments of the port's ``Renderer`` that a traffic mix
    gives: its ``contract`` and whatever its ``renderer`` object holds."""
    return {"contract": traffic["contract"], **traffic.get("renderer", {})}
