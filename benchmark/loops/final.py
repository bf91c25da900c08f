"""The ``final`` loop: one client renders finished images back to back.

Each render is a ``Renderer.render`` with a progress callback as the CLI
gives one, with its own seed drawn from the run's seed, and ends in its
image on the host.  The window runs from the first render's start to the
last one's end and holds all of their work.

Traffic keys: ``contract``; ``width``, ``height``, ``passes``, ``depth``
(numbers, or "scene"); ``renderer`` (optional: further keyword arguments
of the port's ``Renderer``, such as ``faithful_fog`` or ``chunk``);
``check``: ``patches`` (gpu contract) or ``pixels`` (cpu contract), and
``segment_lanes``.

The rate takes one render's work from the cell's frozen count
(``work/<cell>.json``, ``frame_segments``: the segments traced inside the
frame, estimated by the plain reference), never from the program's own
counter, so that it is the same work whatever traces it.
"""

from __future__ import annotations

import time

from benchmark.harness.runs import PhaseCapture, Render, Window, renderer_args
from benchmark.harness.stats import sub_seed


class Loop:
    def __init__(self, pt, scene, settings: dict, traffic: dict, seed: int, device: str):
        self.scene, self.seed = scene, seed
        self.cfg = pt.RenderConfig(settings["width"], settings["height"], settings["passes"], settings["depth"])
        self.renderer = pt.Renderer(**renderer_args(traffic), device=device)

    def _one(self, seed: int, phases: bool) -> Render:
        r = self.renderer
        r.seed = seed
        last = [None]

        def progress(_pass, img):
            last[0] = img

        t = time.perf_counter()
        with PhaseCapture(phases) as cap:
            img = r.render(self.scene, self.cfg, progress=progress)
        lat = time.perf_counter() - t
        st = r.stats
        return Render(seed, img, last[0], int(st.ray_segments), int(st.nonfinite), st.wall_seconds, lat, cap.phases)

    def setup(self) -> None:
        self._one(sub_seed(self.seed, 1, 1), False)

    def window(self, seconds: float, phases: bool) -> Window:
        renders = []
        start = time.perf_counter()
        while True:
            renders.append(self._one(sub_seed(self.seed, 0, len(renders)), phases))
            if time.perf_counter() - start >= seconds:
                break
        return Window(renders, start, time.perf_counter())

    def close(self) -> None:
        self.renderer = None


def compared(window: Window, traffic: dict, scene_json: dict, rng):
    """What the check traces: one render drawn from the seed, with the
    scene's own camera, and the segment estimate's lanes."""
    ok = [i for i, r in enumerate(window.renders) if r.error is None]
    return [ok[int(rng.integers(len(ok)))]], None, traffic["check"].get("segment_lanes", 0)


def quantities(window: Window, work) -> dict:
    """``mrays_per_s``: the frozen segments of a render times the renders
    finished in the window, over the window."""
    done = sum(1 for r in window.renders if r.error is None)
    return {"mrays_per_s": done * work["frame_segments"]["value"] / window.seconds / 1e6}
