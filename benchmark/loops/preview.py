"""The ``preview`` loop: one editor user in a closed loop.

Each frame is a camera key, then ``InteractiveSession.render_now()``,
which cancels the key's 200 ms debounce and renders at once.  The keys
are drawn from the run's seed as excursions that come back (a key pressed
1-3 times, then its inverse as often), a fixed multiset of them a round
in an order of the seed's, so every seed does the same work.

Traffic keys: ``contract``; ``width``, ``height``, ``passes``, ``depth``
(numbers, or "scene": the scene's settings block over the editor's
preview preset, app.go:61-70); ``renderer`` (optional, as the final
loop's); ``keys``: ``moves``, ``turns``, ``lengths``; ``check``:
``frames``, ``patches``.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness.runs import PhaseCapture, Render, Window, renderer_args
from benchmark.harness.stats import median, percentile, sub_seed
from benchmark.reference import editor, lanes


def key_stream(keys: dict, seed: int):
    """The editor user's keys, forever: each round every key of ``moves``
    and ``turns`` as an excursion of each of ``lengths`` (the key m times,
    then its inverse m times), the round's excursions in an order drawn
    from ``seed``."""
    rng = np.random.default_rng(sub_seed(seed, 2))
    blocks = [[k] * m + [editor.INVERSE[k]] * m for k in keys["moves"] + keys["turns"] for m in keys["lengths"]]
    while True:
        for j in rng.permutation(len(blocks)):
            yield from blocks[j]


class Loop:
    def __init__(self, pt, scene, settings: dict, traffic: dict, seed: int, device: str):
        from path_trace_golang_tpu_torch.interactive import InteractiveSession

        self.render_seed = sub_seed(seed, 1)
        self.renderer = pt.Renderer(**renderer_args(traffic), seed=self.render_seed, device=device)
        self.last = [None]
        self.session = InteractiveSession(scene, mode="preview", on_frame=self._frame, renderer=self.renderer)
        s = self.session.settings
        s.width, s.height, s.samples_per_px, s.max_depth = (settings[k] for k in ("width", "height", "passes", "depth"))
        self.keys = key_stream(traffic["keys"], seed)

    def _frame(self, _pass, img):
        self.last[0] = img

    def setup(self) -> None:
        self.session.render_now()

    def window(self, seconds: float, phases: bool) -> Window:
        s, frames, applied = self.session, [], []
        start = time.perf_counter()
        while True:
            k = next(self.keys)
            self.last[0] = None
            t = time.perf_counter()
            with PhaseCapture(phases) as cap:
                if k in editor.MOVES:
                    s.move_key(k)
                else:
                    s.arrow_key(k)
                img = s.render_now()
            lat = time.perf_counter() - t
            applied.append(k)
            st = self.renderer.stats
            frames.append(Render(self.render_seed, img, self.last[0], int(st.ray_segments),
                                 int(st.nonfinite), st.wall_seconds, lat, cap.phases, keys=len(applied),
                                 error=None if s.error is None else repr(s.error)))
            if time.perf_counter() - start >= seconds:
                break
        return Window(frames, start, time.perf_counter(), keys=applied)

    def close(self) -> None:
        self.session = self.renderer = None


def compared(window: Window, traffic: dict, scene_json: dict, rng):
    """What the check traces: the slowest frame and ``frames - 1`` others
    drawn from the seed, each with the camera its keys left, and no
    segment estimate."""
    renders = window.renders
    ok = [i for i, r in enumerate(renders) if r.error is None]
    order = [max(ok, key=lambda i: renders[i].latency_s)]
    order += [int(i) for i in rng.permutation([i for i in ok if i != order[0]])[: traffic["check"]["frames"] - 1]]
    cameras = []
    for i in order:
        cam = lanes.load_scene(scene_json).camera
        for k in window.keys[: renders[i].keys]:
            editor.apply_key(cam, k)
        cameras.append(cam)
    return order, cameras, 0


def quantities(window: Window, work) -> dict:
    """``frame_ms_p95``: the 95th percentile (nearest rank) over all the
    window's frames of the time from a key to its finished frame; beside
    it, for the log, the frames beyond it, the frames and their median."""
    lat = [r.latency_s for r in window.renders]
    v, beyond = percentile(lat, 95)
    return {"frame_ms_p95": v * 1e3, "frames_beyond_p95": beyond, "frames": len(lat),
            "frame_ms_median": median(lat) * 1e3}
