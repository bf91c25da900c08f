"""Interactive editing session: the Fyne GUI replaced by an API + streaming.

Counterpart of the JAX package's ``interactive.py``.  The reference's
`internal/ui/app.go` is a Fyne widget tree around four behaviors; this
module reproduces those behaviors as a headless, embeddable session object
(SURVEY.md §7 hard-part 6), rendering through the port's ``Renderer``
(on the card unless it was made with ``device="cpu"``) from a background
thread, whose kernels launch on that thread's current stream:

* **live preview loop** — every edit schedules a debounced (200 ms,
  app.go:234-264) cancellable re-render on a worker thread; progressive
  frames stream to an ``on_frame`` callback instead of a Fyne canvas
  (doRender, app.go:134-224).
* **quality modes** — settings = mode preset overridden by the scene's
  settings block (app.go:61-70); final renders use preview spp x4 and
  depth x2 (app.go:72-75); the last final frame is cached for
  ``save_image`` without re-rendering (app.go:203-215, 1132-1158).
* **camera control** — WASDQE translation (step 0.5) and arrow-key
  yaw/pitch rotation (0.05 rad, pitch clamped to ±(π/2 − 0.1)), exactly
  the key handler math of app.go:1303-1425.
* **scene editing** — materials/objects/fog/settings mutate the live
  scene then reschedule the preview; ``save_scene`` writes the JSON back
  (app.go:1124-1130); denoise/smooth overrides forward to the env-config
  layer like SetDenoiseConfigFromUI (app.go:185-188).

A tiny terminal front-end (`run_terminal`) drives the same session for
manual use over SSH.  A render that raises reports the error on the status
line and keeps it in ``error`` (None after a render that ended well).

Each frame is one request of the span recorder (``utils/metrics.py``): its
``session.frame`` span opens at the first edit since the last frame
started (or at ``render_now``) and closes when the frame is published,
and holds ``session.edit``, ``session.cancel``, ``session.join``,
``session.handoff``, ``session.scene_copy``, the Renderer's ``render`` (on
the render thread, under the same request id) and ``session.publish``;
its counters ``debounce_scheduled`` and ``debounce_cancelled``.  ``spans``
holds the last finished frame's.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

from . import render as R
from .io_png import save_png
from .scene import io as scene_io
from .scene.model import RenderSettings, Scene
from .utils import config as env_config
from .utils import metrics

__all__ = ["InteractiveSession"]

DEBOUNCE_SECONDS = 0.2  # app.go:251 (200 ms)
MOVE_STEP = 0.5  # app.go:1304
ROT_STEP = 0.05  # app.go:1305
PITCH_LIMIT = math.pi / 2 - 0.1  # app.go:1378,1398


class InteractiveSession:
    """Headless interactive renderer with the reference UI's behaviors."""

    def __init__(
        self,
        sc: Scene,
        mode: str = "preview",
        scene_path: Optional[str] = None,
        on_frame: Optional[Callable[[int, np.ndarray], None]] = None,
        on_status: Optional[Callable[[str], None]] = None,
        renderer: Optional[R.Renderer] = None,
    ):
        self.scene = sc
        self.scene_path = scene_path
        self.mode = mode
        self.on_frame = on_frame
        self.on_status = on_status or (lambda s: None)
        self.renderer = renderer or R.Renderer()

        # settings: scene block overrides mode preset where set (app.go:61-70)
        preset = R.render_settings_for_mode(mode)
        s = sc.settings
        self.settings = RenderSettings(
            width=s.width or preset.width,
            height=s.height or preset.height,
            samples_per_px=s.samples_per_px or preset.samples_per_px,
            max_depth=s.max_depth or preset.max_depth,
        )

        self.fps = 0.0
        self.last_preview: Optional[np.ndarray] = None
        self.last_final: Optional[np.ndarray] = None  # cached (app.go:203-215)
        self.error: Optional[BaseException] = None  # the last render's failure

        self._lock = threading.Lock()
        self._debounce: Optional[threading.Timer] = None
        self._cancel_flag = threading.Event()
        self._render_thread: Optional[threading.Thread] = None
        self._generation = 0
        self._pending = None  # (trace, its session.frame span) of the next frame
        self.spans: list = []  # the last finished frame's spans (utils/metrics.py)

    # ------------------------------------------------------------------
    # render loop
    # ------------------------------------------------------------------

    def _frame(self, take: bool = False):
        """The (trace, ``session.frame`` span) of the frame that the next
        render publishes, opened by the first edit since the last one
        started; ``take`` starts it, so that the next edit opens another."""
        with self._lock:
            frame = self._pending
            if frame is None:
                trace = metrics.Trace()
                frame = (trace, trace.open("session.frame"))
            self._pending = None if take else frame
            return frame

    def _cancel_debounce(self, trace) -> None:
        # under self._lock
        if self._debounce is not None:
            if not self._debounce.finished.is_set():
                trace.count("debounce_cancelled")
            self._debounce.cancel()

    def request_render(self, final: bool = False) -> None:
        """Debounced, cancellable re-render (startRender, app.go:234-264)."""
        trace, _root = self._frame()
        with self._lock:
            self._cancel_debounce(trace)
            self._cancel_flag.set()  # cooperative cancel of the running render
            self._generation += 1
            gen = self._generation
            self._debounce = threading.Timer(
                DEBOUNCE_SECONDS, self._start_render, args=(final, gen)
            )
            self._debounce.daemon = True
            self._debounce.start()
            trace.count("debounce_scheduled")

    def render_now(self, final: bool = False) -> np.ndarray:
        """Synchronous render (used by the terminal front-end and tests)."""
        trace, root = self._frame()
        with metrics.bound(trace, root), metrics.span("session.cancel"), self._lock:
            self._cancel_debounce(trace)
            self._cancel_flag.set()
            self._generation += 1
            gen = self._generation
        self._start_render(final, gen, wait=True)
        return self.last_final if final else self.last_preview

    def _config(self, final: bool) -> R.RenderConfig:
        s = self.settings
        if final:
            # final = preview spp x4, depth x2 (app.go:72-75)
            return R.RenderConfig(s.width, s.height, s.samples_per_px * 4, s.max_depth * 2)
        return R.RenderConfig(s.width, s.height, s.samples_per_px, s.max_depth)

    def _start_render(self, final: bool, gen: int, wait: bool = False):
        trace, root = self._frame(take=True)
        with metrics.bound(trace, root):
            prev = self._render_thread
            if prev is not None and prev.is_alive():
                with metrics.span("session.join"):
                    prev.join()  # the old render stops at its next pass boundary

            self._cancel_flag = threading.Event()
            cancel_flag = self._cancel_flag
            handoff = trace.open("session.handoff", root)

        def work():
            handoff.end_ns = time.perf_counter_ns()
            try:
                with metrics.bound(trace, root):
                    self._work(final, gen, wait, cancel_flag)
            finally:
                self.spans = trace.spans
                trace.finish(root)

        th = threading.Thread(target=work, daemon=True)
        self._render_thread = th
        th.start()
        if wait:
            th.join()
        return th

    def _work(self, final: bool, gen: int, wait: bool, cancel_flag: threading.Event) -> None:
        t0 = time.perf_counter()
        with metrics.span("session.scene_copy"):
            sc = self.scene.copy()  # render a snapshot; edits keep flowing
            cfg = self._config(final)
        self.on_status(f"rendering {'final' if final else 'preview'} {cfg.width}x{cfg.height}")

        def progress(pass_idx, img):
            if gen == self._generation and self.on_frame is not None:
                self.on_frame(pass_idx, img)

        try:
            img = self.renderer.render(
                sc, cfg, progress=progress, cancel=lambda: cancel_flag.is_set()
            )
        except Exception as e:  # surface render errors to the status line
            self.error = e
            self.on_status(f"render error: {e!r}")
            return
        with metrics.span("session.publish"):
            self.error = None
            elapsed = time.perf_counter() - t0
            self.fps = 1.0 / elapsed if elapsed > 0 else 0.0  # app.go:217-220
            if gen == self._generation or wait:
                if final:
                    self.last_final = img
                else:
                    self.last_preview = img
                self.on_status(
                    f"done in {elapsed:.2f}s ({self.fps:.2f} fps, "
                    f"{self.renderer.stats.mrays_per_sec:.1f} Mrays/s)"
                )

    # ------------------------------------------------------------------
    # camera control (app.go:1303-1425)
    # ------------------------------------------------------------------

    def move_key(self, key: str) -> bool:
        """WASDQE world-axis translation of position AND target."""
        cam = self.scene.camera
        delta = {
            "w": (0, 0, -MOVE_STEP),
            "s": (0, 0, MOVE_STEP),
            "a": (-MOVE_STEP, 0, 0),
            "d": (MOVE_STEP, 0, 0),
            "q": (0, -MOVE_STEP, 0),
            "e": (0, MOVE_STEP, 0),
        }.get(key.lower())
        if delta is None:
            return False
        with metrics.bound(*self._frame()), metrics.span("session.edit"):
            dx, dy, dz = delta
            cam.position.x += dx
            cam.position.y += dy
            cam.position.z += dz
            cam.target.x += dx
            cam.target.y += dy
            cam.target.z += dz
            self.request_render(False)
        return True

    def rotate(self, d_yaw: float = 0.0, d_pitch: float = 0.0) -> None:
        """Arrow-key yaw/pitch: rotate the target around the position,
        preserving the view distance, pitch clamped (app.go:1336-1412)."""
        with metrics.bound(*self._frame()), metrics.span("session.edit"):
            cam = self.scene.camera
            dx = cam.target.x - cam.position.x
            dy = cam.target.y - cam.position.y
            dz = cam.target.z - cam.position.z
            yaw = math.atan2(dz, dx)
            pitch = math.atan2(dy, math.hypot(dx, dz))
            r = math.sqrt(dx * dx + dy * dy + dz * dz)
            yaw += d_yaw
            pitch = max(-PITCH_LIMIT, min(PITCH_LIMIT, pitch + d_pitch))
            cam.target.x = cam.position.x + r * math.cos(pitch) * math.cos(yaw)
            cam.target.y = cam.position.y + r * math.sin(pitch)
            cam.target.z = cam.position.z + r * math.cos(pitch) * math.sin(yaw)
            self.request_render(False)

    def arrow_key(self, key: str) -> bool:
        step = {
            "left": (-ROT_STEP, 0.0),
            "right": (ROT_STEP, 0.0),
            "up": (0.0, ROT_STEP),
            "down": (0.0, -ROT_STEP),
        }.get(key.lower())
        if step is None:
            return False
        self.rotate(*step)
        return True

    # ------------------------------------------------------------------
    # scene editing (material/object/fog/settings forms)
    # ------------------------------------------------------------------

    def set_backend(self, backend: str) -> None:
        R.set_backend(backend)
        self.request_render(False)

    def edit_material(self, mat_id: str, **fields) -> bool:
        for m in self.scene.materials:
            if m.id == mat_id:
                for k, v in fields.items():
                    if not hasattr(m, k):
                        raise AttributeError(f"material has no field {k!r}")
                    setattr(m, k, v)
                self.request_render(False)
                return True
        return False

    def edit_object(self, obj_id: str, **fields) -> bool:
        for o in self.scene.objects:
            if o.id == obj_id:
                for k, v in fields.items():
                    if not hasattr(o, k):
                        raise AttributeError(f"object has no field {k!r}")
                    setattr(o, k, v)
                self.request_render(False)
                return True
        return False

    def add_object(self, obj) -> None:
        self.scene.objects.append(obj)
        self.request_render(False)

    def remove_object(self, obj_id: str) -> bool:
        before = len(self.scene.objects)
        self.scene.objects = [o for o in self.scene.objects if o.id != obj_id]
        if len(self.scene.objects) != before:
            self.request_render(False)
            return True
        return False

    def edit_fog(self, **fields) -> None:
        from .scene.model import Fog

        if self.scene.fog is None:
            self.scene.fog = Fog()
        for k, v in fields.items():
            if not hasattr(self.scene.fog, k):
                raise AttributeError(f"fog has no field {k!r}")
            setattr(self.scene.fog, k, v)
        self.request_render(False)

    def edit_settings(self, **fields) -> None:
        for k, v in fields.items():
            if not hasattr(self.settings, k):
                raise AttributeError(f"settings has no field {k!r}")
            setattr(self.settings, k, v)
        self.request_render(False)

    def set_denoise(self, enabled: bool, sigma_s: float = 1.0, sigma_r: float = 0.15) -> None:
        env_config.set_denoise_config_from_ui(enabled, sigma_s, sigma_r)
        self.request_render(False)

    def set_smooth(self, enabled: bool, radius: int = 2, strength: float = 0.5) -> None:
        env_config.set_smooth_config_from_ui(enabled, radius, strength)
        self.request_render(False)

    # ------------------------------------------------------------------
    # persistence (app.go:1124-1158)
    # ------------------------------------------------------------------

    def save_scene(self, path: Optional[str] = None) -> str:
        path = path or self.scene_path
        if not path:
            raise ValueError("no scene path")
        scene_io.save(path, self.scene)
        return path

    def save_image(self, path: str) -> str:
        """Save the cached final render, rendering one if needed
        (app.go:1132-1158)."""
        if self.last_final is None:
            self.render_now(final=True)
        save_png(path, self.last_final)
        return path

    # ------------------------------------------------------------------
    # terminal front-end
    # ------------------------------------------------------------------

    def run_terminal(self, out_path: str = "preview.png") -> None:  # pragma: no cover
        """Minimal REPL: wasdqe move, ijkl rotate, f=final, p=save png,
        o=save scene, b=toggle backend, x=quit.  Each action re-renders and
        writes the preview to ``out_path``."""
        print(
            "interactive: wasdqe=move ijkl=rotate f=final p=save-png "
            f"o=save-scene b=backend x=quit (frames -> {out_path})",
            file=sys.stderr,
        )
        self.on_status = lambda s: print(s, file=sys.stderr)
        img = self.render_now(False)
        save_png(out_path, img)
        arrow = {"i": "up", "k": "down", "j": "left", "l": "right"}
        while True:
            try:
                cmd = input("> ").strip()
            except EOFError:
                break
            if not cmd:
                continue
            if cmd == "x":
                break
            if cmd == "f":
                img = self.render_now(True)
                save_png(out_path, img)
                continue
            if cmd == "p":
                self.save_image(out_path)
                continue
            if cmd == "o":
                print("saved", self.save_scene(), file=sys.stderr)
                continue
            if cmd == "b":
                R.set_backend(
                    R.BACKEND_CPU if R.get_backend() == R.BACKEND_GPU else R.BACKEND_GPU
                )
                print("backend:", R.get_backend(), file=sys.stderr)
            for ch in cmd:
                if ch in arrow:
                    self.arrow_key(arrow[ch])
                else:
                    self.move_key(ch)
            img = self.render_now(False)
            save_png(out_path, img)
