"""Browser-based progressive viewer: the Fyne window's final replacement.

Counterpart of the JAX package's ``viewer.py`` around the port's
:class:`InteractiveSession`; frames are PNG-encoded by the native tier
where its library loads, else by the port's zlib writer (``io_png``).

A dependency-free stdlib HTTP server around :class:`InteractiveSession`:
the browser polls the latest tonemapped frame while renders stream in, and
sends the same key commands the reference UI bound (WASDQE move, arrows
rotate — app.go:1303-1425) plus final-render / save actions.

    python -m path_trace_golang_tpu_torch.viewer -scene demo_cornell --port 8000 [--device cpu]

Endpoints (also usable programmatically / from tests):
  GET /            — viewer page
  GET /frame.png   — latest preview/final frame
  GET /status      — JSON: fps, Mrays/s, frame generation
  GET /status?wait=1&gen=N — long-poll: blocks until gen != N (or ~25s)
  GET /events      — Server-Sent Events: one status event per new frame
  GET /key?k=w     — camera key (w/a/s/d/q/e, left/right/up/down)
  GET /final       — trigger a final-quality render
  GET /save?path=  — save the cached final render as PNG

Frames are PUSHED: the page opens an EventSource on ``/events`` and the
server emits a status event the moment a progressive pass lands (a
condition variable signalled from the render thread's frame callback) —
no fixed 250 ms poll tick between frames.  Long-poll ``/status?wait=1``
offers the same push semantics to plain-HTTP clients and tests.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .interactive import InteractiveSession
from .io_png import encode_png

__all__ = ["ViewerServer"]

_PAGE = """<!doctype html>
<html><head><title>path_trace_golang_tpu_torch</title><style>
body{background:#111;color:#ccc;font-family:monospace;text-align:center}
img{image-rendering:pixelated;border:1px solid #333;max-width:95vw}
#s{margin:8px}</style></head><body>
<h3>path_trace_golang_tpu_torch — progressive viewer</h3>
<div id="s">connecting…</div>
<img id="v" src="/frame.png">
<div>keys: WASDQE move · arrows rotate · F final · P save</div>
<script>
let gen = -1;
function show(st){
  document.getElementById('s').textContent =
    `pass ${st.pass} · ${st.fps.toFixed(2)} fps · ${st.mrays.toFixed(1)} Mrays/s`;
  if(st.gen !== gen){ gen = st.gen;
    document.getElementById('v').src = '/frame.png?g=' + gen; }
}
// push path: the server emits one SSE event per finished progressive
// pass; no polling between frames
const es = new EventSource('/events');
es.onmessage = ev => show(JSON.parse(ev.data));
es.onerror = () => { es.close(); tick(); };  // fallback: long-poll
async function tick(){
  try{
    const st = await (await fetch('/status?wait=1&gen=' + gen)).json();
    show(st);
  }catch(e){ await new Promise(r=>setTimeout(r, 1000)); }
  tick();
}
const keys = {w:'w',a:'a',s:'s',d:'d',q:'q',e:'e',
  ArrowLeft:'left',ArrowRight:'right',ArrowUp:'up',ArrowDown:'down'};
document.addEventListener('keydown', ev=>{
  if(ev.key==='f'||ev.key==='F'){fetch('/final');return;}
  if(ev.key==='p'||ev.key==='P'){fetch('/save');return;}
  const k = keys[ev.key]; if(k) fetch('/key?k='+k);
});
</script></body></html>"""


class ViewerServer:
    """Wraps an InteractiveSession behind a threaded HTTP server."""

    def __init__(
        self,
        session: InteractiveSession,
        host: str = "127.0.0.1",
        port: int = 8000,
        save_dir: Optional[str] = None,
    ):
        self.session = session
        # /save is a remote file-write primitive; confine it to one
        # directory (default: the working directory at server start).
        self.save_dir = os.path.realpath(save_dir or os.getcwd())
        self._frame_lock = threading.Lock()
        self._frame_cond = threading.Condition(self._frame_lock)
        self._frame_png: Optional[bytes] = None
        self._gen = 0
        self._pass = 0
        session.on_frame = self._on_frame
        session.on_status = lambda s: None

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/frame.png":
                    data = viewer.frame_png()
                    if data is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", data)
                elif url.path == "/status":
                    if (q.get("wait") or ["0"])[0] in ("1", "true"):
                        last = int((q.get("gen") or ["-1"])[0])
                        viewer.wait_for_frame(last, timeout=25.0)
                    self._send(200, "application/json", viewer.status_json().encode())
                elif url.path == "/events":
                    # Server-Sent Events: push a status event per new frame
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    last = -1
                    try:
                        # initial event so the page renders immediately
                        self.wfile.write(b"retry: 1000\n")
                        while True:
                            changed = viewer.wait_for_frame(last, timeout=15.0)
                            body = viewer.status_json().encode()
                            if changed:
                                last = json.loads(body)["gen"]
                                self.wfile.write(b"data: " + body + b"\n\n")
                            else:  # heartbeat comment keeps proxies open
                                self.wfile.write(b": keep-alive\n\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError, OSError):
                        return
                elif url.path == "/key":
                    k = (q.get("k") or [""])[0]
                    ok = viewer.session.move_key(k) or viewer.session.arrow_key(k)
                    self._send(200, "application/json", json.dumps({"ok": bool(ok)}).encode())
                elif url.path == "/final":
                    viewer.session.request_render(final=True)
                    self._send(200, "application/json", b'{"ok": true}')
                elif url.path == "/save":
                    path = (q.get("path") or ["viewer_final.png"])[0]
                    resolved = viewer._resolve_save_path(path)
                    if resolved is None:
                        self._send(
                            400,
                            "application/json",
                            json.dumps({"error": "path escapes the save directory"}).encode(),
                        )
                        return
                    try:
                        out = viewer.session.save_image(resolved)
                        self._send(200, "application/json", json.dumps({"saved": out}).encode())
                    except Exception as e:
                        self._send(500, "application/json", json.dumps({"error": str(e)}).encode())
                else:
                    self._send(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]

    def _resolve_save_path(self, path: str) -> Optional[str]:
        """Resolve a /save query path inside ``save_dir``; None if it
        escapes (absolute paths, .. traversal, symlink tricks)."""
        candidate = os.path.realpath(os.path.join(self.save_dir, path))
        if candidate == self.save_dir or candidate.startswith(self.save_dir + os.sep):
            return candidate
        return None

    # -- frame plumbing ---------------------------------------------------

    def _encode(self, img: np.ndarray) -> bytes:
        return encode_png(img)  # the C++ tier where it loads, else the zlib writer

    def _on_frame(self, pass_idx: int, img: np.ndarray) -> None:
        data = self._encode(img)
        with self._frame_cond:
            self._frame_png = data
            self._gen += 1
            self._pass = pass_idx
            self._frame_cond.notify_all()

    def frame_png(self) -> Optional[bytes]:
        with self._frame_lock:
            return self._frame_png

    def wait_for_frame(self, last_gen: int, timeout: float = 25.0) -> bool:
        """Block until the frame generation differs from ``last_gen``.

        Returns True when a new frame arrived, False on timeout — the
        push primitive behind /events and /status?wait=1."""
        deadline = timeout
        with self._frame_cond:
            if self._gen != last_gen and self._frame_png is not None:
                return True
            return bool(
                self._frame_cond.wait_for(
                    lambda: self._gen != last_gen and self._frame_png is not None,
                    timeout=deadline,
                )
            )

    def status_json(self) -> str:
        with self._frame_lock:
            gen, pass_idx = self._gen, self._pass
        return json.dumps(
            {
                "gen": gen,
                "pass": pass_idx,
                "fps": self.session.fps,
                "mrays": self.session.renderer.stats.mrays_per_sec,
            }
        )

    # -- lifecycle ----------------------------------------------------------

    def serve_forever(self):  # pragma: no cover
        print(f"viewer: http://{self.httpd.server_address[0]}:{self.port}/")
        self.session.request_render(False)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()


def main(argv=None):  # pragma: no cover
    import argparse

    from .cli import load_scene
    from .render import Renderer

    p = argparse.ArgumentParser()
    p.add_argument("-scene", "--scene", default="demo_cornell")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--device", default="cuda", help="device to render on: cuda (the card, default) or cpu")
    args = p.parse_args(argv)

    sc = load_scene(args.scene)
    session = InteractiveSession(sc, mode="preview", renderer=Renderer(device=args.device))
    session.settings.width = args.width
    session.settings.height = args.height
    session.settings.samples_per_px = args.spp
    session.settings.max_depth = args.depth
    ViewerServer(session, port=args.port).serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
