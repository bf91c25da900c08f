"""The port's browser viewer (viewer.py, a stdlib HTTP server around the
port's InteractiveSession) on a session that renders on the CPU: the five
behaviours of tests/test_viewer.py, over localhost only.  Frames are read
with the tests' own PNG reader (the card's machine has no PIL)."""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch import scene as TS
from path_trace_golang_tpu_torch.interactive import InteractiveSession
from path_trace_golang_tpu_torch.scene.model import RenderSettings
from path_trace_golang_tpu_torch.viewer import ViewerServer

from torch_png import decode_png


@pytest.fixture()
def server(tmp_path):
    from path_trace_golang_tpu import scene as JS

    from helpers import lambert_floor_scene

    sc = TS.loads(JS.dumps(lambert_floor_scene()))
    sc.settings = RenderSettings(width=32, height=24, samples_per_px=1, max_depth=3)
    session = InteractiveSession(sc, mode="preview", renderer=tpt.Renderer(chunk=32 * 24, device="cpu"))
    srv = ViewerServer(session, port=0, save_dir=str(tmp_path))  # ephemeral port on 127.0.0.1
    srv.start_background()
    yield srv
    srv.shutdown()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as r:
        return r.status, r.read()


def test_viewer_page_and_frame(server):
    code, body = _get(server, "/")
    assert code == 200 and b"progressive viewer" in body

    server.session.render_now(False)
    deadline = time.time() + 60
    png = b""
    while time.time() < deadline:
        try:
            code, png = _get(server, "/frame.png")
            if code == 200:
                break
        except urllib.error.HTTPError:
            pass
        time.sleep(0.2)
    assert decode_png(png).shape == (24, 32, 3)
    # the frame is the session's last progress frame: the cpu contract's
    # preview frame is its final image
    assert np.array_equal(decode_png(png), server.session.last_preview)

    code, status = _get(server, "/status")
    st = json.loads(status)
    assert st["gen"] >= 1 and st["pass"] >= 1


def test_viewer_long_poll_pushes_on_new_frame(server):
    """/status?wait=1 blocks until the NEXT frame generation (push, not
    poll): issued with gen=-1 after a render it returns at once, and a
    repeat with the current gen blocks until a new frame lands."""
    server.session.render_now(False)
    code, status = _get(server, "/status?wait=1&gen=-1")
    st = json.loads(status)
    assert code == 200 and st["gen"] >= 1

    got = {}

    def waiter():
        _code, body = _get(server, f"/status?wait=1&gen={st['gen']}")
        got["st"] = json.loads(body)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    t.join(timeout=1.0)
    assert t.is_alive(), "long-poll returned without a new frame"
    server.session.render_now(False)  # new frame releases the waiter
    t.join(timeout=60)
    assert not t.is_alive() and got["st"]["gen"] > st["gen"]


def test_viewer_sse_stream(server):
    """/events emits one SSE data event per frame."""
    import socket

    server.session.render_now(False)
    with socket.create_connection(("127.0.0.1", server.port), timeout=30) as s:
        s.sendall(b"GET /events HTTP/1.1\r\nHost: x\r\n\r\n")
        s.settimeout(30)
        buf = b""
        deadline = time.time() + 60
        while b"\ndata: " not in buf and time.time() < deadline:
            buf += s.recv(4096)
        payload = buf.split(b"\ndata: ", 1)[1].split(b"\n", 1)[0]
        st = json.loads(payload)
        assert st["gen"] >= 1 and "mrays" in st


def test_viewer_key_and_save(server, tmp_path):
    server.session.render_now(False)
    cam = server.session.scene.camera
    z0 = cam.position.z
    code, body = _get(server, "/key?k=w")
    assert code == 200 and json.loads(body)["ok"]
    assert cam.position.z == z0 - 0.5

    code, body = _get(server, "/key?k=zz")
    assert not json.loads(body)["ok"]

    out = tmp_path / "v.png"
    code, body = _get(server, f"/save?path={out}")
    assert code == 200 and json.loads(body)["saved"] == str(out)
    assert decode_png(out.read_bytes()).shape == (24, 32, 3)


def test_viewer_save_rejects_escaping_paths(server):
    """/save is confined to the configured save_dir: traversal and
    absolute paths outside it return 400."""
    server.session.render_now(True)
    deadline = time.time() + 60
    while server.session.last_final is None and time.time() < deadline:
        time.sleep(0.1)

    for bad in ("../escape.png", "/etc/escape.png", "a/../../escape.png"):
        quoted = urllib.parse.quote(bad)
        try:
            code, body = _get(server, f"/save?path={quoted}")
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read()
        assert code == 400, bad
        assert b"escapes" in body

    # a relative path inside save_dir still works
    code, body = _get(server, "/save?path=ok.png")
    assert code == 200
