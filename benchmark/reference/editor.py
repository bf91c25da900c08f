"""The interactive editor's camera keys (app.go:1303-1425 upstream).

WASDQE translate the camera's position and target along the world axes by
0.5; the arrows turn the target around the position by 0.05 rad of yaw or
pitch, keeping the view distance, the pitch held to +-(pi/2 - 0.1).  The
arithmetic is Python's double precision, in the order the editor does it.
"""

from __future__ import annotations

import math

__all__ = ["MOVES", "TURNS", "INVERSE", "apply_key"]

MOVE_STEP = 0.5
ROT_STEP = 0.05
PITCH_LIMIT = math.pi / 2 - 0.1

MOVES = {
    "w": (0, 0, -MOVE_STEP), "s": (0, 0, MOVE_STEP), "a": (-MOVE_STEP, 0, 0),
    "d": (MOVE_STEP, 0, 0), "q": (0, -MOVE_STEP, 0), "e": (0, MOVE_STEP, 0),
}
TURNS = {"left": (-ROT_STEP, 0.0), "right": (ROT_STEP, 0.0), "up": (0.0, ROT_STEP), "down": (0.0, -ROT_STEP)}
INVERSE = {"w": "s", "s": "w", "a": "d", "d": "a", "q": "e", "e": "q",
           "left": "right", "right": "left", "up": "down", "down": "up"}


def apply_key(cam, key: str) -> None:
    """Move or turn ``cam`` (a camera with ``position`` and ``target``
    vectors) in place by one key."""
    if key in MOVES:
        dx, dy, dz = MOVES[key]
        cam.position.x += dx
        cam.position.y += dy
        cam.position.z += dz
        cam.target.x += dx
        cam.target.y += dy
        cam.target.z += dz
        return
    d_yaw, d_pitch = TURNS[key]
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
