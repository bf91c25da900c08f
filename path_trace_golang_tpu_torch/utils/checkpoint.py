"""Render checkpoint / exact resume.

Counterpart of the JAX package's ``utils/checkpoint.py``, whose file format
and digest it keeps, so that a checkpoint written by either package loads
in the other.  A pass is a pure function of (scene, seed, pass index), so
serializing ``(accumulation buffer, pass count, base seed, scene digest,
config)`` gives bit-exact resume: re-rendering passes ``k..n`` after a
restart produces the same image as an uninterrupted run with the same
checkpoint settings (the same pass windows).

The digest covers the scene, the frame size, the depth, the contract, the
normalization and the samples of a pass; like the JAX package's it does
not cover ``faithful_fog`` (ROADMAP.md Queue C).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

__all__ = [
    "Checkpoint",
    "scene_digest",
    "save_checkpoint",
    "load_checkpoint",
    "rotate_checkpoints",
]

FORMAT_VERSION = 1


@dataclasses.dataclass
class Checkpoint:
    accum: np.ndarray  # f32[n_pad, 3] running radiance sums
    passes: int  # accumulated pass count
    seed: int  # base seed (pass k used seed + k)
    digest: str  # scene+config digest the buffer belongs to
    width: int
    height: int

    def compatible_with(self, digest: str, passes_done: Optional[int] = None) -> bool:
        """Whether the buffer belongs to a render of ``digest`` (the JAX
        package's signature; ``passes_done`` is not consulted there either)."""
        return self.digest == digest


def scene_digest(sc, cfg, contract: str, normalize_pass: bool, samples: int) -> str:
    """Digest of everything that determines a pass's output besides the
    pass index: scene JSON, render config, contract, sampling mode."""
    from ..scene.io import dumps

    h = hashlib.sha256()
    h.update(dumps(sc).encode())
    h.update(
        json.dumps(
            {
                "w": cfg.width,
                "h": cfg.height,
                "depth": cfg.max_depth,
                "contract": contract,
                "normalize": normalize_pass,
                "samples": samples,
                "v": FORMAT_VERSION,
            }
        ).encode()
    )
    return h.hexdigest()


def rotate_checkpoints(path: str, keep: int) -> None:
    """Shift ``path`` into a ``.1 .. .keep`` rotation (``.keep`` dropped).

    Called before each overwrite when ``PATHTRACER_CHECKPOINT_KEEP`` (or
    ``Renderer(checkpoint_keep=...)``) is > 0, so that a logically bad
    state (a scene edited mid-render) leaves older generations to resume
    from; saves are atomic already."""
    if keep <= 0 or not os.path.exists(path):
        return
    oldest = f"{path}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for i in range(keep - 1, 0, -1):
        src = f"{path}.{i}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i + 1}")
    os.replace(path, f"{path}.1")


def save_checkpoint(path: str, ckpt: Checkpoint, keep: int = 0) -> None:
    """Write ``ckpt`` to ``path`` (compressed ``.npz``): first to a
    temporary file, then renamed over ``path``, so that a crash leaves the
    old checkpoint or the new one, never none."""
    tmp = f"{path}.tmp.npz"  # np.savez appends .npz to a name without it
    np.savez_compressed(
        tmp,
        accum=np.asarray(ckpt.accum, np.float32),
        passes=np.int64(ckpt.passes),
        seed=np.int64(ckpt.seed),
        digest=np.bytes_(ckpt.digest.encode()),
        width=np.int64(ckpt.width),
        height=np.int64(ckpt.height),
        version=np.int64(FORMAT_VERSION),
    )
    rotate_checkpoints(path, keep)
    os.replace(tmp, path)


def _load_one(path: str) -> Optional[Checkpoint]:
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if int(z["version"]) != FORMAT_VERSION:
                return None
            return Checkpoint(
                accum=np.asarray(z["accum"], np.float32),
                passes=int(z["passes"]),
                seed=int(z["seed"]),
                digest=bytes(z["digest"]).decode(),
                width=int(z["width"]),
                height=int(z["height"]),
            )
    except (OSError, KeyError, ValueError):
        return None


def load_checkpoint(path: str, keep: int = 0) -> Optional[Checkpoint]:
    """Load ``path``, falling back to the ``.1 .. .keep`` rotation
    generations when it is missing or unreadable (newest first)."""
    ckpt = _load_one(path)
    if ckpt is not None:
        return ckpt
    for i in range(1, keep + 1):
        ckpt = _load_one(f"{path}.{i}")
        if ckpt is not None:
            return ckpt
    return None
