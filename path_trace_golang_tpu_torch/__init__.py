"""path_trace_golang_tpu_torch — the path tracer in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``path_trace_golang_tpu`` (which stays the
reference) to PyTorch on an NVIDIA H100: same scene format, same packed
layouts, same counter-seeded RNG, same two physics contracts.  The hot
path, a whole progressive pass per pixel lane, is a CUDA C++ kernel
(``csrc/render_pass.cu`` for the gpu contract's regeneration loop,
``csrc/classic.cu`` for the classic per-sample loop of the cpu contract and
faithful fog, and for :func:`trace`); every module also runs as plain
PyTorch on the CPU, which is what the tests compare with the JAX package.

Public facade (``internal/engine`` parity):

* :func:`render_scene` / :func:`render_into` / :class:`Renderer`,
  :class:`RenderConfig`, :class:`RenderStats` (checkpoint/resume and the
  metrics log: ``utils/checkpoint.py``, ``utils/metrics.py``)
* :func:`set_backend` / :func:`get_backend` — physics-contract switch
  ("cpu", the default, or "gpu")
* :func:`trace` — trace given rays (row vectors) with the classic loop
* :func:`save_png`, :func:`pack_scene`
* ``scene`` subpackage — JSON scene model and IO
* ``python -m path_trace_golang_tpu_torch`` — the reference's CLI
  (``cli.py``, ``--device cpu`` for the CPU); :mod:`.interactive` and
  :mod:`.viewer` — the interactive session and its browser viewer

Entry points run on the card unless the caller passes ``device="cpu"``.
This package imports neither JAX nor the JAX package.
"""

from . import scene
from .integrator import trace
from .io_png import save_png
from .render import (
    BACKEND_CPU,
    BACKEND_GPU,
    RenderConfig,
    Renderer,
    RenderStats,
    get_backend,
    render_into,
    render_scene,
    render_settings_for_mode,
    set_backend,
)
from .scene.model import RenderSettings, Scene
from .soa import ScenePack, pack_from_numpy, pack_scene

__version__ = "0.1.0"

__all__ = [
    "Renderer",
    "RenderConfig",
    "RenderStats",
    "RenderSettings",
    "Scene",
    "ScenePack",
    "pack_scene",
    "pack_from_numpy",
    "render_into",
    "render_scene",
    "render_settings_for_mode",
    "save_png",
    "scene",
    "trace",
    "set_backend",
    "get_backend",
    "BACKEND_CPU",
    "BACKEND_GPU",
    "__version__",
]
