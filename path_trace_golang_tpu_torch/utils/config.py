"""Environment-variable configuration, parity with the reference.

The reference reads env vars once via sync.Once with optional UI overrides
(gpu.go:50-202, renderer.go:117-129).  Same names, same defaults:

* ``PATHTRACER_GPU_DENOISE`` on/off (default on),
  ``PATHTRACER_GPU_DENOISE_SIGMA_S`` (1.0), ``_SIGMA_R`` (0.15)
* ``PATHTRACER_GPU_SMOOTH`` on/off (default off),
  ``PATHTRACER_GPU_SMOOTH_RADIUS`` (2, clamped 1..5), ``_STRENGTH`` (0.5)
* ``PATHTRACER_CHUNK`` — pixel lanes per kernel launch (the reference's
  worker-count knob, renderer.go:117-129).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = [
    "DenoiseConfig",
    "SmoothConfig",
    "get_denoise_config",
    "set_denoise_config_from_ui",
    "get_smooth_config",
    "set_smooth_config_from_ui",
    "get_chunk_size",
    "reset_cache",
    "switch_on",
]

_TRUE = ("1", "true", "on", "yes")
_SWITCH_ON = ("1", "true", "on")
_FALSE = ("0", "false", "off", "no")


def switch_on(name: str) -> bool:
    """A switch of the JAX package's form (``PATHTRACER_NO_REGEN`` and its
    kind): "1", "true" or "on" sets it, read anew on every call."""
    return os.environ.get(name, "") in _SWITCH_ON


@dataclasses.dataclass
class DenoiseConfig:
    enabled: bool = True
    sigma_s: float = 1.0
    sigma_r: float = 0.15


@dataclasses.dataclass
class SmoothConfig:
    enabled: bool = False
    radius: int = 2
    strength: float = 0.5


_denoise_cache: Optional[DenoiseConfig] = None
_denoise_override: Optional[DenoiseConfig] = None
_smooth_cache: Optional[SmoothConfig] = None
_smooth_override: Optional[SmoothConfig] = None


def _parse_bool(value: str, default: bool) -> bool:
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    return default


def get_denoise_config() -> DenoiseConfig:
    """gpu.go:66-99 semantics: env read once, UI override wins."""
    global _denoise_cache
    if _denoise_override is not None:
        return _denoise_override
    if _denoise_cache is None:
        cfg = DenoiseConfig()
        if v := os.environ.get("PATHTRACER_GPU_DENOISE", ""):
            cfg.enabled = _parse_bool(v, cfg.enabled)
        if v := os.environ.get("PATHTRACER_GPU_DENOISE_SIGMA_S", ""):
            try:
                f = float(v)
                if f > 0:
                    cfg.sigma_s = f
            except ValueError:
                pass
        if v := os.environ.get("PATHTRACER_GPU_DENOISE_SIGMA_R", ""):
            try:
                f = float(v)
                if f > 0:
                    cfg.sigma_r = f
            except ValueError:
                pass
        _denoise_cache = cfg
    return _denoise_cache


def set_denoise_config_from_ui(enabled: bool, sigma_s: float, sigma_r: float) -> None:
    """SetDenoiseConfigFromUI (gpu.go:103-116)."""
    global _denoise_override
    _denoise_override = DenoiseConfig(
        enabled=enabled,
        sigma_s=sigma_s if sigma_s > 0 else 1.0,
        sigma_r=sigma_r if sigma_r > 0 else 0.15,
    )


def get_smooth_config() -> SmoothConfig:
    """gpu.go:135-180 semantics."""
    global _smooth_cache
    if _smooth_override is not None:
        return _smooth_override
    if _smooth_cache is None:
        cfg = SmoothConfig()
        if v := os.environ.get("PATHTRACER_GPU_SMOOTH", ""):
            cfg.enabled = _parse_bool(v, cfg.enabled)
        if v := os.environ.get("PATHTRACER_GPU_SMOOTH_RADIUS", ""):
            try:
                cfg.radius = min(5, max(1, int(v)))
            except ValueError:
                pass
        if v := os.environ.get("PATHTRACER_GPU_SMOOTH_STRENGTH", ""):
            try:
                cfg.strength = min(1.0, max(0.0, float(v)))
            except ValueError:
                pass
        _smooth_cache = cfg
    return _smooth_cache


def set_smooth_config_from_ui(enabled: bool, radius: int, strength: float) -> None:
    """SetSmoothConfigFromUI (gpu.go:183-202)."""
    global _smooth_override
    _smooth_override = SmoothConfig(
        enabled=enabled,
        radius=min(5, max(1, int(radius))),
        strength=min(1.0, max(0.0, float(strength))),
    )


def reset_cache() -> None:
    """Drop the read-once caches and UI overrides (tests; the reference's
    sync.Once has no reset — this is a test-harness extension)."""
    global _denoise_cache, _denoise_override, _smooth_cache, _smooth_override
    _denoise_cache = None
    _denoise_override = None
    _smooth_cache = None
    _smooth_override = None


def get_chunk_size(default: int = 1 << 18) -> int:
    """Lanes processed per device dispatch (the NumCPU/PATHTRACER_WORKERS
    analog, renderer.go:117-129)."""
    if v := os.environ.get("PATHTRACER_CHUNK", ""):
        try:
            n = int(v)
            if n > 0:
                return n
        except ValueError:
            pass
    return default
