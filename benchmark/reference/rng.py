"""Counter-seeded per-lane RNG, bit-exact with ``path_trace_golang_tpu/ops/rng.py``.

The generator is the reference shader's xorshift-multiply hash
(gpu.go:444-458), seeded from ``px*1973 ^ py*9277 ^ frame_seed`` with a
deterministic ``base_seed + pass_index`` counter (PHYSICS.md D1).

PyTorch has no logical right shift for uint32 tensors on the CPU, so lane
states live in int64 tensors holding uint32 values (``0 <= s < 2**32``).
Each 32x32-bit multiply is split into 16-bit halves so that no product
leaves the int64 range; the low 32 bits then equal the uint32 product.
"""

from __future__ import annotations

import torch

__all__ = ["hash_u", "seed_lanes", "uniform", "LaneRng", "MASK32"]

MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_u(x: torch.Tensor) -> torch.Tensor:
    """lowbias-style avalanche hash, bit-exact with gpu.go:444-453."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def seed_lanes(px: torch.Tensor, py: torch.Tensor, frame_seed) -> torch.Tensor:
    """Initial per-lane state (gpu.go:1679): hash(px*1973 ^ py*9277 ^ seed).

    ``frame_seed`` is a Python int or an int64 tensor broadcastable to
    the lanes; it is taken mod 2**32 like a uint32."""
    px = px.to(torch.int64) & MASK32
    py = py.to(torch.int64) & MASK32
    if isinstance(frame_seed, torch.Tensor):
        fs = frame_seed.to(torch.int64) & MASK32
    else:
        fs = int(frame_seed) & MASK32
    return hash_u(_mul32(px, 1973) ^ _mul32(py, 9277) ^ fs)


def uniform(state: torch.Tensor):
    """Advance state, return (new_state, u in [0,1]) (gpu.go:455-458).

    ``u = f32(i32(state)) * 2**-32 + 0.5``: the state reinterpreted as a
    signed int32, exactly as the JAX package computes it."""
    state = hash_u(state)
    i = torch.where(state >= 2**31, state - 2**32, state)
    u = i.to(torch.float32) * (2.0**-32) + 0.5
    return state, u


class LaneRng:
    """Mutable wrapper so the integrator reads like the shader: every
    ``next()`` is one ``rng(state)`` call site."""

    __slots__ = ("state",)

    def __init__(self, state: torch.Tensor):
        self.state = state

    def next(self) -> torch.Tensor:
        self.state, u = uniform(self.state)
        return u

    def next3(self):
        return self.next(), self.next(), self.next()
