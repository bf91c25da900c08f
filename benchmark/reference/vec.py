"""Component-wise 3-vectors over lane tensors.

Every lane quantity is a float32 tensor of one shape (flat ``[N]`` lanes in
this package; the JAX package's ``[rows, 128]`` grids work as well) and
every 3-D vector is a :class:`V3` of three such tensors, so all vector math
stays element-wise, as in ``path_trace_golang_tpu/ops/vec.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["V3"]

F32 = torch.float32


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # --- arithmetic (elementwise; scalar or V3 operands) ---
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def length(self):
        return torch.sqrt(torch.clamp_min(self.length_sq(), 0.0))

    def normalize(self, eps=1e-20) -> "V3":
        inv = 1.0 / torch.sqrt(torch.clamp_min(self.length_sq(), eps))
        return V3(self.x * inv, self.y * inv, self.z * inv)

    def max_comp(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def exp(self) -> "V3":
        return V3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    def any_positive(self):
        return (self.x > 0) | (self.y > 0) | (self.z > 0)

    # --- selection / construction ---
    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(
            torch.where(mask, a.x, b.x),
            torch.where(mask, a.y, b.y),
            torch.where(mask, a.z, b.z),
        )

    @classmethod
    def full_like(cls, ref: torch.Tensor, vx, vy=None, vz=None) -> "V3":
        vy = vx if vy is None else vy
        vz = vx if vz is None else vz
        return cls(
            torch.full_like(ref, vx, dtype=F32),
            torch.full_like(ref, vy, dtype=F32),
            torch.full_like(ref, vz, dtype=F32),
        )

    @classmethod
    def zeros_like(cls, ref: torch.Tensor) -> "V3":
        z = torch.zeros_like(ref, dtype=F32)
        return cls(z, z, z)

    @classmethod
    def broadcast_scalars(cls, ref: torch.Tensor, sx, sy, sz) -> "V3":
        """Lift three 0-d tensors to the lane shape of ``ref``."""
        return cls(
            sx.expand(ref.shape), sy.expand(ref.shape), sz.expand(ref.shape)
        )

    def to_rows(self):
        """V3 of [...] -> [..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)
