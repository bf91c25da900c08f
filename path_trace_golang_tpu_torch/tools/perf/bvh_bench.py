"""The perf probes' test mesh: the UV sphere of the JAX package's
``tools/perf/bvh_bench.py`` (its ``uv_sphere``, the same vertices and faces
in the same order), without the JAX benchmark around it."""

from __future__ import annotations

import numpy as np


def uv_sphere(n_lat: int, n_lon: int, center=(0.0, 1.0, 0.0), radius=1.0):
    """Indexed UV-sphere mesh: 2 * n_lat * n_lon triangles, as lists of
    (x, y, z) vertex tuples and (a, b, c) index triples."""
    cx, cy, cz = center
    verts = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append(
                (
                    cx + radius * np.sin(theta) * np.cos(phi),
                    cy + radius * np.cos(theta),
                    cz + radius * np.sin(theta) * np.sin(phi),
                )
            )
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            faces.append((a, b, c))
            faces.append((b, d, c))
    return verts, faces
