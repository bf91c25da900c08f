"""The cost of next-event estimation at 64 lights against the showcase's own.

Counterpart of the JAX package's ``tools/perf/many_lights.py``.  Above 8
lights NEE takes one draw for the start of a window of 8 consecutive
lights and one shadow ray per slot (``csrc/common.cuh::direct_light``,
the >8-light window of kernel B1): its cost follows the window, not the
light count.  The tool renders gpu_showcase (the builtin demo_showcase
where the reference file is absent) against the same scene with its
sphere lights copied up to 64 (:func:`many_light_scene`, built exactly as
the JAX tool builds it), both under the gpu contract at depth 12, in
interleaved A/B reps in one process, and prints the median slowdown
against the light ratio.

Usage: python -m path_trace_golang_tpu_torch.tools.perf.many_lights
       [reps] [width height passes] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

from . import timing

N_LIGHTS = 64


def many_light_scene(base, n_lights: int = N_LIGHTS):
    """``base`` with its sphere lights copied, small and offset, until it has
    ``n_lights`` of them (the JAX tool's loop, many_lights.py:43-66)."""
    from ...scene.model import Object, Vec3

    lights = [o for o in base.objects if o.type == "sphere_light"]
    n_base = len(lights)
    many = copy.deepcopy(base)
    i = 0
    while sum(1 for o in many.objects if o.type == "sphere_light") < n_lights:
        src = lights[i % n_base]
        i += 1
        many.objects.append(
            Object(
                id=f"L-extra-{i}",
                type="sphere_light",
                material_id=src.material_id,
                position=Vec3(
                    src.position.x + 0.9 * ((i * 37) % 13 - 6),
                    src.position.y + 0.4 * ((i * 17) % 7),
                    src.position.z + 0.9 * ((i * 23) % 11 - 5),
                ),
                size=Vec3(0.15, 0.15, 0.15),
            )
        )
    return many


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int, help="reps width height passes (3 960 540 2)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)
    reps, w, h, passes = (args.sizes + [3, 960, 540, 2][len(args.sizes):])[:4]

    import path_trace_golang_tpu_torch as pt

    dev = timing.resolve(args.device)
    print(f"device: {timing.describe(dev)} | {timing.card_line(dev)}", flush=True)
    base, label = timing.scene_named("gpu_showcase", "demo_showcase")
    many = many_light_scene(base)
    n_base = sum(1 for o in base.objects if o.type == "sphere_light")
    n_many = sum(1 for o in many.objects if o.type == "sphere_light")
    print(f"scene: {label}, {n_base} sphere lights against {n_many}", flush=True)
    cfg = pt.RenderConfig(w, h, passes, 12)

    def timed(sc, seed):
        r = pt.Renderer(contract="gpu", seed=seed, device=dev)
        t0 = time.perf_counter()
        img = r.render(sc, cfg)
        dt = time.perf_counter() - t0
        return r.stats.ray_segments / dt / 1e6, dt, float(img.mean())

    print(f"first renders of the {n_base}-light and {n_many}-light scenes ...", flush=True)
    timed(base, 1)
    timed(many, 1)
    rows = []
    for rep in range(reps):
        a, b = timed(base, 2 + rep), timed(many, 2 + rep)
        rows.append({"rep": rep, "base": dict(zip(("mrays", "secs", "img_mean"), a)),
                     "many": dict(zip(("mrays", "secs", "img_mean"), b))})
        print(f"rep {rep}: {n_base} lights {a[0]:9.1f} Mrays/s ({a[1]:.4f}s, mean {a[2]:.1f}) | {n_many} lights "
              f"{b[0]:9.1f} Mrays/s ({b[1]:.4f}s, mean {b[2]:.1f})", flush=True)
    am = sorted(r["base"]["mrays"] for r in rows)[reps // 2]
    bm = sorted(r["many"]["mrays"] for r in rows)[reps // 2]
    print(f"median: {n_base} lights {am:.1f} Mrays/s, {n_many} lights {bm:.1f} Mrays/s -> {am / bm:.2f}x slowdown "
          f"at {n_many / n_base:.1f}x lights", flush=True)
    return timing.finish("many_lights", dev, {
        "scene": label, "width": w, "height": h, "passes": passes, "depth": 12, "lights": [n_base, n_many],
        "median_mrays": [am, bm], "slowdown": am / bm, "light_ratio": n_many / n_base, "rows": rows}, args.out)


if __name__ == "__main__":
    sys.exit(main())
