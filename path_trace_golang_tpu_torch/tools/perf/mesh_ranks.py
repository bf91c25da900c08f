"""What the ranks of the mesh tools run (``mesh_scaling``, ``mesh_attrib``).

A world's ranks are spawned processes (``parallel/launch.run_world``), each
importing the module of the function it runs: this one, which imports the
port alone.  Every rank of the world calls every function with the same
arguments; a mesh is made by the whole world (``make_mesh`` is
collective), the ranks beyond it wait at the world's barriers.  Each
function returns this rank's records and the plain versions' calls it
made.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from . import timing


@contextlib.contextmanager
def _final_accum(box: dict):
    """Record, under ``box["accum"]``, the accumulator from which the mesh
    renderer finishes its final image (f32[n_pad, 3] on the host)."""
    from ...parallel import mesh as mesh_mod

    orig = mesh_mod.accum_image

    def spy(accum, w, h, count, gpu, denoise):
        if denoise:
            box["accum"] = accum.detach().cpu().numpy().copy()
        return orig(accum, w, h, count, gpu, denoise)

    mesh_mod.accum_image = spy
    try:
        yield box
    finally:
        mesh_mod.accum_image = orig


def _timed(fn, dev, reps: int = 3):
    """(first call's seconds, mean seconds of ``reps`` calls after it, the last result); each call ends
    with the card synchronised."""
    t0 = time.perf_counter()
    out = fn()
    timing.sync(dev)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    timing.sync(dev)
    return first, (time.perf_counter() - t0) / reps, out


def scaling_rank(sc, cfg_args, shapes, device, reps=3, keep_accum=False):
    """mesh_scaling: on every shape, one render (its seconds stand for the JAX tool's compile_s), then the
    mean of ``reps`` renders, on the shape's ranks."""
    import path_trace_golang_tpu_torch as pt
    from ...parallel import MeshRenderer, make_mesh

    cfg = pt.RenderConfig(*cfg_args)
    plain0 = timing.plain_calls()
    out = []
    for n_px, n_spp in shapes:
        mesh = make_mesh(n_px, n_spp, device=device)
        dist.barrier()
        if mesh.get_coordinate() is None:
            continue
        r = MeshRenderer(mesh, contract="gpu", seed=11, device=device)
        box = {}
        with _final_accum(box):
            first, secs, img = _timed(lambda: r.render(sc, cfg), r.device, reps)
        lead = mesh.get_coordinate() == (0, 0)
        out.append({"shape": (n_px, n_spp), "first_s": first, "secs": secs, "img_mean": float(img.mean()),
                    "segments": r.stats.ray_segments, "passes": r.stats.passes, "nonfinite": r.stats.nonfinite,
                    "img": img if lead else None, "accum": box["accum"] if lead and keep_accum else None})
    dist.barrier()
    return {"records": out, "plain_calls": timing.plain_calls() - plain0}


def band_walls(sc, cfg, n_px: int, n_spp: int, device) -> list:
    """Each px band's shard wall: the seconds that one rank, alone on its device, takes for the work that
    band's rank does in a render on an ``n_px`` x ``n_spp`` mesh (its lanes, its dispatches' pass windows;
    without the collectives, the pack and the image), each band timed once after a warm-up of band 0."""
    import path_trace_golang_tpu_torch as pt
    from ...integrator import trace_config_for_scene
    from ...parallel import mesh as mesh_mod

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    w, h = cfg.width, cfg.height
    pack = pt.pack_scene(sc, w, h, device=dev)
    tcfg = trace_config_for_scene(pack, sc, cfg.max_depth, "gpu")
    passes = max(1, cfg.samples_per_px)
    window, dispatches = mesh_mod.dispatch_plan(tcfg, passes, n_spp)
    n_pad = -(-w * h // n_px) * n_px
    block = n_pad // n_px
    kw = dict(tcfg=tcfg, width=w, height=h, n_strata=4, samples=16, has_aperture=sc.camera.aperture > 0,
              normalize_pass=False, n_passes=window)

    def band(b):
        for d in range(dispatches):
            mesh_mod.render_block(pack, (11 + d * n_spp * window) & 0xFFFFFFFF, b * block, block, **kw)
        timing.sync(dev)

    band(0)
    walls = []
    for b in range(n_px):
        t0 = time.perf_counter()
        band(b)
        walls.append(time.perf_counter() - t0)
    return walls


def attrib_rank(sc, cfg_args, shapes, device, reps=3):
    """mesh_attrib: on every shape, the mesh's wall, the band walls (rank 0 alone), the JAX tool's shard wall
    (rank 0 alone on a 1x1 mesh: h // n_px rows, spp // n_spp passes) and the tiny wall (the same mesh on
    8x8, 1 pass, depth 2)."""
    import path_trace_golang_tpu_torch as pt
    from ...parallel import MeshRenderer, make_mesh

    cfg = pt.RenderConfig(*cfg_args)
    w, h, spp, depth = cfg_args
    plain0 = timing.plain_calls()
    one = make_mesh(1, 1, device=device)
    out = []
    for n_px, n_spp in shapes:
        mesh = make_mesh(n_px, n_spp, device=device)
        dist.barrier()
        rec = {"shape": (n_px, n_spp)}
        if mesh.get_coordinate() is not None:
            r = MeshRenderer(mesh, contract="gpu", seed=11, device=device)
            _, rec["wall"], img = _timed(lambda: r.render(sc, cfg), r.device, reps)
            rec["img_mean"] = float(img.mean())
        dist.barrier()
        if one.get_coordinate() is not None:
            rec["band_walls"] = band_walls(sc, cfg, n_px, n_spp, device)
            r1 = MeshRenderer(one, contract="gpu", seed=11, device=device)
            shard = pt.RenderConfig(w, max(1, h // n_px), max(1, spp // n_spp), depth)
            _, rec["shard_wall"], _ = _timed(lambda: r1.render(sc, shard), r1.device, reps)
        dist.barrier()
        if mesh.get_coordinate() is not None:
            rt = MeshRenderer(mesh, contract="gpu", seed=11, device=device)
            tiny = pt.RenderConfig(8, 8, 1, 2)
            _, rec["tiny_wall"], _ = _timed(lambda: rt.render(sc, tiny), rt.device, reps)
        dist.barrier()
        out.append(rec)
    return {"records": out, "plain_calls": timing.plain_calls() - plain0}
