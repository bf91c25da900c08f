"""Entry points for an outside harness: one pass of the flagship, and a mesh dry run.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns one progressive pass of the flagship renderer (the builtin
showcase's materials, lights and thin lens, without its fog and mesh, at
128x48, depth 6, gpu contract) as a function of tensors, with its example
arguments.  ``dryrun_multichip(n)`` renders the JAX dry run's two
configurations (the reduced contract, then the full one: fog march and
triangle mesh) at 32x16, depth 4, on an n-rank ("px", "spp") mesh spawned
by ``parallel/launch.run_world``.

Usage: python -m path_trace_golang_tpu_torch.graft_entry [--devices 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from .tools.perf import timing

WIDTH, HEIGHT, DEPTH = 128, 48, 6


def _flagship(device):
    """The compile-check flagship: demo_showcase without its fog and mesh, packed at 128x48."""
    from .integrator import trace_config_for_scene
    from .scene.builtin import demo_showcase
    from .soa import pack_scene

    sc = demo_showcase()
    sc.fog = None
    sc.objects = [o for o in sc.objects if o.type != "mesh"]
    pack = pack_scene(sc, WIDTH, HEIGHT, device=device)
    tcfg = trace_config_for_scene(pack, sc, max_depth=DEPTH, contract="gpu")
    return sc, pack, tcfg


def entry(device="cuda"):
    """(fn, example_args): one pass of 16 stratified samples a pixel through the regeneration loop, as
    ``fn(accum, mat, obj, light_idx, cam, sky, fog, frame_seed) -> (accum + pass, segments)``.  On the card
    the pass is kernel B1; on the CPU its plain version."""
    from .render import trace_pass_lanes

    _sc, pack, tcfg = _flagship(device)

    def forward(accum, mat, obj, light_idx, cam, sky, fog, frame_seed):
        # the scene's tables are the arguments; its shape and flags come from the closed-over pack
        p = dataclasses.replace(pack, mat=mat, obj=obj, light_idx=light_idx, cam=cam, sky=sky, fog=fog, _host={})
        idx = torch.arange(accum.shape[0], dtype=torch.int32, device=accum.device)
        col, segs = trace_pass_lanes(p, frame_seed, idx, tcfg=tcfg, width=WIDTH, height=HEIGHT, n_strata=4,
                                     samples=16, has_aperture=True, normalize_pass=False)
        return accum + col, segs

    accum0 = torch.zeros((WIDTH * HEIGHT, 3), dtype=torch.float32, device=pack.device)
    return forward, (accum0, pack.mat, pack.obj, pack.light_idx, pack.cam, pack.sky, pack.fog, 1)


def _dryrun_rank(n_devices: int, device: str) -> list:
    """What each rank of the dry run runs: both configurations on the n-rank mesh."""
    import path_trace_golang_tpu_torch as pt
    from .parallel import MeshRenderer, make_mesh
    from .scene.builtin import demo_showcase

    plain0 = timing.plain_calls()
    n_spp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_px = n_devices // n_spp
    mesh = make_mesh(n_px, n_spp, device=device)
    lines = []
    sc = demo_showcase()
    sc.fog = None  # config 1: the reduced contract
    sc.objects = [o for o in sc.objects if o.type != "mesh"]
    r = MeshRenderer(mesh, contract="gpu", seed=1, device=device)
    img = r.render(sc, pt.RenderConfig(32, 16, n_spp, 4))
    assert img.shape == (16, 32, 3), img.shape
    assert r.stats.ray_segments > 0
    lines.append(f"dryrun_multichip ok: mesh px={n_px} spp={n_spp}, {r.stats.ray_segments} segments, image mean "
                 f"{img.mean():.1f}")
    full = demo_showcase()  # config 2: the full contract, fog march and triangle mesh
    assert full.fog is not None and any(o.type == "mesh" for o in full.objects)
    r = MeshRenderer(mesh, contract="gpu", seed=2, device=device)
    img = r.render(full, pt.RenderConfig(32, 16, n_spp, 4))
    assert img.shape == (16, 32, 3), img.shape
    assert r.stats.ray_segments > 0
    lines.append(f"dryrun_multichip full-contract ok: fog march + mesh/BVH, {r.stats.ray_segments} segments, "
                 f"image mean {img.mean():.1f}")
    return [lines, timing.plain_calls() - plain0]


def dryrun_multichip(n_devices: int, device="cuda") -> int:
    """Render both dry-run configurations on an ``n_devices``-rank mesh: over NCCL one card a rank where the
    machine has the cards, else over gloo (ranks sharing one card, or the CPU).  Prints rank 0's lines;
    returns the ranks' calls of the plain versions."""
    from .parallel.launch import run_world

    dev = timing.resolve(device)
    backend = "nccl" if dev.type == "cuda" and n_devices <= torch.cuda.device_count() else "gloo"
    out = run_world(_dryrun_rank, n_devices, (n_devices, dev.type), backend=backend, timeout=900)
    for line in out[0][0]:
        print(line, flush=True)
    return sum(plain for _lines, plain in out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=8, help="ranks of the dry run's mesh (8)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON line there too")
    args = ap.parse_args(argv)
    dev = timing.resolve(args.device)
    fn, example = entry(dev)
    out, segs = fn(*example)
    timing.sync(dev)
    print("entry ok:", tuple(out.shape), int(segs), flush=True)
    plain = timing.plain_calls() + dryrun_multichip(args.devices, args.device)
    return timing.finish("graft_entry", dev, {"entry_shape": list(out.shape), "entry_segments": int(segs),
                                              "entry_mean": float(out.mean()), "devices": args.devices},
                         args.out, plain=plain)


if __name__ == "__main__":
    sys.exit(main())
