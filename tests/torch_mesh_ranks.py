"""What the ranks of tests/test_torch_parallel.py run.

A world's ranks are spawned processes, and each imports the module of the
function it runs: this one imports the port and never JAX or the JAX
package (tests/test_torch_parallel.py imports both, and would load JAX in
every rank).
"""

import contextlib
import os

import path_trace_golang_tpu_torch as tpt
from path_trace_golang_tpu_torch.parallel import MeshRenderer, make_mesh
from path_trace_golang_tpu_torch.parallel import mesh as mesh_mod
from path_trace_golang_tpu_torch.scene import io as TS
from path_trace_golang_tpu_torch.utils import config as env_config


@contextlib.contextmanager
def final_accum(module):
    """Record, under ``box["accum"]``, the accumulator from which the
    renderer of ``module`` (``render`` or ``parallel.mesh``) finishes its
    final image, as f32[n_pad, 3] on the host."""
    box = {}
    orig = module.accum_image

    def spy(accum, w, h, count, gpu, denoise):
        if denoise:
            box["accum"] = accum.detach().cpu().numpy().copy()
        return orig(accum, w, h, count, gpu, denoise)

    module.accum_image = spy
    try:
        yield box
    finally:
        module.accum_image = orig


def _shapes():
    m = make_mesh(4, 2, device="cpu")
    out = {"shape": dict(zip(m.mesh_dim_names, m.shape)), "coord": m.get_coordinate(),
           "default": tuple(make_mesh(device="cpu").shape)}
    for args in ((8, 2, "cpu", None), (4, 2, "cpu", "nccl")):
        try:
            make_mesh(*args)
            out[args] = None
        except ValueError as e:
            out[args] = str(e)
    return out


def _render(mesh, case, run):
    """One render of ``case`` on ``mesh``: the image, the stats, the final
    accumulator, the progress calls and the cancel checks of this rank."""
    kw = dict(case.get("kw", {}), **run.get("kw", {}))
    env = run.get("env", {})
    calls, ticks = [], []
    progress = (lambda p, im: calls.append(p)) if run.get("progress") else None
    stop = run.get("cancel_after")
    cancel = (lambda: ticks.append(1) is None and len(ticks) >= stop) if stop else None
    os.environ.update(env)
    env_config.reset_cache()
    try:
        r = MeshRenderer(mesh, device="cpu", **kw)
        with final_accum(mesh_mod) as box:
            img = r.render(TS.loads(case["scene"]), tpt.RenderConfig(*case["cfg"]), progress=progress, cancel=cancel)
    finally:
        for k in env:
            del os.environ[k]
        env_config.reset_cache()
    return {"img": img, "stats": vars(r.stats), "accum": box["accum"], "progress": calls, "ticks": len(ticks)}


def run_cases(cases):
    """Every rank runs every case: a mesh made by the whole world, then the
    case's renders on the ranks inside it (None elsewhere)."""
    out = []
    for case in cases:
        if case["kind"] == "shapes":
            out.append(_shapes())
            continue
        mesh = make_mesh(*case["mesh"], device="cpu")
        if mesh.get_coordinate() is None:
            out.append(None)
            continue
        out.append([_render(mesh, case, run) for run in case["runs"]])
    return out


def fail_on_rank(bad_rank):
    """Rank ``bad_rank`` raises; the others wait for it in a collective."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.zeros(1))
