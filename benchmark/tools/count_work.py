"""Count the work of one render of each final cell with the port's counting build, and freeze it.

    python3 benchmark/tools/count_work.py --commit <sha> [--cells a,b] [--seed n] [--out dir]

On the card: renders each cell's job once as the cell's loop does (the
same Renderer, settings, progress callback and seed schedule) with every
whole-pass call also run through the counting build of its kernels
(``cuda_trace.count_ops_split`` for the fog kernel and B1,
``cuda_trace.classic_count_split`` for the classic window kernel), on the
call's own lanes, passes and seed.  Bytes are counted from the calls'
shapes: each input read once, each output written once.  Writes
``<out>/<cell>.json`` (``benchmark/work/`` unless ``--out`` says
otherwise); the benchmark's rooflines read it and never count at run
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import spec  # noqa: E402
from benchmark.harness.stats import sub_seed  # noqa: E402

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet, 700 W)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def table_bytes(pack) -> int:
    names = ("mat", "obj", "light_idx", "tri", "bvh_bounds", "page_tiles", "page_boxes")
    return sum(getattr(pack, n).numel() * getattr(pack, n).element_size() for n in names) + 19 * 4


def count_cell(cell, seed: int) -> dict:
    import torch

    import path_trace_golang_tpu_torch as pt
    from path_trace_golang_tpu_torch.ops import cuda_trace
    from path_trace_golang_tpu_torch.scene.model import Scene

    settings = spec.resolve_settings(cell.traffic, cell.config["scene"])
    scene = Scene.from_json(cell.config["scene"])
    kernels: dict = {}

    def add(name, ops, nbytes):
        k = kernels.setdefault(name, {"ops": 0, "bytes": 0, "launches": 0})
        k["ops"] += int(ops)
        k["bytes"] += int(nbytes)
        k["launches"] += 1

    orig_regen, orig_classic = cuda_trace.render_pass_cuda, cuda_trace.classic_render_cuda

    def regen(pack, frame_seed, px, py, **kw):
        c = cuda_trace.count_ops_split(pack, frame_seed, px, py, **kw)
        n, passes, tb = px.numel(), kw.get("n_passes", 1), table_bytes(pack)
        fog_ops = c["fog"]["ops"] if c["fog"] else 0
        terms = passes * 3 * n * 4 if c["fog"] else 0
        add("render_pass_kernel", c["ops"] - fog_ops, 8 * n + terms + 12 * n + tb)
        if c["fog"]:
            add("fog_pass_kernel", fog_ops, 8 * n + terms + tb)
        return orig_regen(pack, frame_seed, px, py, **kw)

    def classic(accum, pack, frame_seed, px, py, **kw):
        c = cuda_trace.classic_count_split(accum, pack, frame_seed, px, py, **kw)
        n = px.numel()
        add("classic_window_kernel", c["ops"], 8 * n + 24 * n + table_bytes(pack))
        return orig_classic(accum, pack, frame_seed, px, py, **kw)

    r = pt.Renderer(contract=cell.traffic["contract"], seed=sub_seed(seed, 0, 0))
    cfg = pt.RenderConfig(settings["width"], settings["height"], settings["passes"], settings["depth"])
    cuda_trace.render_pass_cuda, cuda_trace.classic_render_cuda = regen, classic
    try:
        r.render(scene, cfg, progress=lambda _p, _img: None)
    finally:
        cuda_trace.render_pass_cuda, cuda_trace.classic_render_cuda = orig_regen, orig_classic
    torch.cuda.synchronize()
    for k in kernels.values():
        t_ops, t_bytes = k["ops"] / PEAK_F32_FLOPS, k["bytes"] / PEAK_BYTES
        k["bound_s"] = max(t_ops, t_bytes)
        k["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return {"segments": int(r.stats.ray_segments), "kernels": kernels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--commit", required=True, help="the commit whose kernels are counted")
    p.add_argument("--cells", default="showcase-gpu-final,mesh10k-gpu-final,showcase-cpu-final")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=str(spec.BENCH_DIR / "work"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("count_work: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    bench = spec.load_benchmark()
    for name in args.cells.split(","):
        cell = spec.find_cell(bench, name)
        counted = count_cell(cell, args.seed)
        out = {"cell": name, "commit": args.commit, "seed": args.seed, "per": "one render",
               "card": smi, "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES}, **counted}
        path = Path(args.out) / f"{name}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
