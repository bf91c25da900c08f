"""Command-line entry point, flag-compatible with the reference CLI.

Counterpart of the JAX package's ``cli.py`` with its flags
(``cmd/render/main.go:17-21``: ``-scene -mode -gpu -headless -out``, single
dash Go style also accepted, and its extensions ``--use-scene-settings``,
``--seed``, ``--width/--height/--spp/--depth``, ``--normalize``,
``--json-stats``, ``--interactive``), plus ``--device``: the device the
port renders on, the card (``cuda``, the default) unless ``--device cpu``
asks for the plain PyTorch version.  ``-gpu`` keeps its meaning: the
physics contract, not the device.  Without a card and without
``--device cpu`` the render raises.

    python -m path_trace_golang_tpu_torch -scene demo_showcase -headless -out out.png
    python -m path_trace_golang_tpu_torch -scene demo_cornell -headless --device cpu --width 64 --height 48

``PATHTRACER_CHECKPOINT=<file>`` resumes an interrupted render of the same
scene and settings; ``PATHTRACER_METRICS=<file.jsonl>`` writes the interval
records that ``tools/metrics_report.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import render as R
from .io_png import save_png
from .scene import builtin, io as scene_io
from .scene.model import RenderSettings


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="path_trace_golang_tpu_torch",
        description="path tracer on PyTorch/CUDA (reference-compatible CLI)",
    )
    p.add_argument("-scene", "--scene", default="scenes/example_simple.json", help="path to scene JSON file")
    p.add_argument("-mode", "--mode", default="preview", choices=["preview", "final"], help="render mode")
    p.add_argument("-gpu", "--gpu", action="store_true", help="use the GPU physics contract")
    p.add_argument("-headless", "--headless", action="store_true", help="render without UI and save PNG")
    p.add_argument("-out", "--out", default="output.png", help="output PNG file")
    # extensions
    p.add_argument("--use-scene-settings", action="store_true", help="prefer the scene's settings block over the mode preset")
    p.add_argument("--seed", type=int, default=1, help="deterministic base seed")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--spp", type=int, default=0, help="samples per pixel (passes)")
    p.add_argument("--depth", type=int, default=0, help="max bounce depth")
    p.add_argument("--normalize", action="store_true", help="physically-normalized sampling (disables the reference's 16x pass quirk)")
    p.add_argument("--json-stats", action="store_true", help="print render stats as JSON to stdout")
    p.add_argument("--interactive", action="store_true", help="interactive progressive preview session")
    p.add_argument("--device", default="cuda", help="device to render on: cuda (the card, default) or cpu")
    return p


def resolve_settings(sc, mode: str, args) -> RenderSettings:
    settings = R.render_settings_for_mode(mode)
    if args.use_scene_settings and not sc.settings.is_zero():
        # scene settings override the preset where nonzero (app.go:61-70)
        s = sc.settings
        settings = RenderSettings(
            width=s.width or settings.width,
            height=s.height or settings.height,
            samples_per_px=s.samples_per_px or settings.samples_per_px,
            max_depth=s.max_depth or settings.max_depth,
        )
    if args.width:
        settings.width = args.width
    if args.height:
        settings.height = args.height
    if args.spp:
        settings.samples_per_px = args.spp
    if args.depth:
        settings.max_depth = args.depth
    return settings


def load_scene(name: str):
    path = builtin.find_scene(name)
    if path is not None:
        return scene_io.load(path)
    sc = builtin.builtin_scene(name)
    if sc is not None:
        return sc
    raise FileNotFoundError(f"scene not found: {name}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print("pathtracer: starting", file=sys.stderr)
    print(
        f"flags: scene={args.scene} mode={args.mode} gpu={args.gpu} "
        f"headless={args.headless} out={args.out} device={args.device}",
        file=sys.stderr,
    )

    R.set_backend(R.BACKEND_GPU if args.gpu else R.BACKEND_CPU)

    try:
        sc = load_scene(args.scene)
    except FileNotFoundError as e:
        print(f"load scene: {e}", file=sys.stderr)
        return 1

    renderer = R.Renderer(normalize_pass=args.normalize, seed=args.seed, device=args.device)
    if args.interactive and not args.headless:
        from .interactive import InteractiveSession

        session = InteractiveSession(sc, mode=args.mode, scene_path=builtin.find_scene(args.scene), renderer=renderer)
        # CLI overrides apply to the preview loop too
        session.settings = resolve_settings(sc, args.mode, args)
        session.run_terminal()
        return 0

    settings = resolve_settings(sc, args.mode, args)
    cfg = R.RenderConfig(
        width=settings.width,
        height=settings.height,
        samples_per_px=settings.samples_per_px,
        max_depth=settings.max_depth,
    )

    t0 = time.time()

    def progress(pass_idx, _img):
        print(f"pass {pass_idx}/{cfg.samples_per_px} ({time.time() - t0:.1f}s)", file=sys.stderr)

    img = renderer.render(sc, cfg, progress=progress)
    save_png(args.out, img)
    print(f"saved {args.out} in {time.time() - t0:.1f}s", file=sys.stderr)
    if args.json_stats:
        s = renderer.stats
        print(
            json.dumps(
                {
                    "width": cfg.width,
                    "height": cfg.height,
                    "passes": s.passes,
                    "samples_per_pixel": s.samples_per_pixel,
                    "ray_segments": s.ray_segments,
                    "wall_seconds": round(s.wall_seconds, 3),
                    "mrays_per_sec": round(s.mrays_per_sec, 3),
                }
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
