"""Command-line entry point.

The reference is GUI-only (imgui sliders, main.cpp:363-431); this provides a
headless CLI: progressive rendering to PNG with debug-view selection, frame
checkpointing, benchmarking, and differentiable material optimization.

Examples:
  python -m tpuray.cli.main render --scene interactive --size 800 --frames 16
  python -m tpuray.cli.main render --scene procedural --view svgf_atrous
  python -m tpuray.cli.main train --steps 20 --out-prefix fit
  python -m tpuray.cli.main bench
"""
from __future__ import annotations

import argparse
import json
import sys
import time


SCENES = ["procedural", "interactive", "reference", "table"]


def _build_scene(name: str, quirks: bool):
    if name == "reference":
        from tpuray.scene.builder import reference_default_scene
        return reference_default_scene(reference_quirks=quirks)
    if name == "table":
        from tpuray.scene.builder import ObjectSpec, build_scene
        return build_scene(
            [ObjectSpec(path="models/table.obj",
                        material=dict(base_color=(0.7, 0.5, 0.3), roughness=0.4))],
            reference_quirks=quirks)
    if name == "interactive":
        from tpuray.scene.procedural import make_interactive_scene
        return make_interactive_scene()
    from tpuray.scene.procedural import make_test_scene
    return make_test_scene(subdiv=3)


_VIEWS = {
    "1spp": "PATH_TRACING_1SPP", "reprojected": "SVGF_REPROJECTED",
    "variance": "SVGF_VARIANCE", "atrous": "SVGF_ATROUS",
    "modulate": "SVGF_MODULATE", "taa": "TAA", "final": "FINAL",
    "accum": "ACCUMULATE_COLOR",
}


def cmd_render(args) -> int:
    import numpy as np

    from tpuray.io.image import write_png
    from tpuray.render.renderer import Renderer
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.config import DebugView, RenderConfig
    from tpuray.utils.metrics import FrameMetrics

    cfg = (RenderConfig.load(args.config) if args.config else RenderConfig())
    cfg = cfg.replace(width=args.size, height=args.size,
                      max_tracing_depth=args.depth,
                      reference_quirks=args.reference_quirks)
    scene = _build_scene(args.scene, args.reference_quirks)
    cam = OrbitCamera(width=cfg.width, height=cfg.height,
                      yaw_deg=args.yaw, pitch_deg=args.pitch, radius=args.radius)
    r = Renderer(scene, cfg)
    if args.resume:
        from tpuray.utils.checkpoint import load_frame_state
        r.state = load_frame_state(args.resume)

    metrics = FrameMetrics(cfg.width, cfg.height, cfg.max_tracing_depth)
    if args.elastic:
        # supervised loop: device faults -> restore newest checkpoint and
        # replay (utils/elastic.py); frames are pure functions of state, so
        # a resumed run is bit-identical to an uninterrupted one
        from tpuray.render.renderer import render_frame
        from tpuray.utils.elastic import run_elastic
        snap = cam.snapshot()

        seen = set()

        def frame_fn(state, frame):
            import jax
            t0 = time.perf_counter()
            state, out = render_frame(scene, snap, state, cfg,
                                      cfg.height, cfg.width)
            # block before recording (matching the non-elastic loop, which
            # measures completed frames, not async dispatch), and record
            # each frame index once — replays after a restore would
            # otherwise double-count (ADVICE r3)
            jax.block_until_ready(out.final)
            r.last_outputs = out
            if frame not in seen:
                seen.add(frame)
                metrics.record(time.perf_counter() - t0)
            return state

        ck = args.elastic
        r.state, stats = run_elastic(frame_fn, r.state, args.frames, ck,
                                     checkpoint_every=args.checkpoint_every)
        print(f"elastic: {stats.frames_done} frames, {stats.faults} faults, "
              f"{stats.restores} restores, {stats.checkpoints} checkpoints",
              file=sys.stderr)
    else:
        import jax
        for i in range(args.frames):
            t0 = time.perf_counter()
            out = r.step(cam.snapshot())
            jax.block_until_ready(out.final)
            metrics.record(time.perf_counter() - t0)
    print(metrics.summary(), file=sys.stderr)

    view = DebugView[_VIEWS[args.view]]
    img = r.display_image(view)
    write_png(args.out, img)
    print(f"wrote {args.out} ({cfg.width}x{cfg.height}, {args.frames} frames, "
          f"view={args.view})", file=sys.stderr)
    if args.checkpoint:
        from tpuray.utils.checkpoint import save_frame_state
        save_frame_state(args.checkpoint, r.state)
        print(f"saved state -> {args.checkpoint}", file=sys.stderr)
    if args.dump_all_views:
        base = args.out.rsplit(".", 1)[0]
        for name, enum_name in _VIEWS.items():
            write_png(f"{base}_{name}.png", r.display_image(DebugView[enum_name]))
    return 0


def cmd_animate(args) -> int:
    """Headless equivalent of the reference's interactive orbit loop
    (mouse-drag rotate, main.cpp:614-655): step the camera each frame and
    write a PNG sequence. Exercises motion vectors / SVGF reprojection / TAA
    exactly like dragging does in the reference GUI."""
    import sys
    import time

    import jax

    from tpuray.io.image import write_png
    from tpuray.render.renderer import Renderer
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.config import DebugView, RenderConfig
    from tpuray.utils.metrics import FrameMetrics

    cfg = (RenderConfig.load(args.config) if args.config else RenderConfig())
    cfg = cfg.replace(width=args.size, height=args.size)
    scene = _build_scene(args.scene, False)
    cam = OrbitCamera(width=cfg.width, height=cfg.height,
                      yaw_deg=args.yaw, pitch_deg=args.pitch, radius=args.radius)
    r = Renderer(scene, cfg)
    metrics = FrameMetrics(cfg.width, cfg.height, cfg.max_tracing_depth)
    view = DebugView[_VIEWS[args.view]]
    for i in range(args.frames):
        cam.rotate(args.deg_per_frame, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot())
        jax.block_until_ready(out.final)
        metrics.record(time.perf_counter() - t0)
        if i % args.every == 0:
            write_png(f"{args.out_prefix}_{i:04d}.png", r.display_image(view))
    print(metrics.summary(), file=sys.stderr)
    return 0


def cmd_train(args) -> int:
    import jax.numpy as jnp
    import numpy as np
    import optax

    from tpuray.render.renderer import tonemap
    from tpuray.io.image import write_png
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.config import RenderConfig
    from tpuray.train.optimize import (
        make_train_step, render_flat, split_trainable)

    cfg = RenderConfig(width=args.size, height=args.size,
                       max_tracing_depth=args.depth)
    scene = _build_scene(args.scene, False)
    cam = OrbitCamera(width=args.size, height=args.size).snapshot()

    params, rebuild = split_trainable(scene)
    target = render_flat(scene, cam, cfg, args.size, args.size, 0)
    # perturb and recover
    params = {k: (v.replace(base_color=v.base_color * 0.4 + 0.3)
                  if k == "materials" else v) for k, v in params.items()}
    init, step = make_train_step(rebuild, cfg, args.size, args.size,
                                 optax.adam(args.lr))
    state = init(params)
    for i in range(args.steps):
        state, loss = step(state, target, cam, 0)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
    final = render_flat(rebuild(state.params), cam, cfg, args.size, args.size, 0)
    write_png(f"{args.out_prefix}_target.png", np.asarray(tonemap(target)))
    write_png(f"{args.out_prefix}_fit.png", np.asarray(tonemap(final)))
    print(f"final loss {float(loss):.6f}", file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    from tpuray.scene.config import RenderConfig
    from tpuray.viewer.server import ViewerServer

    cfg = (RenderConfig.load(args.config) if args.config else RenderConfig())
    cfg = cfg.replace(width=args.size, height=args.size,
                      reference_quirks=args.reference_quirks)
    scene = _build_scene(args.scene, args.reference_quirks)
    server = ViewerServer(scene, cfg, host=args.host, port=args.port)
    server.start()
    server.serve_forever()
    return 0


def cmd_bench(args) -> int:
    import runpy
    import pathlib
    runpy.run_path(str(pathlib.Path(__file__).resolve().parents[2] / "bench.py"),
                   run_name="__main__")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpuray")
    p.add_argument("--asset-root", default=None,
                   help="extra asset root searched before the defaults "
                        "(also settable via $TPURAY_ASSET_ROOT)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render to PNG")
    pr.add_argument("--scene", default="procedural",
                    choices=SCENES)
    pr.add_argument("--frames", type=int, default=8)
    pr.add_argument("--size", type=int, default=256)
    pr.add_argument("--depth", type=int, default=2)
    pr.add_argument("--view", default="final", choices=sorted(_VIEWS))
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--config", default=None, help="RenderConfig JSON file")
    pr.add_argument("--yaw", type=float, default=0.0)
    pr.add_argument("--pitch", type=float, default=10.0)
    pr.add_argument("--radius", type=float, default=2.0)
    pr.add_argument("--checkpoint", default=None, help="save FrameState npz")
    pr.add_argument("--resume", default=None, help="load FrameState npz")
    pr.add_argument("--elastic", default=None, metavar="CKPT",
                    help="supervised loop: checkpoint here every "
                         "--checkpoint-every frames; device faults restore "
                         "+ replay (utils/elastic.py)")
    pr.add_argument("--checkpoint-every", type=int, default=8)
    pr.add_argument("--reference-quirks", action="store_true")
    pr.add_argument("--dump-all-views", action="store_true")
    pr.set_defaults(fn=cmd_render)

    pt = sub.add_parser("train", help="differentiable material recovery demo")
    pt.add_argument("--scene", default="procedural",
                    choices=SCENES)
    pt.add_argument("--steps", type=int, default=20)
    pt.add_argument("--size", type=int, default=64)
    pt.add_argument("--depth", type=int, default=1)
    pt.add_argument("--lr", type=float, default=0.05)
    pt.add_argument("--out-prefix", default="train")
    pt.set_defaults(fn=cmd_train)

    pa = sub.add_parser("animate", help="orbiting-camera PNG sequence "
                        "(headless stand-in for the reference's GUI orbit)")
    pa.add_argument("--scene", default="procedural",
                    choices=SCENES)
    pa.add_argument("--frames", type=int, default=24)
    pa.add_argument("--size", type=int, default=256)
    pa.add_argument("--deg-per-frame", type=float, default=1.5)
    pa.add_argument("--every", type=int, default=1, help="write every k-th frame")
    pa.add_argument("--view", default="final", choices=sorted(_VIEWS))
    pa.add_argument("--out-prefix", default="anim")
    pa.add_argument("--config", default=None)
    pa.add_argument("--yaw", type=float, default=0.0)
    pa.add_argument("--pitch", type=float, default=10.0)
    pa.add_argument("--radius", type=float, default=2.0)
    pa.set_defaults(fn=cmd_animate)

    pv = sub.add_parser("view", help="interactive browser viewer "
                        "(the reference's imgui+GLFW surface, over HTTP)")
    pv.add_argument("--scene", default="procedural",
                    choices=SCENES)
    pv.add_argument("--size", type=int, default=400)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8008)
    pv.add_argument("--config", default=None)
    pv.add_argument("--reference-quirks", action="store_true")
    pv.set_defaults(fn=cmd_view)

    pb = sub.add_parser("bench", help="run the benchmark")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from tpuray.utils.platform import enable_compile_cache
    enable_compile_cache()
    if args.asset_root:
        from tpuray.io.filesystem import add_root
        add_root(args.asset_root)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
