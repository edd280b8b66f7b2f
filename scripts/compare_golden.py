"""Golden-image comparison vs the reference's result/*.png screenshots.

The reference ships five full-window screenshots pairing its pipeline stages
(README.md:5-14). Its geometry (clock.obj) and camera defaults ARE shipped,
but the room.hdr envmap and BMP texture sets are NOT — so pixel-exact parity
is impossible; what IS checkable is geometric/structural parity: with the
same model, transform, camera, and projection, our render's luminance
*structure* (silhouette and internal edges of the clock) must align with the
screenshot's viewport region. This script renders the reference startup
scene, locates our frame inside each screenshot by gradient NCC, and reports
offset + NCC + SSIM per stage. The imgui-overlaid lower third is excluded.

Usage:
  PYTHONPATH=. python scripts/compare_golden.py [--frames 32]
      [--size 800] [--out-dir golden_out] [--cpu]
Writes golden_out/{stage}_ours.png, {stage}_pair.png, and report.json.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np

# the reference checkout's result/ screenshots
RESULTS = os.environ.get("TPURAY_REFERENCE_RESULTS", "reference/result")
# screenshot -> (our debug view, accumulate frames needed)
STAGES = {
    "1spp_input": "PATH_TRACING_1SPP",
    "reprojected_illumination": "SVGF_REPROJECTED",
    "svgf_output": "SVGF_ATROUS",
    "modulate_color": "SVGF_MODULATE",
    "accumulate_output": "ACCUMULATE_COLOR",
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--out-dir", default="golden_out")
    ap.add_argument("--cpu", action="store_true")
    # camera pose; defaults are the values recovered from the screenshots
    # by scripts/fit_golden_pose.py (the captures are not at startup pose)
    ap.add_argument("--yaw", type=float, default=-12.0)
    ap.add_argument("--pitch", type=float, default=10.0)
    ap.add_argument("--radius", type=float, default=1.9)
    ap.add_argument("--envmap", default=None,
                    help="HDR stand-in (e.g. assets/recovered_env.hdr from "
                         "scripts/recover_envmap.py)")
    ap.add_argument("--dy", type=int, default=None,
                    help="viewport offset from fit_golden_pose (skips search)")
    ap.add_argument("--dx", type=int, default=None)
    args = ap.parse_args()

    from tpuray.utils.platform import enable_compile_cache
    enable_compile_cache()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from tpuray.io.image import read_png, write_png
    from tpuray.render.renderer import Renderer, select_debug_view, tonemap
    from tpuray.scene.builder import reference_default_scene
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.config import DebugView, RenderConfig
    from tpuray.utils.imgcmp import best_offset, luminance, ncc, grad_mag, ssim

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(exist_ok=True)

    cfg = RenderConfig(width=args.size, height=args.size,
                       reference_quirks=True)
    scene_kw = {}
    if args.envmap:
        scene_kw["envmap"] = args.envmap
    scene = reference_default_scene(reference_quirks=True, **scene_kw)
    cam = OrbitCamera(width=args.size, height=args.size, yaw_deg=args.yaw,
                      pitch_deg=args.pitch, radius=args.radius)
    r = Renderer(scene, cfg)
    t0 = time.time()
    for i in range(args.frames):
        out = r.step(cam.snapshot())
    print(f"rendered {args.frames} frames in {time.time() - t0:.1f}s",
          file=sys.stderr)

    report = {}
    # compare only the top 55% of the viewport: below that the screenshots
    # are covered by imgui parameter windows
    roi_h = int(args.size * 0.55)
    for stage, view in STAGES.items():
        ours = np.asarray(tonemap(select_debug_view(out, DebugView[view]),
                                  cfg.tonemap_limit, cfg.gamma))
        write_png(str(out_dir / f"{stage}_ours.png"), ours)
        gold_path = f"{RESULTS}/{stage}.png"
        gold = read_png(gold_path)
        lo = luminance(ours)[:roi_h]
        lg = luminance(gold)
        if gold.shape[0] < roi_h or gold.shape[1] < args.size:
            print(f"{stage}: screenshot smaller than render, skipped",
                  file=sys.stderr)
            continue
        if args.dy is not None:
            dy, dx = args.dy, args.dx or 0
        else:
            (dy, dx), score = best_offset(lo, lg, search=48)
        # crop the overlap (offsets may be negative with --dy/--dx)
        y0o, x0o = max(0, -dy), max(0, -dx)
        y0g, x0g = max(0, dy), max(0, dx)
        hh = min(roi_h - y0o, lg.shape[0] - y0g)
        ww = min(args.size - x0o, lg.shape[1] - x0g)
        lo_c = lo[y0o:y0o + hh, x0o:x0o + ww]
        aligned = lg[y0g:y0g + hh, x0g:x0g + ww]
        lo = lo_c
        s = ssim(lo, aligned)
        g = ncc(grad_mag(lo), grad_mag(aligned))
        report[stage] = {"offset": [dy, dx], "grad_ncc": round(g, 4),
                         "ssim": round(s, 4)}
        # side-by-side luminance pair for eyeballing
        pair = np.concatenate([lo, aligned], axis=1)
        write_png(str(out_dir / f"{stage}_pair.png"),
                  np.repeat(pair[..., None], 3, -1))
        print(f"{stage:28s} offset=({dy:2d},{dx:2d}) "
              f"grad_ncc={g:.3f} ssim={s:.3f}", file=sys.stderr)

    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
