"""End-to-end frame benchmark on the GPU.

Measures the full pipeline (path trace + SVGF + TAA) on the interactive
scene at the reference's 800x800 (Utils/camera.h:5-6), for the moving- and
static-camera paths. Writes JSON lines to stdout.

Usage: PYTHONPATH=. python scripts/bench_frame.py [size] [compact_frac]
"""
import json
import sys
import time

import jax

from tpuray.utils.platform import enable_compile_cache

enable_compile_cache()


def timed(fn, iters=10, trials=3):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main():
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    compact = float(sys.argv[2]) if len(sys.argv) > 2 else None

    from tpuray import Renderer, RenderConfig
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.procedural import make_interactive_scene

    scene = make_interactive_scene()
    cfg = RenderConfig(width=size, height=size)
    if compact is not None:
        # explicit budget: pin it (auto-tuning would override per frame)
        cfg = cfg.replace(compact_frac=compact, compact_auto=False)
    cam = OrbitCamera(width=size, height=size, radius=3.5, pitch_deg=20.0)
    r = Renderer(scene, cfg)

    # -- moving camera: rotate a little each frame (full reprojection)
    def frame_moving():
        cam.rotate(0.5, 0.0)
        return r.step(cam.snapshot()).final

    t_moving = timed(frame_moving)

    # -- static camera (accumulation path)
    t_static = timed(lambda: r.step(cam.snapshot()).final)

    rays = size * size * cfg.max_tracing_depth * 3  # trace+env shadow+pt shadow
    for name, t in (("moving", t_moving), ("static", t_static)):
        print(json.dumps({
            "metric": f"frame_ms_{name}_{size}px",
            "value": round(t * 1e3, 3),
            "unit": "ms/frame",
            "fps": round(1.0 / t, 1),
            "mrays_per_s": round(rays / t / 1e6, 1),
            "device": jax.devices()[0].device_kind,
        }))


if __name__ == "__main__":
    main()
