"""Stage-level decomposition of the frame time on the GPU.

Times the full frame and ablations (no SVGF, no TAA, trace-only, shading
pieces) to locate the bottleneck. JSON lines to stdout.

Usage: PYTHONPATH=. python scripts/profile_frame.py [size]
"""
import json
import sys
import time


from tpuray.utils.platform import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp


def timed(fn, iters=8, trials=2):
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

    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.procedural import make_interactive_scene
    from tpuray.scene.config import RenderConfig
    from tpuray.render.frame_state import FrameState
    from tpuray.render.renderer import render_frame
    from tpuray.render.tiling import tile_pixel_coords
    from tpuray.integrator.path_tracer import trace_paths

    scene = make_interactive_scene()
    cam = OrbitCamera(width=size, height=size, radius=3.5,
                      pitch_deg=20.0).snapshot()
    h = w = size
    results = {}

    def frame_with(cfg, static=False, label=None):
        state = FrameState.initial(h, w)
        fn = lambda: render_frame(scene, cam, state, cfg, h, w,
                                  static_camera=static)[1].final
        return timed(fn)

    base = RenderConfig(width=size, height=size)
    results["frame_moving"] = frame_with(base, static=False)
    results["frame_static"] = frame_with(base, static=True)
    results["frame_no_svgf"] = frame_with(base.replace(enable_svgf=False))
    results["frame_no_taa"] = frame_with(base.replace(enable_taa=False))
    results["frame_depth1"] = frame_with(base.replace(max_tracing_depth=1))

    # trace_paths alone (integrator incl. shading/NEE, no denoise/gbuffer)
    xx, yy = tile_pixel_coords(h, w)
    n = xx.shape[0]
    xs = (2.0 * (xx.astype(jnp.float32) + 0.5) / w - 1.0) * cam.tan_half_fov
    ys = -(2.0 * (yy.astype(jnp.float32) + 0.5) / h - 1.0) * cam.tan_half_fov
    d_cam = jnp.stack([xs, ys, -jnp.ones_like(xs)], axis=-1)
    d = jnp.einsum("ij,nj->ni", cam.cam_to_world, d_cam,
                   precision=jax.lax.Precision.HIGHEST)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    orig = jnp.broadcast_to(cam.eye, (n, 3))
    px, py = xx, h - 1 - yy

    tp = jax.jit(lambda f: trace_paths(scene, orig, d, px, py, f, base).color)
    results["trace_paths"] = timed(lambda: tp(jnp.uint32(3)))

    # traversal alone, primary rays
    from tpuray.integrator.path_tracer import trace
    kern = jax.jit(lambda o, dd: trace(scene.bvh, scene.triangles, o, dd))
    results["trace_primary"] = timed(lambda: kern(orig, d))

    for k, v in results.items():
        print(json.dumps({"stage": k, "ms": round(v * 1e3, 2),
                          "device": jax.devices()[0].device_kind}))


if __name__ == "__main__":
    main()
