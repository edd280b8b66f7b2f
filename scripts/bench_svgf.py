"""SVGF denoise-chain latency at 1080p (BASELINE.md metric).

Times the full denoise chain — reproject + spatial variance + 5x a-trous +
modulate + TAA — standalone, on realistic-shaped random buffers, for the
moving and the static camera.

Usage: PYTHONPATH=. python scripts/bench_svgf.py [H W]
"""
import json
import sys
import time

from tpuray.utils.platform import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp


def timed(fn, *args, iters=10, trials=3):
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def main():
    h = int(sys.argv[1]) if len(sys.argv) > 1 else 1080
    w = int(sys.argv[2]) if len(sys.argv) > 2 else 1920

    from tpuray.denoise.svgf import svgf_pipeline
    from tpuray.integrator.gbuffer import GBuffer
    from tpuray.render.frame_state import FrameState
    from tpuray.scene.config import RenderConfig

    cfg = RenderConfig(width=w, height=h)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 12)
    img3 = lambda k: jax.random.uniform(k, (h, w, 3))
    img1 = lambda k: jax.random.uniform(k, (h, w))
    n = img3(ks[0]) * 2 - 1
    normal = n / jnp.linalg.norm(n, axis=-1, keepdims=True)

    gbuf = GBuffer(
        normal=normal, linear_z=img1(ks[3]) * 0.9,
        velocity=(img3(ks[4])[..., :2] - 0.5) * 0.01,
        fwidth_normal=img1(ks[5]) * 0.1, fwidth_z=img1(ks[6]) * 0.01,
        world_pos=img3(ks[1]) * 4 - 2)
    state = FrameState.initial(h, w)
    state = state.replace(
        illum_hist=img3(ks[7]), variance_hist=img1(ks[8]) * 0.1,
        prev_normal=normal, prev_linear_z=gbuf.linear_z,
        moments=jax.random.uniform(ks[9], (h, w, 2)),
        history_len=jnp.full((h, w), 8.0), frame_idx=jnp.int32(8))

    color, emission, albedo = img3(ks[10]), img3(ks[11]) * 0.05, img3(ks[0]) + 0.2

    for static in (False, True):
        # inputs as arguments: captured as constants, XLA would fold them
        f = jax.jit(lambda *a, static=static: svgf_pipeline(
            *a, cfg, static_camera=static).taa)
        ms = timed(f, color, emission, albedo, gbuf, state)
        print(json.dumps({
            "metric": f"svgf_chain_ms_{'static' if static else 'moving'}_{h}p",
            "value": round(ms, 2), "unit": "ms",
            "device": jax.devices()[0].device_kind,
        }), flush=True)


if __name__ == "__main__":
    main()
