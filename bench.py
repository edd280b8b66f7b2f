"""Benchmark: traversal, frame, denoiser and gradient metrics on one GPU.

Every metric goes through the path a user calls: traversal through
integrator.path_tracer.trace, frames through Renderer.step, the denoiser
through svgf_pipeline. stdout: one JSON line, the primary-ray traversal rate
at 800x800 on the interactive scene (scene/procedural.make_interactive_scene).
stderr: one JSON line for each further metric. Every line names the device.
A run without a GPU prints no metric and exits non-zero: a CPU timing is not
a device number.

Env: BENCH_BUDGET_S (default 780) caps the optional metrics' wall time;
BENCH_FULL=1 (or --full) runs them all.

    python bench.py [--full]
"""
from __future__ import annotations

import json
import os
import sys
import time

T0 = time.perf_counter()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "780"))
FULL = "--full" in sys.argv or os.environ.get("BENCH_FULL") == "1"
SIZE = 800
DEVICE: dict = {}


def have_time(estimate_s: float) -> bool:
    return FULL or time.perf_counter() - T0 + estimate_s < BUDGET_S


def emit(obj: dict, to_stdout: bool = False) -> None:
    stream = sys.stdout if to_stdout else sys.stderr
    print(json.dumps({**obj, "device": DEVICE}), file=stream, flush=True)


def timed_stats(fn, iters: int, trials: int = 3) -> dict:
    """Per-iteration seconds across trials: {min, median, max}."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / iters)
    ts.sort()
    return {"min": ts[0], "median": ts[len(ts) // 2], "max": ts[-1]}


def rate_line(metric: str, n: int, st: dict, **extra) -> dict:
    return {"metric": metric, "value": n / st["median"], "unit": "rays/s",
            "spread_mrays": {k: n / st[v] / 1e6 for k, v in
                             (("min", "max"), ("median", "median"),
                              ("max", "min"))}, **extra}


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r}); a CPU run "
              "gives no device metric", file=sys.stderr)
        return 2
    DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()))
    from tpuray.utils.platform import enable_compile_cache
    enable_compile_cache()

    from tpuray.integrator.path_tracer import trace
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.procedural import make_interactive_scene
    scene = make_interactive_scene()
    orbit = OrbitCamera(width=SIZE, height=SIZE, radius=3.5, pitch_deg=20.0)
    cam = orbit.snapshot()
    d = cam.ray_directions(SIZE, SIZE).reshape(-1, 3)
    o = jnp.broadcast_to(jnp.asarray(cam.eye), d.shape)
    n_rays = int(d.shape[0])
    trace_j = jax.jit(lambda s, o, d: trace(s.bvh, s.triangles, o, d))

    st = timed_stats(lambda: trace_j(scene, o, d), iters=20, trials=5)
    emit(rate_line("trace_rays_per_second", n_rays, st,
                   tris=scene.triangles.count), to_stdout=True)

    # incoherent rays: primary hit points, uniformly random directions
    t, idx = trace_j(scene, o, d)
    hit = np.flatnonzero(np.asarray(idx) >= 0)
    p_inc = (o + d * t[:, None])[jnp.asarray(np.resize(hit, n_rays))]
    d_inc = jax.random.normal(jax.random.PRNGKey(0), p_inc.shape)
    d_inc = d_inc / jnp.linalg.norm(d_inc, axis=-1, keepdims=True)
    st = timed_stats(lambda: trace_j(scene, p_inc, d_inc), iters=10)
    emit(rate_line("trace_incoherent_rays_per_second", n_rays, st))

    # full frame (PT + SVGF + TAA) at the reference's 800x800, moving camera
    if have_time(150):
        from tpuray import Renderer, RenderConfig
        r = Renderer(scene, RenderConfig(width=SIZE, height=SIZE))

        def frame():
            orbit.rotate(0.5, 0.0)
            return r.step(orbit.snapshot()).final

        st = timed_stats(frame, iters=8)
        emit({"metric": f"frame_ms_moving_{SIZE}px",
              "value": st["median"] * 1e3, "unit": "ms/frame",
              "spread_ms": {k: v * 1e3 for k, v in st.items()}})

    # SVGF denoise chain at 1080p, moving camera
    if have_time(90):
        from tpuray.denoise.svgf import svgf_pipeline
        from tpuray.integrator.gbuffer import GBuffer
        from tpuray.render.frame_state import FrameState
        from tpuray.scene.config import RenderConfig
        h, w = 1080, 1920
        cfg = RenderConfig(width=w, height=h)
        ks = jax.random.split(jax.random.PRNGKey(0), 8)
        img3 = lambda k: jax.random.uniform(k, (h, w, 3))
        img1 = lambda k: jax.random.uniform(k, (h, w))
        nrm = img3(ks[0]) * 2 - 1
        nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
        gbuf = GBuffer(normal=nrm, linear_z=0.2 + img1(ks[1]) * 0.01,
                       velocity=jnp.full((h, w, 2), 0.003),
                       fwidth_normal=img1(ks[2]) * 0.1,
                       fwidth_z=img1(ks[3]) * 0.01, world_pos=img3(ks[4]))
        fs = FrameState.initial(h, w).replace(
            illum_hist=img3(ks[5]), prev_normal=nrm,
            prev_linear_z=gbuf.linear_z, history_len=jnp.full((h, w), 8.0),
            frame_idx=jnp.int32(8))
        color = img3(ks[6])
        args = (color, color * 0.05, color + 0.2, gbuf, fs)
        # inputs as arguments: captured as constants, XLA would fold them
        f = jax.jit(lambda *a: svgf_pipeline(*a, cfg).taa)
        st = timed_stats(lambda: f(*args), iters=5)
        emit({"metric": "svgf_chain_ms_moving_1080p",
              "value": st["median"] * 1e3, "unit": "ms",
              "spread_ms": {k: v * 1e3 for k, v in st.items()}})

    # gradient fidelity: AD against central finite differences, for
    # parameters that leave the sampled directions (and so the hit and
    # visibility topology) fixed
    if have_time(90):
        from tpuray.render.frame_state import FrameState
        from tpuray.render.renderer import render_frame
        from tpuray.scene.config import RenderConfig
        g_size = 128
        gcam = OrbitCamera(width=g_size, height=g_size, radius=3.5,
                           pitch_deg=20.0).snapshot()
        st0 = FrameState.initial(g_size, g_size)
        cfg2 = RenderConfig(width=g_size, height=g_size, enable_svgf=False)

        def mean_color(s):
            _, out = render_frame(s, gcam, st0, cfg2, g_size, g_size)
            return jnp.mean(out.pt_color)

        checks = {
            "base_color": lambda k: mean_color(scene.replace(
                materials=scene.materials.replace(
                    base_color=scene.materials.base_color * k))),
            "specular": lambda k: mean_color(scene.replace(
                materials=scene.materials.replace(
                    specular=jnp.full_like(scene.materials.specular, 0.5) * k))),
            "light_radiance": lambda k: mean_color(scene.replace(
                lights=scene.lights.replace(
                    radiance=scene.lights.radiance * k))),
        }
        for name, loss in checks.items():
            g = float(jax.jit(jax.grad(loss))(jnp.float32(0.9)))
            lf = jax.jit(loss)
            fd = (float(lf(jnp.float32(0.91))) - float(lf(jnp.float32(0.89)))) / 0.02
            rel = abs(g - fd) / max(abs(fd), 1e-8)
            emit({"metric": f"gradcheck_{name}_rel_err", "value": rel,
                  "unit": "relative", "grad": g, "fd": fd,
                  "pass": bool(rel < 0.05)})

    # large single-tree scenes
    for subdiv, est_s in ((4, 120), (5, 240)):
        if not have_time(est_s):
            continue
        from tpuray.scene.procedural import make_large_scene
        t0 = time.perf_counter()
        big = make_large_scene(n_spheres=25, subdiv=subdiv, env_width=64)
        build_s = time.perf_counter() - t0
        st = timed_stats(lambda: trace_j(big, o, d), iters=8)
        emit(rate_line(f"trace_{big.triangles.count}tris_rays_per_second",
                       n_rays, st, bvh_build_s=build_s))
        del big

    emit({"metric": "bench_total_s", "value": time.perf_counter() - T0,
          "unit": "s"})
    return 0


if __name__ == "__main__":
    sys.exit(main())
