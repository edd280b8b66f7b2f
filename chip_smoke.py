#!/usr/bin/env python3
"""Smoke test of tpuray on NVIDIA GPUs: the quickest proof that the system
starts, traces and denoises correctly on the card.

    python chip_smoke.py             # phases a-g on one GPU
    python chip_smoke.py --four      # the four-GPU phase only
    python chip_smoke.py --only b,c  # a subset of the one-GPU phases

Phases (one GPU):
  a  device: platform, kind, card, compile cache, native BVH builder
  b  traversal parity at 800x800: the BVH kernel against the XLA wavefront
     (primary and incoherent rays, nearest and any-hit) and against brute
     force on a 4096-ray subset
  c  traversal time: kernel against wavefront, primary and incoherent
  d  full frame: 16 Renderer.step frames on a moving orbit at 800x800,
     depth 2, SVGF + TAA; checks the lowered frame calls the kernel
  e  frame parity: the first 4 frames at 128x128 on the GPU and on the CPU
  f  denoiser: the jnp SVGF chain at 800x800 and 1920x1080, and the a-trous
     chain's bytes per pixel
  g  training: 3 make_train_step steps at 256x256, depth 1

Every phase prints one JSON line with its numbers and the card's name and
power limit. The last line is {"ok": true, "device": {...}}. The script exits
non-zero, printing no result, when JAX finds no GPU, when the repo is not
beside it, or when a phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 800
DENOISE_SIZES = ((800, 800), (1080, 1920))
SEED = 0


def card() -> str:
    """`nvidia-smi` name and power limit of the cards, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def timed(fn, reps: int = 10) -> dict:
    """Median and spread (ms) of fn() run to completion, after a warm-up."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return {"median_ms": ts[len(ts) // 2], "min_ms": ts[0], "max_ms": ts[-1]}


# ---------------------------------------------------------------- fixtures

def interactive_cfg(size: int | None = None, **kw):
    from tpuray.scene.config import RenderConfig
    size = size or SIZE
    return RenderConfig(width=size, height=size, max_tracing_depth=2,
                        num_atrous_iterations=5, history_atrous_tap=1,
                        enable_svgf=True, enable_taa=True, **kw)


def orbit(size: int | None = None):
    from tpuray.scene.camera import OrbitCamera
    size = size or SIZE
    return OrbitCamera(width=size, height=size, radius=3.5, pitch_deg=20.0)


def primary_rays(size: int | None = None):
    import jax.numpy as jnp
    size = size or SIZE
    cam = orbit(size).snapshot()
    d = cam.ray_directions(size, size).reshape(-1, 3)
    o = jnp.broadcast_to(jnp.asarray(cam.eye), d.shape)
    return o, d


def incoherent_rays(scene, o, d):
    """Surface-origin rays in uniformly random directions: the primary hit
    points (repeated to the primary count), each with its own direction."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpuray.integrator.intersect import trace
    t, idx = trace(scene.bvh, scene.triangles, o, d)
    hit = np.flatnonzero(np.asarray(idx) >= 0)
    pts = (o + d * t[:, None])[jnp.asarray(np.resize(hit, o.shape[0]))]
    v = jax.random.normal(jax.random.PRNGKey(SEED), pts.shape)
    return pts, v / jnp.linalg.norm(v, axis=-1, keepdims=True)


# ------------------------------------------------------------------ phases

def phase_a(ctx):
    import jax
    from tpuray.io import native
    from tpuray.utils.platform import compile_cache_dir
    dev = jax.devices()[0]
    emit("a_device", platform=dev.platform, kind=dev.device_kind,
         count=len(jax.devices()), jax=jax.__version__,
         compile_cache=compile_cache_dir(),
         bvh_builder="native" if native.get_lib() is not None
         else "numpy fallback",
         scene_tris=ctx["scene"].triangles.count,
         scene_nodes=ctx["scene"].bvh.count,
         scene_build_s=ctx["scene_build_s"])


def _compare(name, kern, ref, any_hit=False):
    import numpy as np
    tk, ik = (np.asarray(x) for x in kern)
    tr, ir = (np.asarray(x) for x in ref)
    if any_hit:
        diff = int(((ik >= 0) != (ir >= 0)).sum())
        return {f"{name}_anyhit_mismatch": diff}, diff == 0
    same = ik == ir
    mism = ~same
    dt = np.abs(tk - tr)[mism]
    hit = same & (ir >= 0)
    rel = np.abs(tk[hit] - tr[hit]) / np.maximum(np.abs(tr[hit]), 1e-30)
    res = {f"{name}_n": int(ik.size), f"{name}_hit_frac": float((ir >= 0).mean()),
           f"{name}_idx_mismatch": int(mism.sum()),
           f"{name}_mismatch_max_dt": float(dt.max()) if dt.size else 0.0,
           f"{name}_t_max_rel": float(rel.max()) if rel.size else 0.0}
    ok = (same.mean() >= 0.9999 and (dt < 1e-4).all()
          and (rel.size == 0 or rel.max() <= 1e-5))
    return res, ok


def phase_b(ctx):
    import jax.numpy as jnp
    from tpuray.integrator.intersect import trace, trace_bruteforce
    from tpuray.kernels.trace_triton import trace_triton
    s = ctx["scene"]
    bvh, tri = s.bvh, s.triangles
    out, ok = {}, True
    for name, (o, d) in (("primary", ctx["primary"]),
                         ("incoherent", ctx["incoherent"])):
        r, good = _compare(name, trace_triton(bvh, tri, o, d),
                           trace(bvh, tri, o, d))
        out.update(r)
        ok &= good
        tmax = jnp.full((o.shape[0],), 1.0, jnp.float32)
        r, good = _compare(name, trace_triton(bvh, tri, o, d, tmax, True),
                           trace(bvh, tri, o, d, tmax, True), any_hit=True)
        out.update(r)
        ok &= good
        sub = slice(0, o.shape[0], max(1, o.shape[0] // 4096))
        o_s, d_s = o[sub][:4096], d[sub][:4096]
        r, good = _compare(f"{name}_bruteforce", trace_triton(bvh, tri, o_s, d_s),
                           trace_bruteforce(tri, o_s, d_s))
        out.update(r)
        ok &= good
    emit("b_traversal_parity", ok=bool(ok), **out)
    return ok


def phase_c(ctx):
    import jax
    from tpuray.integrator.intersect import trace
    from tpuray.kernels.trace_triton import trace_triton
    s = ctx["scene"]
    out = {}
    kernel = jax.jit(lambda s, o, d: trace_triton(s.bvh, s.triangles, o, d))
    for name, (o, d) in (("primary", ctx["primary"]),
                         ("incoherent", ctx["incoherent"])):
        n = o.shape[0]
        r = timed(lambda: kernel(s, o, d))
        out[f"{name}_kernel"] = r
        out[f"{name}_kernel_rays_per_s"] = n / r["median_ms"] * 1e3
        r = timed(lambda: trace(s.bvh, s.triangles, o, d), reps=3)
        out[f"{name}_wavefront"] = r
        out[f"{name}_wavefront_rays_per_s"] = n / r["median_ms"] * 1e3
    emit("c_traversal_time", n_rays=int(ctx["primary"][0].shape[0]), **out)
    return True


def phase_d(ctx):
    import numpy as np
    from tpuray.kernels.trace_triton import KERNEL_NAME
    from tpuray.render.renderer import render_frame
    cfg = interactive_cfg()
    r, out, frame_ms = _frames(ctx["scene"], cfg, 16)
    t_first = frame_ms.pop(0)
    final = np.asarray(out.final)
    hist = np.asarray(r.state.history_len)
    lowered = render_frame.lower(ctx["scene"], orbit().snapshot(), r.state,
                                 r._frame_cfg, SIZE, SIZE,
                                 static_camera=False).as_text()
    n_kernel = lowered.count(f'"{KERNEL_NAME}"') + lowered.count(
        f"name = \"{KERNEL_NAME}\"")
    calls = lowered.count("__gpu$xla.gpu.triton")
    frame_ms.sort()
    ok = bool(np.isfinite(final).all() and hist.max() >= 8.0 and calls > 0
              and KERNEL_NAME in lowered)
    emit("d_frame", ok=ok, size=SIZE, frames=16,
         first_frame_ms_incl_compile=t_first,
         frame_median_ms=frame_ms[len(frame_ms) // 2],
         frame_min_ms=frame_ms[0], frame_max_ms=frame_ms[-1],
         history_len_max=float(hist.max()),
         history_len_mean=float(hist.mean()),
         coverage=float(out.coverage), triton_calls_in_frame=calls,
         kernel_named=KERNEL_NAME in lowered, kernel_name_hits=n_kernel,
         final_finite=bool(np.isfinite(final).all()))
    return ok


def _frames(scene, cfg, n):
    """n Renderer.step frames on the moving orbit; per-frame ms, each ended
    by block_until_ready (the first includes compilation)."""
    import jax
    from tpuray import Renderer
    r = Renderer(scene, cfg)
    cam = orbit(cfg.width)
    ms = []
    for _ in range(n):
        cam.rotate(1.0, 0.0)
        t0 = time.perf_counter()
        out = r.step(cam.snapshot())
        jax.block_until_ready(out.final)
        ms.append((time.perf_counter() - t0) * 1e3)
    return r, out, ms


FRAME_PARITY_MAE = 2e-3
FRAME_PARITY_SHARE = 0.01


def phase_e(ctx):
    """Same 4 frames at 128^2 on GPU and CPU. Tolerance: mean absolute error
    <= FRAME_PARITY_MAE and at most FRAME_PARITY_SHARE of pixels beyond 1e-2:
    FMA contraction and fusion reassociation differ between the two
    compilers and can flip an isolated grazing hit or shadow test, which
    SVGF then spreads over its neighbourhood."""
    import jax
    import numpy as np
    size = 128
    cfg = interactive_cfg(size)

    def run(scene):
        return np.asarray(_frames(scene, cfg, 4)[1].final)

    gpu = run(ctx["scene"])
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = run(jax.device_put(ctx["scene"], cpu_dev))
    d = np.abs(gpu - cpu).max(-1)
    mae = float(np.abs(gpu - cpu).mean())
    share = float((d > 1e-2).mean())
    ok = bool(np.isfinite(gpu).all() and mae <= FRAME_PARITY_MAE
              and share <= FRAME_PARITY_SHARE)
    emit("e_frame_parity", ok=ok, size=size, frames=4, mae=mae,
         share_beyond_1e_2=share, max_abs=float(d.max()),
         tol_mae=FRAME_PARITY_MAE, tol_share=FRAME_PARITY_SHARE)
    return ok


def _denoise_inputs(h, w):
    import jax
    import jax.numpy as jnp
    from tpuray.integrator.gbuffer import GBuffer
    from tpuray.render.frame_state import FrameState
    ks = jax.random.split(jax.random.PRNGKey(SEED), 12)
    img3 = lambda k: jax.random.uniform(k, (h, w, 3))
    img1 = lambda k: jax.random.uniform(k, (h, w))
    n = img3(ks[0]) * 2 - 1
    normal = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    # a smooth camera-like motion field of a few pixels
    yy, xx = jnp.meshgrid(jnp.linspace(-1, 1, h), jnp.linspace(-1, 1, w),
                          indexing="ij")
    vel = jnp.stack([0.004 + 0.002 * yy, -0.003 + 0.002 * xx], axis=-1)
    gbuf = GBuffer(normal=normal, linear_z=0.2 + img1(ks[3]) * 0.01,
                   velocity=vel, fwidth_normal=img1(ks[5]) * 0.1,
                   fwidth_z=img1(ks[6]) * 0.01, world_pos=img3(ks[1]))
    state = FrameState.initial(h, w).replace(
        illum_hist=img3(ks[7]), variance_hist=img1(ks[8]) * 0.1,
        prev_normal=normal, prev_linear_z=gbuf.linear_z,
        moments=jax.random.uniform(ks[9], (h, w, 2)),
        history_len=jnp.full((h, w), 8.0), frame_idx=jnp.int32(8))
    return (img3(ks[10]), img3(ks[11]) * 0.05, img3(ks[0]) + 0.2, gbuf,
            state)


# a-trous iteration: reads illum (3) + variance (1) + normal (3) + linear_z
# (1) + fwidth_z (1) f32 and writes illum (3) + variance (1) f32 per pixel
ATROUS_BYTES_PER_PX = (9 + 4) * 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def phase_f(ctx):
    import jax
    from tpuray.denoise.atrous import atrous_iteration
    from tpuray.denoise.svgf import svgf_pipeline
    out = {}
    for h, w in DENOISE_SIZES:
        args = _denoise_inputs(h, w)
        cfg = interactive_cfg().replace(width=w, height=h)
        f = jax.jit(lambda *a, cfg=cfg: svgf_pipeline(*a, cfg).taa)
        out[f"svgf_{h}p"] = timed(lambda: f(*args))

        @jax.jit
        def chain(illum, var, gbuf):
            for i in range(cfg.num_atrous_iterations):
                illum, var = atrous_iteration(
                    illum, var, gbuf.normal, gbuf.linear_z, gbuf.fwidth_z,
                    step=1 << i, cfg=cfg)
            return illum, var

        color, gbuf, state = args[0], args[3], args[4]
        r = timed(lambda: chain(color, state.variance_hist, gbuf))
        nbytes = ATROUS_BYTES_PER_PX * h * w * cfg.num_atrous_iterations
        out[f"atrous5_{h}p"] = r
        out[f"atrous5_{h}p_bytes_per_px"] = (
            ATROUS_BYTES_PER_PX * cfg.num_atrous_iterations)
        out[f"atrous5_{h}p_roofline_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"atrous5_{h}p_roofline_share"] = (
            nbytes / HBM_BYTES_PER_S * 1e3 / r["median_ms"])
    emit("f_denoiser", **out)
    return True


def phase_g(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from tpuray.train.optimize import make_train_step, split_trainable
    size = 256
    cfg = interactive_cfg(size).replace(max_tracing_depth=1)
    scene = ctx["scene"]
    params, rebuild = split_trainable(scene, train_lights=True)
    cam = orbit(size).snapshot()
    init, step = make_train_step(rebuild, cfg, size, size, optax.adam(1e-2))
    target = jnp.full((size, size, 3), 0.25, jnp.float32)
    state = init(params)
    losses, ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        state, loss = step(state, target, cam, i)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree_util.tree_leaves(params),
                                jax.tree_util.tree_leaves(state.params)))
    ok = bool(np.isfinite(losses).all() and moved > 0.0)
    emit("g_training", ok=ok, size=size, losses=losses,
         first_step_ms_incl_compile=ms[0], step_ms=ms[1:],
         max_param_change=moved)
    return ok


# The sharded frame traces, compacts and shades each shard's rays as its own
# program, so float reassociation may flip an isolated grazing hit or
# shadow test, which the a-trous chain and TAA spread locally; the denoiser
# itself computes what one GPU does. Tolerance (the multi-device CPU test's,
# tests/test_dist_frame.py): at most FOUR_SHARE of pixels beyond 5e-4, and
# no pixel off by FOUR_MAX or more.
FOUR_SHARE = 0.005
FOUR_MAX = 0.1


def _diff(a, b, shards):
    """Per-pixel max-channel |a - b| summary, with the share beyond 5e-4 in
    each shard's rows (a fault at shard seams shows as uneven shares)."""
    import numpy as np
    d = np.abs(a - b).max(-1)
    bands = np.array_split(d > 5e-4, shards, axis=0)
    return d, {"share_beyond_5e_4": float((d > 5e-4).mean()),
               "max_abs": float(d.max()),
               "mae": float(np.abs(a - b).mean()),
               "share_beyond_5e_4_per_shard": [float(x.mean()) for x in bands]}


def phase_four(ctx):
    """Row-sharded frame over 4 GPUs against one GPU's render_frame, and one
    sharded train step's loss against one GPU's."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tpuray.dist.frame import render_frame_sharded, shard_state
    from tpuray.dist.sharding import make_mesh
    from tpuray.render.frame_state import FrameState
    from tpuray.render.renderer import render_frame
    from tpuray.train.optimize import (
        make_sharded_train_step, make_train_step, split_trainable)
    assert len(jax.devices()) >= 4, "--four needs four GPUs"
    scene = ctx["scene"]
    cfg = interactive_cfg()
    mesh = make_mesh(4)
    cam = orbit()
    single = FrameState.initial(SIZE, SIZE)
    sharded = shard_state(FrameState.initial(SIZE, SIZE), mesh)
    ms_single, ms_sharded, per_frame = [], [], []
    for i in range(4):
        cam.rotate(1.0, 0.0)
        c = cam.snapshot()
        t0 = time.perf_counter()
        single, out = render_frame(scene, c, single, cfg, SIZE, SIZE)
        a = np.asarray(out.final)
        ms_single.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sharded, final, pt = render_frame_sharded(
            scene, c, sharded, cfg, SIZE, SIZE, mesh, halo=32,
            static_camera=False)
        b = np.asarray(final)
        ms_sharded.append((time.perf_counter() - t0) * 1e3)
        # the path-traced input of the denoiser, before any spreading
        _, pt_stats = _diff(np.asarray(out.pt_color), np.asarray(pt), 4)
        d, final_stats = _diff(a, b, 4)
        per_frame.append({"final": final_stats, "pt_color": pt_stats})
    frame_ok = bool(np.isfinite(b).all()
                    and (d > 5e-4).mean() <= FOUR_SHARE and d.max() < FOUR_MAX)

    size = 256
    tcfg = interactive_cfg(size).replace(max_tracing_depth=1)
    params, rebuild = split_trainable(scene, train_lights=False)
    opt = optax.sgd(0.1)
    init_s, step_s = make_train_step(rebuild, tcfg, size, size, opt)
    init_m, step_m = make_sharded_train_step(rebuild, tcfg, size, size, mesh,
                                             opt)
    tcam = orbit(size).snapshot()
    target = jnp.full((size, size, 3), 0.3, jnp.float32)
    _, l1 = step_s(init_s(params), target, tcam, 0)
    _, l4 = step_m(init_m(params), jax.device_put(
        target, NamedSharding(mesh, P("tiles"))), tcam, 0)
    rel = abs(float(l1) - float(l4)) / max(abs(float(l1)), 1e-30)
    train_ok = bool(np.isfinite(float(l4)) and rel < 1e-3)
    emit("four_gpu", ok=frame_ok and train_ok, size=SIZE, frames=4,
         frame=per_frame[-1]["final"], tol_share=FOUR_SHARE,
         tol_max=FOUR_MAX, per_frame=per_frame,
         single_frame_ms=ms_single, sharded_frame_ms=ms_sharded,
         loss_single=float(l1), loss_sharded=float(l4), loss_rel_diff=rel)
    return frame_ok and train_ok


PHASES = {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d,
          "e": phase_e, "f": phase_f, "g": phase_g}


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--only", default="abcdefg",
                    help="one-GPU phases to run, e.g. 'b,c'")
    args = ap.parse_args()

    try:
        import jax
    except ImportError:
        print("chip_smoke: JAX is not installed", file=sys.stderr)
        return 2
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from tpuray.scene.procedural import make_interactive_scene
        from tpuray.utils.platform import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the tpuray package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    enable_compile_cache()
    CARD = card()
    print(f"card: {CARD}", flush=True)

    t0 = time.perf_counter()
    ctx = {"scene": make_interactive_scene()}
    ctx["scene_build_s"] = time.perf_counter() - t0
    phases = (["four"] if args.four
              else [p for p in "abcdefg" if p in args.only])
    if any(p in phases for p in "bc"):
        ctx["primary"] = primary_rays()
        ctx["incoherent"] = incoherent_rays(ctx["scene"], *ctx["primary"])
    ok = True
    for p in phases:
        fn = phase_four if p == "four" else PHASES[p]
        try:
            good = fn(ctx) is not False
        except Exception:
            traceback.print_exc()
            emit(p, ok=False, error=traceback.format_exc(limit=3)[-800:])
            good = False
        ok &= good
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
