"""Fully sharded frame: path trace + SVGF + TAA over a device mesh.

`dist.sharding.render_tiled` shards only the embarrassingly-parallel path
tracing. This module runs the ENTIRE frame — trace, G-buffer, temporal
reprojection, spatial variance, a-trous chain, modulate, TAA, history save —
with image rows sharded across the mesh and the scene replicated. The
denoise stages are stencils, so each stage exchanges exactly the halo rows
it needs with its mesh neighbors via `lax.ppermute` (NCCL over NVLink: a
few hundred KB per frame), then computes on the halo-extended shard with
global-coordinate boundary masks (`row_window` support in denoise/*), so the
denoiser computes what the single-device frame does.

Temporal reprojection and TAA can read arbitrarily far rows under fast
motion; the halo bounds them: history reads farther than `halo` rows from
the shard are treated as reprojection failures (the same response the
algorithm has to disocclusion). Only there does the sharded frame differ
from the single-device one. `halo` also caps the per-iteration a-trous
exchange, so it must be >= 2 * the largest dilation step
(2 * 2^(num_atrous_iterations-1)).

The path tracer runs per shard on its own rays (bounce compaction per
shard), so float reassociation may differ from the single-device program
at isolated grazing hit or shadow tests.

RNG keys off global pixel coordinates, so any mesh size renders the same
image.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuray.denoise.atrous import atrous_iteration
from tpuray.denoise.modulate import modulate
from tpuray.denoise.reproject import reproject
from tpuray.denoise.taa import taa
from tpuray.denoise.variance import estimate_variance
from tpuray.integrator.gbuffer import build_gbuffer
from tpuray.integrator.path_tracer import trace_paths
from tpuray.render.frame_state import FrameState
from tpuray.scene.config import RenderConfig
from tpuray.scene.types import Camera, Scene

Array = jax.Array
AXIS = "tiles"

# FrameState leaves that are (H, W, ...) images (sharded by rows); the rest
# (frame_idx, prev_view_proj) are replicated scalars/matrices
_STATE_IMG_FIELDS = ("illum_hist", "variance_hist", "prev_normal",
                     "prev_linear_z", "moments", "history_len",
                     "accum_color", "taa_color")


def _halo_rows(x: Array, k: int) -> Array:
    """Extend a row shard with k rows from each mesh neighbor.

    The first/last shards replicate their own edge row instead (GL
    clamp-to-edge semantics, matching what the single-device stencils do at
    the image border via denoise.common.shift2d)."""
    n = jax.lax.axis_size(AXIS)
    if n == 1:
        top = jnp.broadcast_to(x[:1], (k,) + x.shape[1:])
        bot = jnp.broadcast_to(x[-1:], (k,) + x.shape[1:])
        return jnp.concatenate([top, x, bot], axis=0)
    i = jax.lax.axis_index(AXIS)
    from_above = jax.lax.ppermute(x[-k:], AXIS,
                                  [(j, j + 1) for j in range(n - 1)])
    from_below = jax.lax.ppermute(x[:k], AXIS,
                                  [(j + 1, j) for j in range(n - 1)])
    top_edge = jnp.broadcast_to(x[:1], (k,) + x.shape[1:])
    bot_edge = jnp.broadcast_to(x[-1:], (k,) + x.shape[1:])
    top = jnp.where(i == 0, top_edge, from_above)
    bot = jnp.where(i == n - 1, bot_edge, from_below)
    return jnp.concatenate([top, x, bot], axis=0)


def _crop(x: Array, k: int) -> Array:
    return x[k:-k] if k else x


@partial(jax.jit, static_argnames=("cfg", "height", "width", "halo", "mesh",
                                   "static_camera"))
def render_frame_sharded(scene: Scene, camera: Camera, state: FrameState,
                         cfg: RenderConfig, height: int, width: int,
                         mesh: Mesh, halo: int = 32,
                         static_camera: bool = False):
    """One full frame with rows sharded over `mesh`.

    Returns (new_state, final_image): new_state's image leaves and the
    final (tonemappable, linear) image are laid out row-sharded; frame_idx
    and prev_view_proj are updated host-side replicated.
    """
    n_dev = mesh.devices.size
    assert height % n_dev == 0, f"height {height} % {n_dev} devices != 0"
    rows = height // n_dev
    assert rows % 2 == 0, "shard rows must be even (G-buffer quad derivs)"
    max_step = 1 << max(cfg.num_atrous_iterations - 1, 0)
    assert halo >= max(2 * max_step, 4), (
        f"halo {halo} < 2*max a-trous step {2 * max_step}")
    assert halo <= rows, f"halo {halo} > shard rows {rows}"
    assert 2 * max_step + 1 <= rows, (
        f"a-trous halo {2 * max_step + 1} exceeds shard rows {rows}; "
        "use fewer devices, a taller image, or fewer iterations")

    frame = state.frame_idx
    state_imgs = tuple(getattr(state, f) for f in _STATE_IMG_FIELDS)

    def tile_fn(scene, eye, cam_to_world, view_proj, tan_half_fov,
                prev_view_proj, frame, *state_imgs):
        (illum_hist, variance_hist, prev_normal, prev_linear_z, moments,
         history_len, accum_color, taa_color) = state_imgs
        i_dev = jax.lax.axis_index(AXIS)
        row0 = i_dev * rows

        # ---- primary rays on this shard's rows (global pixel coords) ----
        yy_l, xx = jnp.meshgrid(jnp.arange(rows), jnp.arange(width),
                                indexing="ij")
        yy = yy_l + row0
        n = rows * width
        xs = (2.0 * (xx.reshape(n).astype(jnp.float32) + 0.5) / width - 1.0) \
            * tan_half_fov
        ys = -(2.0 * (yy.reshape(n).astype(jnp.float32) + 0.5) / height
               - 1.0) * tan_half_fov
        d_cam = jnp.stack([xs, ys, -jnp.ones_like(xs)], axis=-1)
        d = jnp.einsum("ij,nj->ni", cam_to_world, d_cam,
                       precision=jax.lax.Precision.HIGHEST)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        orig = jnp.broadcast_to(eye, (n, 3))
        px = xx.reshape(n)
        py = (height - 1 - yy).reshape(n)

        pt = trace_paths(scene, orig, d, px, py, frame.astype(jnp.uint32),
                         cfg)
        color = pt.color.reshape(rows, width, 3)
        emission = pt.emission.reshape(rows, width, 3)
        albedo = pt.albedo.reshape(rows, width, 3)

        if cfg.accumulate:
            t = 1.0 / (frame.astype(jnp.float32) + 1.0)
            accum = accum_color + (color - accum_color) * t
        else:
            accum = color
        pt_color = accum if cfg.accumulate else color

        # shard rows & row0 are even -> 2x2 quads never straddle shards
        gbuf = build_gbuffer(
            point=pt.first_hit_point.reshape(rows, width, 3),
            normal=pt.first_hit_normal.reshape(rows, width, 3),
            valid=pt.first_hit_valid.reshape(rows, width),
            view_proj=view_proj, prev_view_proj=prev_view_proj)

        # ---- SVGF with per-stage halo exchange ----
        k = halo
        win = (row0 - k, height)
        rep = reproject(
            color=_halo_rows(pt_color, k), emission=_halo_rows(emission, k),
            albedo=_halo_rows(albedo, k), motion=_halo_rows(gbuf.velocity, k),
            normal=_halo_rows(gbuf.normal, k),
            linear_z=_halo_rows(gbuf.linear_z, k),
            fwidth_normal=_halo_rows(gbuf.fwidth_normal, k),
            fwidth_z=_halo_rows(gbuf.fwidth_z, k),
            prev_illum=_halo_rows(illum_hist, k),
            prev_variance=_halo_rows(variance_hist, k),
            prev_normal=_halo_rows(prev_normal, k),
            prev_linear_z=_halo_rows(prev_linear_z, k),
            prev_moments=_halo_rows(moments, k),
            prev_history_len=_halo_rows(history_len, k),
            cfg=cfg, static_camera=static_camera, row_window=win)
        rep_illum = _crop(rep.illum, k)
        rep_var = _crop(rep.variance, k)
        rep_mom = _crop(rep.moments, k)
        rep_hist = _crop(rep.history_len, k)

        kv = 3
        win_v = (row0 - kv, height)
        var = estimate_variance(
            _halo_rows(rep_illum, kv), _halo_rows(rep_var, kv),
            _halo_rows(rep_mom, kv), _halo_rows(rep_hist, kv),
            _halo_rows(gbuf.normal, kv), _halo_rows(gbuf.linear_z, kv),
            _halo_rows(gbuf.fwidth_z, kv), cfg, row_window=win_v)
        illum = _crop(var.illum, kv)
        variance = _crop(var.variance, kv)

        history_tap, history_tap_var = illum, variance
        for it in range(cfg.num_atrous_iterations):
            step = 1 << it
            ka = 2 * step + 1   # taps reach 2*step; variance blur adds 1
            win_a = (row0 - ka, height)
            il_e, va_e = atrous_iteration(
                _halo_rows(illum, ka), _halo_rows(variance, ka),
                _halo_rows(gbuf.normal, ka), _halo_rows(gbuf.linear_z, ka),
                _halo_rows(gbuf.fwidth_z, ka), step, cfg, row_window=win_a)
            illum, variance = _crop(il_e, ka), _crop(va_e, ka)
            if it == cfg.history_atrous_tap:
                history_tap, history_tap_var = illum, variance

        mod = modulate(illum, albedo, emission, gbuf.linear_z)

        kt = max(k, 2)
        win_t = (row0 - kt, height)
        taa_e = taa(_halo_rows(mod, kt), _halo_rows(taa_color, kt),
                    _halo_rows(gbuf.velocity, kt),
                    _halo_rows(gbuf.linear_z, kt), frame,
                    static_camera=static_camera, row_window=win_t)
        taa_out = _crop(taa_e, kt)

        final = taa_out if cfg.enable_taa else mod

        new_imgs = (history_tap, history_tap_var, gbuf.normal, gbuf.linear_z,
                    rep_mom, rep_hist, accum, taa_out)
        return new_imgs + (final, pt_color)

    shard = P(AXIS)
    rep_spec = P()
    out_specs = tuple([shard] * (len(_STATE_IMG_FIELDS) + 2))
    results = jax.shard_map(
        tile_fn, mesh=mesh,
        in_specs=(rep_spec,) * 7 + (shard,) * len(state_imgs),
        out_specs=out_specs,
        check_vma=False,
    )(scene, camera.eye, camera.cam_to_world, camera.view_proj,
      camera.tan_half_fov, state.prev_view_proj, frame, *state_imgs)

    new_imgs, final, pt_color = results[:-2], results[-2], results[-1]
    new_state = state.replace(
        **dict(zip(_STATE_IMG_FIELDS, new_imgs)),
        frame_idx=frame + 1, prev_view_proj=camera.view_proj)
    return new_state, final, pt_color


def shard_state(state: FrameState, mesh: Mesh) -> FrameState:
    """Lay out a FrameState for the mesh: image leaves row-sharded,
    bookkeeping replicated."""
    img = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    kw = {f: jax.device_put(getattr(state, f), img)
          for f in _STATE_IMG_FIELDS}
    return state.replace(
        frame_idx=jax.device_put(state.frame_idx, rep),
        prev_view_proj=jax.device_put(state.prev_view_proj, rep), **kw)
