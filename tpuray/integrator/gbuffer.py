"""G-buffer from the primary hit (replaces the reference's raster pass).

The reference rasterizes the scene to get per-pixel world position, normal,
linear depth, motion vectors and screen-space derivatives
(shaders/rasterize_frag.frag:13-27). We already have the primary hit from the
path tracer, so the G-buffer is derived from it:

 - linearZ replicates gl_FragCoord.z/gl_FragCoord.w = window_z * clip_w
   (rasterize_frag.frag:16); sky pixels hold the 1.0 clear sentinel that the
   SVGF/TAA passes test against (svgf_reproject.frag:167 etc.)
 - velocity = current_uv - previous_uv by projecting the hit's world position
   through both view-projection matrices (rasterize_vert.vert:27-28,
   rasterize_frag.frag:21-24)
 - fwidth terms use GPU-quad-style derivatives: ddx/ddy are differences
   within aligned 2x2 pixel quads, exactly what hardware `fwidth` computes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array


class GBuffer(NamedTuple):
    normal: Array        # (H, W, 3)
    linear_z: Array      # (H, W)   1.0 = sky sentinel
    velocity: Array      # (H, W, 2) uv units
    fwidth_normal: Array  # (H, W)  |fwidth(normal)|
    fwidth_z: Array      # (H, W)  max(|ddx z|, |ddy z|)
    world_pos: Array     # (H, W, 3)


def quad_ddx(img: Array) -> Array:
    """ddx within aligned 2x2 quads: both pixels of a horizontal pair get
    v[x|1] - v[x&~1] (hardware derivative semantics)."""
    w = img.shape[1]
    even = img[:, 0:w:2]
    odd = img[:, 1:w:2]
    d = odd - even
    return jnp.repeat(d, 2, axis=1)[:, :w]


def quad_ddy(img: Array) -> Array:
    h = img.shape[0]
    even = img[0:h:2]
    odd = img[1:h:2]
    d = odd - even
    return jnp.repeat(d, 2, axis=0)[:h]


def _project_uv(view_proj: Array, p: Array) -> tuple[Array, Array]:
    """world point -> (uv in [0,1]^2, clip w)."""
    ph = jnp.concatenate([p, jnp.ones_like(p[..., :1])], axis=-1)
    clip = jnp.einsum("ij,...j->...i", view_proj, ph,
                      precision=jax.lax.Precision.HIGHEST)
    w = clip[..., 3]
    ndc = clip[..., :2] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)[..., None]
    return ndc * 0.5 + 0.5, w


def build_gbuffer(point: Array, normal: Array, valid: Array,
                  view_proj: Array, prev_view_proj: Array,
                  near: float = 0.01, far: float = 1000.0) -> GBuffer:
    """point/normal/valid: (H, W, 3)/(H, W, 3)/(H, W) from the primary hit."""
    uv_now, w_now = _project_uv(view_proj, point)
    uv_prev, _ = _project_uv(prev_view_proj, point)
    velocity = jnp.where(valid[..., None], uv_now - uv_prev, 0.0)

    # linearZ = window_z * clip_w with glm depth mapping ndc_z in [-1, 1]
    d = jnp.maximum(w_now, near)  # clip_w == view-space distance (RH persp)
    ndc_z = ((far + near) - 2.0 * far * near / d) / (far - near)
    window_z = 0.5 * (ndc_z + 1.0)
    linear_z = jnp.where(valid, window_z * d, 1.0)

    nrm = jnp.where(valid[..., None], normal, 0.0)
    fw_n = jnp.linalg.norm(jnp.abs(quad_ddx(nrm)) + jnp.abs(quad_ddy(nrm)), axis=-1)
    fw_z = jnp.maximum(jnp.abs(quad_ddx(linear_z)), jnp.abs(quad_ddy(linear_z)))

    return GBuffer(normal=nrm, linear_z=linear_z, velocity=velocity,
                   fwidth_normal=fw_n, fwidth_z=fw_z,
                   world_pos=jnp.where(valid[..., None], point, 0.0))
