"""Temporal anti-aliasing (shaders/taa.frag).

3x3 closest-depth velocity dilation, YCoCgR color space, luminance tonemap
for clipping stability, mu +/- gamma*sigma variance clipping of the history
toward the current 3x3 neighborhood, velocity-scaled blend factor.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuray.denoise.common import shift2d

Array = jax.Array


def rgb_to_ycocgr(c: Array) -> Array:
    co = c[..., 0] - c[..., 2]
    tmp = c[..., 2] + co / 2.0
    cg = c[..., 1] - tmp
    y = tmp + cg / 2.0
    return jnp.stack([y, co, cg], axis=-1)


def ycocgr_to_rgb(c: Array) -> Array:
    tmp = c[..., 0] - c[..., 2] / 2.0
    g = c[..., 2] + tmp
    b = tmp - c[..., 1] / 2.0
    r = b + c[..., 1]
    return jnp.stack([r, g, b], axis=-1)


def _taa_luminance(c: Array) -> Array:
    return 0.25 * c[..., 0] + 0.5 * c[..., 1] + 0.25 * c[..., 2]


def taa_tonemap(c: Array) -> Array:
    return c / (1.0 + _taa_luminance(c))[..., None]


def taa_untonemap(c: Array) -> Array:
    return c / jnp.maximum(1.0 - _taa_luminance(c), 1e-6)[..., None]


def closest_velocity(velocity: Array, linear_z: Array) -> Array:
    """Velocity of the closest-depth pixel in the 3x3 neighborhood
    (taa.frag:15-39)."""
    h, w = linear_z.shape
    best_z = jnp.full((h, w), jnp.inf, jnp.float32)
    best_vel = velocity
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            z = shift2d(linear_z, dy, dx)
            better = z < best_z
            best_z = jnp.where(better, z, best_z)
            # select the shifted velocity directly: no gather needed
            best_vel = jnp.where(better[..., None],
                                 shift2d(velocity, dy, dx), best_vel)
    return best_vel


def clip_aabb(cur_ycc_3x3_mu, cur_ycc_3x3_sigma, prev_ycc, gamma=1.0):
    """Variance clip of history toward the neighborhood box center
    (taa.frag:80-121)."""
    aabb_min = cur_ycc_3x3_mu - gamma * cur_ycc_3x3_sigma
    aabb_max = cur_ycc_3x3_mu + gamma * cur_ycc_3x3_sigma
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = prev_ycc - p_clip
    v_unit = v_clip / jnp.where(jnp.abs(e_clip) < 1e-12, 1e-12, e_clip)
    ma = jnp.max(jnp.abs(v_unit), axis=-1, keepdims=True)
    clipped = p_clip + v_clip / jnp.maximum(ma, 1e-12)
    return jnp.where(ma > 1.0, clipped, prev_ycc)


def _history_fetch(prev_color: Array, vel: Array,
                   row_window: tuple | None = None):
    """Bilinear clamp-to-edge history fetch at uv - velocity
    (taa.frag:137-139); the 2x2 neighbourhood is quad-packed, so the fetch
    is one gather. -> (history, held): on a row_window shard (see
    tpuray.dist.frame) `held` is False where the quad lies beyond the
    shard's rows, and the caller drops the history there; None otherwise."""
    from tpuray.denoise.common import quad_in_rows
    from tpuray.integrator.gather_tables import quad_pack_image

    h, w = prev_color.shape[:2]
    row0, gh = row_window if row_window is not None else (0, h)
    yy, xx = jnp.meshgrid(jnp.arange(h) + row0, jnp.arange(w), indexing="ij")
    u = jnp.clip((xx + 0.5) / w - vel[..., 0], 0.0, 1.0)
    v = jnp.clip((yy + 0.5) / gh - vel[..., 1], 0.0, 1.0)
    x = u * w - 0.5
    y = v * gh - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, gh - 1)
    # at the clamped edge the packed neighbours equal the base texel
    row = quad_pack_image(prev_color)[jnp.clip(y0i - row0, 0, h - 1), x0i]
    c00, c10, c01, c11 = (row[..., i * 3:(i + 1) * 3] for i in range(4))
    prev = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
    if row_window is None:
        return prev, None
    return prev, quad_in_rows(y0i, row_window, h)


def taa(cur_color: Array, prev_color: Array, velocity: Array,
        linear_z: Array, frame: Array | int,
        static_camera: bool = False,
        row_window: tuple | None = None) -> Array:
    # row_window: halo-extended row shard; see tpuray.dist.frame
    h, w = linear_z.shape
    sky = linear_z == 1.0
    hist_ok = None

    if static_camera:
        # motion == 0: history fetch is the same pixel, no gather
        vel = jnp.zeros((h, w, 2), jnp.float32)
        prev = prev_color
    else:
        vel = closest_velocity(velocity, linear_z)
        prev, hist_ok = _history_fetch(prev_color, vel, row_window)

    now_ycc = rgb_to_ycocgr(taa_tonemap(cur_color))
    prev_ycc = rgb_to_ycocgr(taa_tonemap(prev))

    m1 = jnp.zeros_like(now_ycc)
    m2 = jnp.zeros_like(now_ycc)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            c = rgb_to_ycocgr(taa_tonemap(shift2d(cur_color, dy, dx)))
            m1 = m1 + c
            m2 = m2 + c * c
    mu = m1 / 9.0
    sigma = jnp.sqrt(jnp.abs(m2 / 9.0 - mu * mu))

    prev_ycc = clip_aabb(mu, sigma, prev_ycc)

    now_rgb = taa_untonemap(ycocgr_to_rgb(now_ycc))
    prev_rgb = taa_untonemap(ycocgr_to_rgb(prev_ycc))

    blend = jnp.clip(0.05 + jnp.linalg.norm(vel, axis=-1) * 100.0, 0.0, 1.0)
    if hist_ok is not None:
        blend = jnp.where(hist_ok, blend, 1.0)  # no history -> current color
    out = blend[..., None] * now_rgb + (1.0 - blend)[..., None] * prev_rgb

    first_frame = jnp.asarray(frame, jnp.int32) == 0
    passthrough = first_frame | sky
    return jnp.where(passthrough[..., None], cur_color, out)
