"""Shared image-space helpers for the denoiser stages."""
from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def luminance(c: Array) -> Array:
    """Rec. 709-ish luma used by the SVGF stages (svgf_reproject.frag:158-160)."""
    return 0.2125 * c[..., 0] + 0.7154 * c[..., 1] + 0.0721 * c[..., 2]


def shift2d(img: Array, dy: int, dx: int) -> Array:
    """Static-offset neighbor fetch with edge clamp (GL clamp-to-edge).

    Implemented with static slices + edge broadcast, never an index-array
    gather, so XLA fuses it into the consumer."""
    if dy > 0:
        img = jnp.concatenate(
            [img[dy:], jnp.broadcast_to(img[-1:], (dy,) + img.shape[1:])], axis=0)
    elif dy < 0:
        img = jnp.concatenate(
            [jnp.broadcast_to(img[:1], (-dy,) + img.shape[1:]), img[:dy]], axis=0)
    if dx > 0:
        img = jnp.concatenate(
            [img[:, dx:],
             jnp.broadcast_to(img[:, -1:], (img.shape[0], dx) + img.shape[2:])],
            axis=1)
    elif dx < 0:
        img = jnp.concatenate(
            [jnp.broadcast_to(img[:, :1], (img.shape[0], -dx) + img.shape[2:]),
             img[:, :dx]], axis=1)
    return img


def inside_mask(shape: tuple[int, int], dy: int, dx: int,
                row_window: tuple | None = None) -> Array:
    """True where pixel (y+dy, x+dx) is inside the image.

    row_window=(row0, global_h): the local array is a row shard (plus halo)
    of a taller image — local row i is global row row0+i and the vertical
    bounds test uses global_h, so a halo-extended shard computes exactly
    the single-device mask (tpuray.dist.frame)."""
    h, w = shape
    row0, gh = row_window if row_window is not None else (0, h)
    ys = jnp.arange(h) + row0 + dy
    xs = jnp.arange(w) + dx
    my = (ys >= 0) & (ys < gh)
    mx = (xs >= 0) & (xs < w)
    return my[:, None] & mx[None, :]


def quad_in_rows(yc: Array, row_window: tuple, h: int) -> Array:
    """True where the quad-packed texel at global row yc (already clamped to
    [0, global_h - 1]) holds the same two rows locally as it would in the
    whole image: rows yc and min(yc + 1, global_h - 1) both lie in the h
    local rows of the row_window=(row0, global_h) shard. Reads beyond the
    halo are False; callers treat them as failed history taps."""
    row0, gh = row_window
    local = yc - row0
    return (local >= 0) & ((local <= h - 2)
                           | ((yc >= gh - 1) & (local <= h - 1)))
