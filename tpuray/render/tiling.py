"""Tile-major ray ordering.

Rays are generated in 32x32-image-tile order, so the rays of one traversal
block (kernels/trace_triton.py) are neighbours on screen and walk the same
BVH nodes. Frame buffers are un-tiled with a single transpose (static
reshape, no gathers).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

TILE = 32


def padded_size(x: int) -> int:
    return (x + TILE - 1) // TILE * TILE


def tile_pixel_coords(height: int, width: int) -> tuple[jax.Array, jax.Array]:
    """(N,) x/y integer pixel coords in tile-major order (padded image)."""
    hp, wp = padded_size(height), padded_size(width)
    ty, tx, iy, ix = jnp.meshgrid(
        jnp.arange(hp // TILE), jnp.arange(wp // TILE),
        jnp.arange(TILE), jnp.arange(TILE), indexing="ij")
    xx = (tx * TILE + ix).reshape(-1)
    yy = (ty * TILE + iy).reshape(-1)
    return xx.astype(jnp.int32), yy.astype(jnp.int32)


def untile(flat: jax.Array, height: int, width: int) -> jax.Array:
    """(N, ...) tile-major -> (H, W, ...) image (cropping padding)."""
    hp, wp = padded_size(height), padded_size(width)
    rest = flat.shape[1:]
    img = flat.reshape(hp // TILE, wp // TILE, TILE, TILE, *rest)
    img = jnp.moveaxis(img, 2, 1).reshape(hp, wp, *rest)
    return img[:height, :width]


def tile_flat(img: jax.Array, height: int, width: int) -> jax.Array:
    """(H, W, ...) image -> (N, ...) tile-major (padding with edge clamp 0)."""
    hp, wp = padded_size(height), padded_size(width)
    pad = [(0, hp - height), (0, wp - width)] + [(0, 0)] * (img.ndim - 2)
    img = jnp.pad(img, pad)
    rest = img.shape[2:]
    t = img.reshape(hp // TILE, TILE, wp // TILE, TILE, *rest)
    t = jnp.moveaxis(t, 1, 2)
    return t.reshape(-1, *rest)
