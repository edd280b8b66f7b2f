"""Packed previous-frame atlas for the temporal passes.

Reprojection (denoise/reproject.py) reads illumination, variance, normal,
depth, moments and history length at the *same* reprojected location, so
all prev-frame buffers are packed into one (H, W, 12) atlas:

    [illum(3) | variance(1) | normal(3) | linear_z(1) | moments(2) | hist(1) | pad]

and additionally quad-packed (H, W, 48) so the 4 bilinear taps of everything
are ONE gather per pixel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from tpuray.integrator.gather_tables import _quad_pack_nopad

Array = jax.Array

C = 12  # channels per texel


def build_atlas(illum: Array, variance: Array, normal: Array, linear_z: Array,
                moments: Array, history_len: Array) -> Array:
    """-> the quad-packed atlas (H, W, 48)."""
    atlas = jnp.concatenate([
        illum, variance[..., None], normal, linear_z[..., None],
        moments, history_len[..., None],
    ], axis=-1)
    atlas = jnp.pad(atlas, ((0, 0), (0, 0), (0, C - atlas.shape[-1])))
    return _quad_pack_nopad(atlas)


def split(row: Array):
    """Unpack an atlas row (..., 12) into named fields."""
    return dict(
        illum=row[..., 0:3], variance=row[..., 3], normal=row[..., 4:7],
        linear_z=row[..., 7], moments=row[..., 8:10], history_len=row[..., 10],
    )


def fetch_quad(qatlas: Array, y0: Array, x0: Array):
    """One gather -> the four bilinear taps (each an atlas dict)."""
    h, w = qatlas.shape[0], qatlas.shape[1]
    yc = jnp.clip(y0, 0, h - 1)
    xc = jnp.clip(x0, 0, w - 1)
    row = qatlas[yc, xc]  # (..., 48)
    return [split(row[..., i * C:(i + 1) * C]) for i in range(4)]
