"""Latency-amortized gather tables.

N separate narrow gathers read the same rows N times where one wide gather
reads them once. These helpers pack the per-triangle attribute SoA and the envmap into wide rows so
each shading-time lookup is a single gather:

- triangle attributes -> (T, 32) f32 rows
  [p0 p1 p2 | n0 n1 n2 | uv0 uv1 uv2 | mat_id obj_id pad...]
- envmap (and its cache) -> quad-packed (H, W, 16): the 2x2 bilinear
  neighborhood of every texel in one row, so a bilinear fetch is one gather
  plus vector weights.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.scene.types import Scene, TriangleSoA

Array = jax.Array


class TriTable(NamedTuple):
    data: Array  # (T, 32) f32


def pack_tri_table(tri: TriangleSoA) -> TriTable:
    t = tri.count
    cols = [
        tri.p0, tri.p1, tri.p2,          # 9
        tri.n0, tri.n1, tri.n2,          # 9
        tri.uv0, tri.uv1, tri.uv2,       # 6
        tri.mat_id[:, None].astype(jnp.float32),  # 1
        tri.obj_id[:, None].astype(jnp.float32),  # 1
    ]
    packed = jnp.concatenate(cols, axis=-1)  # (T, 26)
    packed = jnp.pad(packed, ((0, 0), (0, 32 - packed.shape[-1])))
    return TriTable(data=packed)


class TriAttrs(NamedTuple):
    p0: Array
    p1: Array
    p2: Array
    n0: Array
    n1: Array
    n2: Array
    uv0: Array
    uv1: Array
    uv2: Array
    mat_id: Array
    obj_id: Array


def fetch_tri(table: TriTable, idx: Array) -> TriAttrs:
    """One wide gather -> all attributes of triangle idx (any batch shape)."""
    row = table.data[idx]  # (..., 32) single gather
    return TriAttrs(
        p0=row[..., 0:3], p1=row[..., 3:6], p2=row[..., 6:9],
        n0=row[..., 9:12], n1=row[..., 12:15], n2=row[..., 15:18],
        uv0=row[..., 18:20], uv1=row[..., 20:22], uv2=row[..., 22:24],
        mat_id=row[..., 24].astype(jnp.int32),
        obj_id=row[..., 25].astype(jnp.int32),
    )


def quad_pack_image(img: Array) -> Array:
    """(H, W, C<=4) -> (H, W, 4C): texel + right + down + down-right
    neighbors (clamped), so a bilinear fetch needs one gather."""
    c = img.shape[-1]
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:], img[-1:]], axis=0)
    downright = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    out = jnp.concatenate([img, right, down, downright], axis=-1)
    if c == 3:
        out = jnp.pad(out, ((0, 0), (0, 0), (0, 4)))  # pad 12 -> 16
    return out


def bilinear_fetch_packed(qimg: Array, u: Array, v: Array, c: int = 3) -> Array:
    """GL_LINEAR/CLAMP fetch from a quad-packed image: one gather + weights."""
    h, w = qimg.shape[0], qimg.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    # clamp: when x0 is the last column the packed "right" neighbor equals it
    row = qimg[y0i, x0i].astype(jnp.float32)  # (..., 4C) one gather
    c00 = row[..., 0:c]
    c10 = row[..., c:2 * c]
    c01 = row[..., 2 * c:3 * c]
    c11 = row[..., 3 * c:4 * c]
    # edge clamp correction: fx/fy only interpolate inside; at the clamped
    # edge neighbors equal the base texel so the formula degrades gracefully
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def pack_material_table(m) -> Array:
    """MaterialTable -> (M, 32) rows for one-gather fetch."""
    cols = [
        m.emissive, m.base_color,
        m.subsurface[:, None], m.metallic[:, None], m.specular[:, None],
        m.specular_tint[:, None], m.roughness[:, None], m.anisotropic[:, None],
        m.sheen[:, None], m.sheen_tint[:, None], m.clearcoat[:, None],
        m.clearcoat_gloss[:, None], m.ior[:, None], m.transmission[:, None],
    ]
    packed = jnp.concatenate(cols, axis=-1)  # (M, 18)
    return jnp.pad(packed, ((0, 0), (0, 32 - packed.shape[-1])))


_SMALL_TABLE_ROWS = 64


def fetch_small_table(table: Array, idx: Array) -> Array:
    """Row fetch from a small (T<=64, W) table as an unrolled select-chain.

    T broadcast-selects fuse into the consumer with no gather at all. Used
    for the material and light tables."""
    t = int(table.shape[0])
    out = jnp.broadcast_to(table[0], idx.shape + (table.shape[1],))
    for r in range(1, t):
        out = jnp.where((idx == r)[..., None], table[r], out)
    return out


def fetch_material(table: Array, mat_id: Array):
    from tpuray.integrator.disney import ShadeMaterial
    if table.shape[0] <= _SMALL_TABLE_ROWS:
        row = fetch_small_table(table, mat_id)  # select-chain, no gather
    else:
        row = table[mat_id]  # one gather
    return ShadeMaterial(
        emissive=row[..., 0:3], base_color=row[..., 3:6],
        subsurface=row[..., 6], metallic=row[..., 7], specular=row[..., 8],
        specular_tint=row[..., 9], roughness=row[..., 10],
        sheen=row[..., 12], sheen_tint=row[..., 13], clearcoat=row[..., 14],
        clearcoat_gloss=row[..., 15], anisotropic=row[..., 11],
    )


def pack_lights(lights) -> Array:
    """PointLights -> (L, 8) rows [position, radiance, pad]."""
    packed = jnp.concatenate([lights.position, lights.radiance], axis=-1)
    return jnp.pad(packed, ((0, 0), (0, 2)))


def pack_texture_stack(tex: Array) -> Array:
    """(O, 4, H, W, 3) layers -> (O, H, W, 20) bf16 quad-packed combined map
    [albedo.rgb, metallic.r, roughness.r] (one gather resolves all three).

    Stored as bf16 scaled by 255: 16-bit rows halve the bytes a gather
    moves, and 8-bit texel values are integers 0..255 — exact in bf16 — so for byte-sourced
    textures (the reference's BMPs) the fetch is bit-identical to f32.

    PRECONDITION: exactness holds only for byte-sourced inputs (values on
    the k/255 grid, e.g. decoded BMP/PNG). Float-valued stacks (procedural
    or HDR maps) quantize by up to ~0.2% after the *255 bf16 encode."""
    combined = jnp.concatenate([
        tex[:, 0],                 # albedo rgb
        tex[:, 1, ..., :1],        # metallic r
        tex[:, 3, ..., :1],        # roughness r
    ], axis=-1)  # (O, H, W, 5)
    q = jax.vmap(lambda img: _quad_pack_nopad(img))(combined)  # (O, H, W, 20)
    return (q * 255.0).astype(jnp.bfloat16)


def _quad_pack_nopad(img: Array) -> Array:
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:], img[-1:]], axis=0)
    downright = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    return jnp.concatenate([img, right, down, downright], axis=-1)


def tex_fetch_packed(tex_q: Array, obj: Array, u: Array, v: Array) -> Array:
    """Per-ray object texture fetch: (O, H, W, 4C) stack, one gather with a
    combined (obj, y, x) index. Returns the bilinear-filtered C channels."""
    _, h, w, c4 = tex_q.shape
    c = c4 // 4
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    row = tex_q[obj, y0i, x0i].astype(jnp.float32) * (1.0 / 255.0)
    c00 = row[..., 0:c]
    c10 = row[..., c:2 * c]
    c01 = row[..., 2 * c:3 * c]
    c11 = row[..., 3 * c:4 * c]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


class PackedScene(NamedTuple):
    """Gather-friendly companions to a Scene (built once per jitted call;
    pure reshuffles, cheap next to a frame)."""

    tri_table: TriTable
    env_image_q: Array   # (H, W, 16) quad-packed radiance
    env_cache_q: Array   # (H, W, 16) quad-packed (x, y, pdf)
    mat_table: Array     # (M, 32)
    light_table: Array   # (L, 8)
    tex_q: Array | None  # (O, H, W, 20) combined PBR map
    env_nee_t: Array     # (H, W, 8) one-gather NEE rows [L, radiance, pdf, 0]


def pack_scene_tables(scene: Scene) -> PackedScene:
    from tpuray.sampling.envmap import pack_env_nee_table
    return PackedScene(
        tri_table=pack_tri_table(scene.triangles),
        # miss/NEE radiance stays f32: bf16 rows gather 3x faster but the
        # ~0.26% quantization silently changes 1spp output (image-parity is
        # asserted at rtol=1e-5 in tests/test_integrator.py). Quantization is
        # reserved for tables where exactness is provable (pack_texture_stack).
        env_image_q=quad_pack_image(scene.envmap.image),
        env_cache_q=quad_pack_image(scene.envmap.cache),
        mat_table=pack_material_table(scene.materials),
        light_table=pack_lights(scene.lights),
        tex_q=(pack_texture_stack(scene.textures.data)
               if scene.textures is not None else None),
        env_nee_t=pack_env_nee_table(scene.envmap.image, scene.envmap.cache),
    )
