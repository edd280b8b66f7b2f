"""Scene assembly: OBJ files + materials + lights + envmap -> Scene pytree.

Replaces the reference's hard-coded scene setup in main() (main.cpp:60-205)
with a declarative builder. The default scene mirrors the reference's:
clock.obj, textured PBR material, 4 point lights, a room envmap
(main.cpp:72-80, 157-168) — with procedurally generated assets standing in
for the .hdr/.bmp files the reference does not ship.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax.numpy as jnp
import numpy as np

from tpuray.accel.bvh import build_bvh
from tpuray.io import fallback, native
from tpuray.io.hdr import read_hdr
from tpuray.io.obj import load_obj, transform_matrix
from tpuray.scene.types import (
    BVHSoA, EnvMap, MaterialTable, PointLights, Scene, TextureStack, TriangleSoA,
)

# the reference's four point lights (main.cpp:157-160): (position, radiance)
REFERENCE_LIGHTS = (
    ((0.5, 0.5, 0.5), (10.0, 10.0, 10.0)),
    ((-0.5, 0.75, 0.5), (8.0, 4.0, 4.0)),
    ((-0.5, 0.75, 0.75), (0.0, 3.0, 4.0)),
    ((0.75, 0.75, 0.75), (12.0, 3.0, 4.0)),
)

_MATERIAL_DEFAULTS = dict(
    emissive=(0.0, 0.0, 0.0), base_color=(1.0, 1.0, 1.0), subsurface=0.0,
    metallic=0.0, specular=0.5, specular_tint=0.0, roughness=0.5,
    anisotropic=0.0, sheen=0.0, sheen_tint=0.5, clearcoat=0.0,
    clearcoat_gloss=1.0, ior=1.0, transmission=0.0,
)


@dataclasses.dataclass
class ObjectSpec:
    """One model instance: geometry + material (+ optional texture layers)."""

    path: str  # resolved against the asset roots (tpuray.io.filesystem)
    material: dict = dataclasses.field(default_factory=dict)
    rotate_deg: tuple = (0.0, 0.0, 0.0)
    translate: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)
    smooth_normals: bool = True
    # texture layers keyed albedo/metallic/normal/roughness: (H,W,3) float
    # arrays, or image file paths (any tpuray.io.image.read_image format)
    textures: dict = dataclasses.field(default_factory=dict)


def make_material_table(materials: Sequence[dict]) -> MaterialTable:
    rows = [dict(_MATERIAL_DEFAULTS, **m) for m in materials]
    f32 = lambda key: jnp.asarray([r[key] for r in rows], jnp.float32)
    return MaterialTable(
        emissive=f32("emissive"), base_color=f32("base_color"),
        subsurface=f32("subsurface"), metallic=f32("metallic"),
        specular=f32("specular"), specular_tint=f32("specular_tint"),
        roughness=f32("roughness"), anisotropic=f32("anisotropic"),
        sheen=f32("sheen"), sheen_tint=f32("sheen_tint"),
        clearcoat=f32("clearcoat"), clearcoat_gloss=f32("clearcoat_gloss"),
        ior=f32("ior"), transmission=f32("transmission"),
    )


def make_env_cache(image: np.ndarray) -> np.ndarray:
    cache = native.env_cache_native(image)
    if cache is None:
        cache = fallback.env_cache_py(image)
    return cache


def procedural_room_envmap(width: int = 512, deterministic: bool = True) -> np.ndarray:
    """A synthetic 'room' HDR: sky-like gradient, a bright window patch, a
    warm lamp blob, and a dim floor — enough dynamic range to exercise
    importance sampling. Stands in for the reference's missing room.hdr.
    """
    h = width // 2
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]  # 0=up
    u = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :]
    img = np.zeros((h, width, 3), np.float32)
    # ambient gradient: brighter toward the ceiling, slightly blue
    img[..., 0] = 0.35 * (1.0 - 0.7 * v)
    img[..., 1] = 0.40 * (1.0 - 0.6 * v)
    img[..., 2] = 0.50 * (1.0 - 0.5 * v)
    # window: bright cool patch
    win = np.exp(-(((u - 0.25) / 0.06) ** 2 + ((v - 0.45) / 0.12) ** 2))
    img += win[..., None] * np.array([18.0, 20.0, 24.0], np.float32)
    # lamp: warm blob
    lamp = np.exp(-(((u - 0.7) / 0.03) ** 2 + ((v - 0.2) / 0.05) ** 2))
    img += lamp[..., None] * np.array([40.0, 28.0, 12.0], np.float32)
    # floor: dim warm brown
    floor = (v > 0.62).astype(np.float32)
    img = img * (1 - floor[..., None]) + floor[..., None] * np.array([0.20, 0.15, 0.10])
    return img


def procedural_texture_layers(res: int = 256, seed: int = 7) -> dict:
    """Deterministic PBR texture layers (albedo/metallic/normal/roughness)
    for textured-material tests — stand-ins for the reference's clock/plant
    BMP sets (main.cpp:197-205)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    checker = ((np.floor(xx * 8) + np.floor(yy * 8)) % 2).astype(np.float32)
    albedo = np.stack([
        0.2 + 0.6 * checker, 0.3 + 0.3 * (1 - checker), 0.25 + 0.2 * np.sin(xx * 9)**2,
    ], axis=-1).astype(np.float32)
    metallic = np.repeat((0.1 + 0.8 * checker)[..., None], 3, axis=-1).astype(np.float32)
    rough_base = 0.3 + 0.5 * np.abs(np.sin(yy * 13))
    roughness = np.repeat(rough_base[..., None], 3, axis=-1).astype(np.float32)
    nrm = np.stack([
        0.5 + 0.08 * np.sin(xx * 40), 0.5 + 0.08 * np.cos(yy * 40),
        np.full_like(xx, 0.95),
    ], axis=-1).astype(np.float32)
    del rng
    return dict(albedo=albedo, metallic=metallic, normal=nrm, roughness=roughness)


def build_scene(
    objects: Sequence[ObjectSpec],
    point_lights: Sequence[tuple] = (),
    envmap: np.ndarray | str | None = None,
    leaf_size: int = 8,
    texture_res: int = 256,
    reference_quirks: bool = False,
    with_textures: bool = False,
) -> Scene:
    all_p, all_n, all_uv, all_mat, all_obj = [], [], [], [], []
    materials = []
    tex_layers = []
    from tpuray.io.filesystem import resolve
    for i, spec in enumerate(objects):
        tm = transform_matrix(spec.rotate_deg, spec.translate, spec.scale)
        geo = load_obj(resolve(spec.path), tm, spec.smooth_normals,
                       reference_quirks=reference_quirks)
        t = geo["positions"].shape[0]
        all_p.append(geo["positions"])
        all_n.append(geo["normals"])
        all_uv.append(geo["uvs"])
        all_mat.append(np.full((t,), i, np.int32))
        all_obj.append(np.full((t,), i, np.int32))
        materials.append(spec.material)
        if with_textures:
            layers = spec.textures or procedural_texture_layers(texture_res, seed=7 + i)
            layers = {k: _load_texture_layer(v) for k, v in layers.items()}
            stack = np.stack([
                _resize_nearest(layers["albedo"], texture_res),
                _resize_nearest(layers["metallic"], texture_res),
                _resize_nearest(layers["normal"], texture_res),
                _resize_nearest(layers["roughness"], texture_res),
            ])
            tex_layers.append(stack)

    pos = np.concatenate(all_p)
    nrm = np.concatenate(all_n)
    uv = np.concatenate(all_uv)
    mat_id = np.concatenate(all_mat)
    obj_id = np.concatenate(all_obj)

    bvh = build_bvh(pos, leaf_size)
    perm = bvh["perm"]
    tri = TriangleSoA(
        p0=jnp.asarray(pos[perm, 0]), p1=jnp.asarray(pos[perm, 1]), p2=jnp.asarray(pos[perm, 2]),
        n0=jnp.asarray(nrm[perm, 0]), n1=jnp.asarray(nrm[perm, 1]), n2=jnp.asarray(nrm[perm, 2]),
        uv0=jnp.asarray(uv[perm, 0]), uv1=jnp.asarray(uv[perm, 1]), uv2=jnp.asarray(uv[perm, 2]),
        mat_id=jnp.asarray(mat_id[perm]), obj_id=jnp.asarray(obj_id[perm]),
    )
    bvh_soa = BVHSoA(
        aabb_min=jnp.asarray(bvh["aabb_min"]), aabb_max=jnp.asarray(bvh["aabb_max"]),
        first_tri=jnp.asarray(bvh["first_tri"]), tri_count=jnp.asarray(bvh["tri_count"]),
        skip=jnp.asarray(bvh["skip"]),
    )

    if point_lights:
        lights = PointLights(
            position=jnp.asarray([p for p, _ in point_lights], jnp.float32),
            radiance=jnp.asarray([r for _, r in point_lights], jnp.float32),
        )
    else:
        lights = PointLights.empty()

    if envmap is None:
        env_img = procedural_room_envmap()
    elif isinstance(envmap, str):
        env_img = read_hdr(envmap)
    else:
        env_img = np.asarray(envmap, np.float32)
    env = EnvMap(image=jnp.asarray(env_img), cache=jnp.asarray(make_env_cache(env_img)))

    textures = TextureStack(data=jnp.asarray(np.stack(tex_layers))) if tex_layers else None

    return Scene(triangles=tri, bvh=bvh_soa, materials=make_material_table(materials),
                 lights=lights, envmap=env, textures=textures)


def _load_texture_layer(layer) -> np.ndarray:
    """A texture layer spec is either an (H,W,3) float array or an image
    file path (resolved against the asset roots, decoded by read_image —
    the load_texture_to_material_array role, help_func.h:4-20)."""
    if isinstance(layer, (str, bytes)):
        from tpuray.io.filesystem import resolve
        from tpuray.io.image import read_image
        return read_image(resolve(layer))
    return np.asarray(layer, np.float32)


def _resize_nearest(img: np.ndarray, res: int) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if img.shape[0] == res and img.shape[1] == res:
        return img
    yi = (np.arange(res) * img.shape[0] // res).clip(0, img.shape[0] - 1)
    xi = (np.arange(res) * img.shape[1] // res).clip(0, img.shape[1] - 1)
    return img[yi][:, xi]


def reference_default_scene(reference_obj_dir: str | None = None,
                            **kw) -> Scene:
    """The reference's startup scene (main.cpp:72-80: clock.obj, specular=0,
    clearcoat=0, textured base_color/metallic/roughness; 4 point lights
    main.cpp:157-160; room envmap). Assets resolve against the configured
    roots (tpuray.io.filesystem, $TPURAY_ASSET_ROOT) unless
    reference_obj_dir pins a directory."""
    clock = ObjectSpec(
        path=(f"{reference_obj_dir}/clock.obj" if reference_obj_dir
              else "models/clock.obj"),
        material=dict(base_color=(-1.0, -1.0, -1.0), metallic=-1.0,
                      roughness=-1.0, specular=0.0, clearcoat=0.0,
                      clearcoat_gloss=0.0),
    )
    kw.setdefault("with_textures", True)
    return build_scene([clock], point_lights=REFERENCE_LIGHTS, **kw)
