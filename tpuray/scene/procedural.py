"""Procedural test geometry — scenes with no file dependencies.

Used by tests, __graft_entry__ and benchmarks so the framework is exercisable
without the reference's assets.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from tpuray.accel.bvh import build_bvh
from tpuray.scene.builder import (
    REFERENCE_LIGHTS, make_env_cache, make_material_table,
    procedural_room_envmap)
from tpuray.scene.types import (
    BVHSoA, EnvMap, MaterialTable, PointLights, Scene, TriangleSoA,
)
import jax.numpy as jnp


def icosphere(subdiv: int = 2, radius: float = 0.5, center=(0, 0, 0)) -> np.ndarray:
    """(T, 3, 3) triangle vertices of a subdivided icosahedron."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdiv):
        new_faces = []
        mids: dict[tuple[int, int], int] = {}
        verts_l = verts.tolist()

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = (np.asarray(verts_l[a]) + np.asarray(verts_l[b])) / 2
                m = m / np.linalg.norm(m)
                mids[key] = len(verts_l)
                verts_l.append(m.tolist())
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_l)
        faces = np.asarray(new_faces)
    tri = verts[faces] * radius + np.asarray(center)
    return tri.astype(np.float32)


def ground_quad(y: float = -0.5, half: float = 4.0) -> np.ndarray:
    a = [-half, y, -half]
    b = [half, y, -half]
    c = [half, y, half]
    d = [-half, y, half]
    return np.asarray([[a, b, c], [a, c, d]], np.float32)


def make_test_scene(subdiv: int = 2, with_lights: bool = True,
                    env_width: int = 128, leaf_size: int = 8) -> Scene:
    """Sphere on a ground plane under the procedural room envmap."""
    sphere = icosphere(subdiv)
    ground = ground_quad()
    tris = np.concatenate([sphere, ground])
    mat_id = np.concatenate([
        np.zeros(len(sphere), np.int32), np.ones(len(ground), np.int32)])

    bvh = build_bvh(tris, leaf_size)
    perm = bvh["perm"]
    tris = tris[perm]
    mat_id = mat_id[perm]

    # smooth normals for the sphere (= normalized positions), flat for ground
    n_sphere = len(sphere)
    normals = np.empty_like(tris)
    for k in range(3):
        v = tris[:, k, :]
        sphere_n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where(
            (mat_id == 0)[:, None], sphere_n, np.asarray([0.0, 1.0, 0.0]))

    uvs = np.zeros((len(tris), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0

    soa = TriangleSoA(
        p0=jnp.asarray(tris[:, 0]), p1=jnp.asarray(tris[:, 1]), p2=jnp.asarray(tris[:, 2]),
        n0=jnp.asarray(normals[:, 0]), n1=jnp.asarray(normals[:, 1]), n2=jnp.asarray(normals[:, 2]),
        uv0=jnp.asarray(uvs[:, 0]), uv1=jnp.asarray(uvs[:, 1]), uv2=jnp.asarray(uvs[:, 2]),
        mat_id=jnp.asarray(mat_id), obj_id=jnp.asarray(mat_id),
    )
    bvh_soa = BVHSoA(
        aabb_min=jnp.asarray(bvh["aabb_min"]), aabb_max=jnp.asarray(bvh["aabb_max"]),
        first_tri=jnp.asarray(bvh["first_tri"]), tri_count=jnp.asarray(bvh["tri_count"]),
        skip=jnp.asarray(bvh["skip"]))

    materials = make_material_table([
        dict(base_color=(0.8, 0.3, 0.25), roughness=0.35, metallic=0.1,
             clearcoat=0.5, specular=0.5),
        dict(base_color=(0.55, 0.55, 0.6), roughness=0.8),
    ])

    lights = (PointLights(position=jnp.asarray([[1.0, 1.2, 1.0], [-1.2, 0.8, 0.5]], jnp.float32),
                          radiance=jnp.asarray([[6.0, 6.0, 5.0], [2.0, 2.5, 4.0]], jnp.float32))
              if with_lights else PointLights.empty())

    env_img = procedural_room_envmap(env_width)
    env = EnvMap(image=jnp.asarray(env_img), cache=jnp.asarray(make_env_cache(env_img)))
    return Scene(triangles=soa, bvh=bvh_soa, materials=materials,
                 lights=lights, envmap=env, textures=None)


def make_large_scene(n_spheres: int = 25, subdiv: int = 3,
                     leaf_size: int = 8, env_width: int = 128,
                     seed: int = 11) -> Scene:
    """Procedural large scene: n_spheres icospheres (20*4^subdiv tris each)
    scattered over a ground quad, built as one BVH. 25 spheres at subdiv 2
    ~= 8k tris (the reference clock model's scale); subdiv 3 ~= 32k;
    subdiv 4 ~= 128k; subdiv 5 ~= 512k.
    """
    rs = np.random.RandomState(seed)
    blobs = []
    for i in range(n_spheres):
        r = 0.12 + 0.18 * rs.rand()
        c = (rs.rand(3) - 0.5) * np.asarray([3.0, 1.2, 3.0])
        c[1] = max(c[1], -0.5 + r)
        blobs.append(icosphere(subdiv, radius=r, center=tuple(c)))
    ground = ground_quad()
    tris = np.concatenate(blobs + [ground]).astype(np.float32)
    mat_id = np.concatenate(
        [np.full(len(b), i % 2, np.int32) for i, b in enumerate(blobs)]
        + [np.ones(len(ground), np.int32)])

    centers = np.concatenate(
        [np.tile(b.mean(axis=(0, 1)), (len(b), 1)) for b in blobs]
        + [np.zeros((len(ground), 3), np.float32)]).astype(np.float32)

    bvh = build_bvh(tris, leaf_size)
    perm = bvh["perm"]
    tris_p = tris[perm]
    mat_p = mat_id[perm]
    ctr_p = centers[perm]

    # smooth sphere normals (= direction from blob center), flat ground
    normals = np.empty_like(tris_p)
    is_ground = np.zeros(len(tris), bool)
    is_ground[-len(ground):] = True
    is_ground = is_ground[perm]
    for k in range(3):
        v = tris_p[:, k, :] - ctr_p
        n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
        normals[:, k, :] = np.where(is_ground[:, None],
                                    np.asarray([0.0, 1.0, 0.0]), n)

    uvs = np.zeros((len(tris_p), 3, 2), np.float32)
    uvs[:, 1, 0] = 1.0
    uvs[:, 2, 1] = 1.0

    soa = TriangleSoA(
        p0=jnp.asarray(tris_p[:, 0]), p1=jnp.asarray(tris_p[:, 1]),
        p2=jnp.asarray(tris_p[:, 2]),
        n0=jnp.asarray(normals[:, 0]), n1=jnp.asarray(normals[:, 1]),
        n2=jnp.asarray(normals[:, 2]),
        uv0=jnp.asarray(uvs[:, 0]), uv1=jnp.asarray(uvs[:, 1]),
        uv2=jnp.asarray(uvs[:, 2]),
        mat_id=jnp.asarray(mat_p), obj_id=jnp.asarray(mat_p))
    bvh_soa = BVHSoA(
        aabb_min=jnp.asarray(bvh["aabb_min"]), aabb_max=jnp.asarray(bvh["aabb_max"]),
        first_tri=jnp.asarray(bvh["first_tri"]), tri_count=jnp.asarray(bvh["tri_count"]),
        skip=jnp.asarray(bvh["skip"]))

    materials = make_material_table([
        dict(base_color=(0.75, 0.35, 0.3), roughness=0.4, metallic=0.2),
        dict(base_color=(0.5, 0.55, 0.65), roughness=0.7),
    ])
    lights = PointLights(
        position=jnp.asarray([[2.0, 2.2, 2.0]], jnp.float32),
        radiance=jnp.asarray([[20.0, 19.0, 17.0]], jnp.float32))
    env_img = procedural_room_envmap(env_width)
    env = EnvMap(image=jnp.asarray(env_img),
                 cache=jnp.asarray(make_env_cache(env_img)))
    return Scene(triangles=soa, bvh=bvh_soa, materials=materials,
                 lights=lights, envmap=env, textures=None)


ASSET_ENVMAP = Path(__file__).resolve().parents[2] / "assets" / "recovered_env.hdr"


def make_interactive_scene(seed: int = 11) -> Scene:
    """The reference's interactive workload at its model's scale, from the
    repo alone: 25 icospheres at subdiv 2 over a ground quad (8002
    triangles; the reference clock model has ~8.3k), the reference's four
    point lights and the HDR envmap assets/recovered_env.hdr."""
    from tpuray.io.hdr import read_hdr
    scene = make_large_scene(n_spheres=25, subdiv=2, seed=seed)
    env_img = read_hdr(str(ASSET_ENVMAP))
    env = EnvMap(image=jnp.asarray(env_img),
                 cache=jnp.asarray(make_env_cache(env_img)))
    lights = PointLights(
        position=jnp.asarray([p for p, _ in REFERENCE_LIGHTS], jnp.float32),
        radiance=jnp.asarray([r for _, r in REFERENCE_LIGHTS], jnp.float32))
    return scene.replace(lights=lights, envmap=env)
