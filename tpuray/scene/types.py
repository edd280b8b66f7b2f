"""Scene model as JAX pytrees (flat SoA arrays).

The reference stores the scene as interleaved GL texture-buffer records
(15 vec3 per triangle, 4 vec3 per BVH node — reference main.cpp:100-133,
Utils/Triangle.h:12-24). Here the scene is structure-of-arrays pytrees:
every field is a contiguous array, gathers stay dense, and the whole scene is
a pytree that can be donated, replicated, or sharded with jax.sharding.

Materials are *tabled*: triangles carry an int id into a MaterialTable whose
leaves are (M, ...) arrays. This differs from the reference (a full 14-param
material duplicated per triangle, Utils/Triangle.h:12-24) and is what makes
material gradients well-defined: d(image)/d(table row).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

Array = jax.Array


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a leaf),
    with a `.replace(**changes)` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


@pytree_dataclass
class MaterialTable:
    """Disney BSDF parameter table, one row per material.

    Mirrors the 14 parameters of the reference material
    (reference Utils/Material.h:5-20). Negative base_color / metallic /
    roughness mean "fetch from the texture stack" (main.cpp:72-78,
    path_tracing.frag:332-364).
    """

    emissive: Array      # (M, 3) f32
    base_color: Array    # (M, 3) f32  (negative => textured)
    subsurface: Array    # (M,)  f32
    metallic: Array      # (M,)  f32  (negative => textured)
    specular: Array      # (M,)  f32
    specular_tint: Array # (M,)  f32
    roughness: Array     # (M,)  f32  (negative => textured)
    anisotropic: Array   # (M,)  f32
    sheen: Array         # (M,)  f32
    sheen_tint: Array    # (M,)  f32
    clearcoat: Array     # (M,)  f32
    clearcoat_gloss: Array  # (M,) f32
    ior: Array           # (M,)  f32
    transmission: Array  # (M,)  f32

    @staticmethod
    def default(n: int = 1) -> "MaterialTable":
        """Default material, matching Utils/Material.h defaults."""
        f = lambda v: jnp.full((n,), v, jnp.float32)
        return MaterialTable(
            emissive=jnp.zeros((n, 3), jnp.float32),
            base_color=jnp.ones((n, 3), jnp.float32),
            subsurface=f(0.0), metallic=f(0.0), specular=f(0.5),
            specular_tint=f(0.0), roughness=f(0.5), anisotropic=f(0.0),
            sheen=f(0.0), sheen_tint=f(0.5), clearcoat=f(0.0),
            clearcoat_gloss=f(1.0), ior=f(1.0), transmission=f(0.0),
        )

    @property
    def count(self) -> int:
        return self.subsurface.shape[0]


@pytree_dataclass
class TriangleSoA:
    """Triangle geometry, SoA. Indexed in BVH leaf order (post-build permutation)."""

    p0: Array  # (T, 3) f32 vertex positions
    p1: Array  # (T, 3)
    p2: Array  # (T, 3)
    n0: Array  # (T, 3) f32 vertex normals
    n1: Array  # (T, 3)
    n2: Array  # (T, 3)
    uv0: Array  # (T, 2) f32
    uv1: Array  # (T, 2)
    uv2: Array  # (T, 2)
    mat_id: Array  # (T,) int32 -> MaterialTable row
    obj_id: Array  # (T,) int32 -> texture-stack object index

    @property
    def count(self) -> int:
        return self.p0.shape[0]


@pytree_dataclass
class BVHSoA:
    """Threaded (stackless) BVH in DFS preorder.

    The reference traverses a left/right-child BVH with an explicit 256-entry
    stack per fragment (path_tracing.frag:372-424). A per-ray stack makes
    wavefront state huge and divergent; instead nodes are laid out in
    DFS preorder and each node stores a *skip link*: the preorder index of the
    next node once this subtree is done (n_nodes = terminator). Traversal
    state per ray is then a single int pointer:

        next = node + 1           if inner node and AABB hit
        next = skip[node]         otherwise

    Leaves reference a contiguous triangle range [first_tri, first_tri+count).
    """

    aabb_min: Array   # (N, 3) f32
    aabb_max: Array   # (N, 3) f32
    first_tri: Array  # (N,) int32 (leaf only; 0 for inner)
    tri_count: Array  # (N,) int32 (0 => inner node)
    skip: Array       # (N,) int32 preorder escape pointer; n_nodes = done

    @property
    def count(self) -> int:
        return self.aabb_min.shape[0]


@pytree_dataclass
class PointLights:
    """Point lights with quadratic falloff (Utils/PointLight.h:4-15)."""

    position: Array  # (L, 3) f32
    radiance: Array  # (L, 3) f32

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def empty() -> "PointLights":
        return PointLights(
            position=jnp.zeros((0, 3), jnp.float32),
            radiance=jnp.zeros((0, 3), jnp.float32),
        )


@pytree_dataclass
class EnvMap:
    """Equirectangular HDR environment light + importance-sampling cache.

    `cache` packs (inv_cdf_x, inv_cdf_y, pdf) exactly like the reference's
    RGB32F cache texture (Utils/hdr_compute.h:90-99):
      cache[i, j, 0] = invCDF_x(i / H)           (marginal over columns)
      cache[i, j, 1] = invCDF_{y|x(i/H)}(j / W)  (conditional over rows)
      cache[i, j, 2] = pdf[i, j]                 (normalized luminance)
    """

    image: Array  # (H, W, 3) f32 radiance
    cache: Array  # (H, W, 3) f32 (sample_x, sample_y, pdf)

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]


@pytree_dataclass
class TextureStack:
    """Per-object PBR texture stack: 4 layers per object
    (albedo, metallic, normal, roughness), like the reference's
    4096x4096x12 GL_TEXTURE_2D_ARRAY (main.cpp:184-205). Kept small here;
    resolution is a build-time choice, not hard-coded to 4096.
    """

    data: Array  # (n_objects, 4, H, W, 3) f32 in [0,1]

    @property
    def n_objects(self) -> int:
        return self.data.shape[0]


@pytree_dataclass
class Scene:
    triangles: TriangleSoA
    bvh: BVHSoA
    materials: MaterialTable
    lights: PointLights
    envmap: EnvMap
    textures: Optional[TextureStack] = None


@pytree_dataclass
class Camera:
    """Pinhole camera. Primary ray dir = R_c2w @ (px, py, -1) with the NDC
    pix in [-1, 1] (90-degree vfov like Utils/camera.h:5-6,37 and
    path_tracing.frag:1059-1062), generalized to any vfov/aspect.
    """

    eye: Array          # (3,) f32 world position
    cam_to_world: Array  # (3, 3) f32 rotation (camera -> world)
    view_proj: Array    # (4, 4) f32 projection @ view (for motion vectors)
    tan_half_fov: Array  # () f32, tan(vfov/2); 1.0 = 90 degrees

    def ray_directions(self, height: int, width: int) -> Array:
        """(H, W, 3) normalized world-space primary ray directions.

        Pixel centers: ndc = (2*(i+0.5)/res - 1). Row 0 is the *top* image
        row (ndc_y = +1... flipped below so images render upright).
        """
        xs = (2.0 * (jnp.arange(width, dtype=jnp.float32) + 0.5) / width - 1.0)
        ys = (2.0 * (jnp.arange(height, dtype=jnp.float32) + 0.5) / height - 1.0)
        ys = -ys  # row 0 at top
        px, py = jnp.meshgrid(xs * self.tan_half_fov, ys * self.tan_half_fov)
        d_cam = jnp.stack([px, py, -jnp.ones_like(px)], axis=-1)
        d_world = jnp.einsum("ij,hwj->hwi", self.cam_to_world, d_cam,
                             precision=jax.lax.Precision.HIGHEST)
        return d_world / jnp.linalg.norm(d_world, axis=-1, keepdims=True)
