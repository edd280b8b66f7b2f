"""Ray intersection: triangle test, AABB slab test, stackless BVH traversal.

Re-design of the reference's traversal (path_tracing.frag:215-424).
The reference runs a per-fragment DFS with a 256-entry stack and near-child
ordering; a per-ray stack is hostile to a lock-step SIMD wavefront, so we use
the threaded DFS layout (BVHSoA.skip) and a *single-pointer* traversal:

    entering a node: slab-test its own AABB (culled against the current
    best t). Inner+hit -> descend to node+1. Leaf+hit -> scan its triangles
    one per step. Otherwise -> follow the skip link.

Every ray advances one node-or-triangle per `lax.while_loop` iteration, so
per-step work is one AABB test OR one triangle test — small, uniform, fully
vectorized over (N,) rays. Traversal returns *topology only* (t, triangle
index); shading re-intersects the winning triangle differentiably
(tpuray.integrator.path_tracer), which keeps this loop gradient-free.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.scene.types import BVHSoA, TriangleSoA

Array = jax.Array

INF = np.float32(1e30)
# reference epsilons (path_tracing.frag:236-240)
T_MIN = np.float32(5e-4)
PARALLEL_EPS = np.float32(1e-5)


def ray_triangle(orig: Array, d: Array, p0: Array, p1: Array, p2: Array
                 ) -> tuple[Array, Array, Array]:
    """Reference-style plane + half-space triangle test
    (path_tracing.frag:215-272): two-sided, inside flag, t >= 5e-4.

    All args (..., 3). Returns (hit mask, t, is_inside).
    """
    n = jnp.cross(p1 - p0, p2 - p0)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    ndotd = jnp.sum(n * d, axis=-1)
    inside = ndotd > 0.0
    n_f = jnp.where(inside[..., None], -n, n)  # face the ray
    ndotd_f = jnp.sum(n_f * d, axis=-1)

    denom = jnp.where(jnp.abs(ndotd_f) < PARALLEL_EPS, 1.0, ndotd_f)
    t = (jnp.sum(n_f * p0, axis=-1) - jnp.sum(orig * n_f, axis=-1)) / denom
    p = orig + d * t[..., None]

    c0 = jnp.sum(jnp.cross(p1 - p0, p - p0) * n_f, axis=-1)
    c1 = jnp.sum(jnp.cross(p2 - p1, p - p1) * n_f, axis=-1)
    c2 = jnp.sum(jnp.cross(p0 - p2, p - p2) * n_f, axis=-1)
    in_tri = ((c0 > 0) & (c1 > 0) & (c2 > 0)) | ((c0 < 0) & (c1 < 0) & (c2 < 0))

    hit = (jnp.abs(ndotd) >= PARALLEL_EPS) & (t >= T_MIN) & in_tri
    return hit, jnp.where(hit, t, INF), inside


def triangle_constants(tri: TriangleSoA):
    """Precompute per-triangle intersection constants (Baldwin-Weber style).

    Replaces the per-ray cross products of the reference predicate
    (path_tracing.frag:246-250) with a plane equation + two barycentric
    plane transforms, computed ONCE per triangle:

        t = (np0 - n.o) / (n.d)      u = T1.p + t1w      v = T2.p + t2w
        hit iff u > 0, v > 0, u + v < 1   (strictly inside, two-sided)

    Exactly the same hit set as the half-space form in real arithmetic;
    ~2x fewer per-ray vector ops. Returns dict of (T,3)/(T,) f32 arrays.
    """
    p0, p1, p2 = tri.p0, tri.p1, tri.p2
    e1 = p1 - p0
    e2 = p2 - p0
    nraw = jnp.cross(e1, e2)
    nlen = jnp.linalg.norm(nraw, axis=-1, keepdims=True)
    n = nraw / jnp.maximum(nlen, 1e-30)
    degenerate = (nlen < 1e-20)[..., 0]

    a1 = jnp.cross(e2, n)
    det1 = jnp.sum(e1 * a1, axis=-1, keepdims=True)
    T1 = a1 / jnp.where(jnp.abs(det1) < 1e-30, 1.0, det1)
    a2 = jnp.cross(e1, n)
    det2 = jnp.sum(e2 * a2, axis=-1, keepdims=True)
    T2 = a2 / jnp.where(jnp.abs(det2) < 1e-30, 1.0, det2)
    # degenerate triangles can never hit: zero the transforms so u=v=0
    zero = jnp.where(degenerate[..., None], 0.0, 1.0)
    n = n * zero
    T1 = T1 * zero
    T2 = T2 * zero
    return dict(
        n=n.astype(jnp.float32),
        np0=jnp.sum(n * p0, axis=-1).astype(jnp.float32),
        t1=T1.astype(jnp.float32),
        t1w=(-jnp.sum(T1 * p0, axis=-1) * zero[..., 0]).astype(jnp.float32),
        t2=T2.astype(jnp.float32),
        t2w=(-jnp.sum(T2 * p0, axis=-1) * zero[..., 0]).astype(jnp.float32),
    )


def ray_triangle_pre(ox, oy, oz, dx, dy, dz,
                     nx, ny, nz, np0, t1x, t1y, t1z, t1w,
                     t2x, t2y, t2z, t2w) -> tuple[Array, Array]:
    """Scalarized precomputed triangle test. Op order here is mirrored by
    the GPU traversal kernel (kernels/trace_triton.py) so the oracle and the
    kernel agree up to FMA contraction and division rounding.
    Returns (hit, t)."""
    ndotd = nx * dx + ny * dy + nz * dz
    ndoto = nx * ox + ny * oy + nz * oz
    invalid = jnp.abs(ndotd) < PARALLEL_EPS
    denom = jnp.where(invalid, np.float32(1.0), ndotd)
    t = (np0 - ndoto) / denom
    px = ox + dx * t
    py = oy + dy * t
    pz = oz + dz * t
    u = t1x * px + t1y * py + t1z * pz + t1w
    v = t2x * px + t2y * py + t2z * pz + t2w
    in_tri = (u > 0) & (v > 0) & (u + v < 1)
    hit = jnp.logical_not(invalid) & (t >= T_MIN) & in_tri
    return hit, jnp.where(hit, t, INF)


def ray_aabb(orig: Array, inv_d: Array, amin: Array, amax: Array,
             t_limit: Array) -> Array:
    """Slab test (path_tracing.frag:275-288 semantics) with occlusion cull:
    hit iff the box overlaps (0, t_limit] along the ray."""
    f = (amax - orig) * inv_d
    n = (amin - orig) * inv_d
    t1 = jnp.min(jnp.maximum(f, n), axis=-1)
    t0 = jnp.max(jnp.minimum(f, n), axis=-1)
    return (t1 >= jnp.maximum(t0, 0.0)) & (t0 < t_limit) & (t1 > 0.0)


@partial(jax.jit, static_argnames=("any_hit",))
def trace(bvh: BVHSoA, tri: TriangleSoA, orig: Array, d: Array,
          t_max: Array | float = INF, any_hit: bool = False
          ) -> tuple[Array, Array]:
    """Nearest-hit (or any-hit) traversal for a wavefront of rays.

    orig, d: (N, 3). t_max: scalar or (N,) — hits beyond it are ignored.
    Returns (t (N,), tri_idx (N,) int32); tri_idx = -1 and t = INF for miss.
    With any_hit=True a ray stops at its first accepted hit (shadow rays).
    """
    n_nodes = bvh.count
    n = orig.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    # dead-lane convention shared with the GPU kernel: t_max <= 0 means
    # "masked off" — snap to -INF so an inside-the-box origin (negative
    # slab t0) cannot sneak past the `t0 < limit` test
    t_max = jnp.where(t_max <= 0.0, -INF, t_max)
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)
    tc = triangle_constants(tri)

    def cond(state):
        node, _, _, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, j, t, idx = state
        active = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)

        amin = bvh.aabb_min[nd]
        amax = bvh.aabb_max[nd]
        count = bvh.tri_count[nd]
        first = bvh.first_tri[nd]
        skip = bvh.skip[nd]

        is_leaf = count > 0
        entering = j == 0
        box_ok = jnp.where(entering,
                           ray_aabb(orig, inv_d, amin, amax, jnp.minimum(t, t_max)),
                           True)

        # one triangle test per step while scanning a leaf
        do_tri = active & is_leaf & box_ok
        ti = jnp.clip(first + j, 0, tri.count - 1)
        hit, t_tri = ray_triangle_pre(
            orig[:, 0], orig[:, 1], orig[:, 2], d[:, 0], d[:, 1], d[:, 2],
            tc["n"][ti, 0], tc["n"][ti, 1], tc["n"][ti, 2], tc["np0"][ti],
            tc["t1"][ti, 0], tc["t1"][ti, 1], tc["t1"][ti, 2], tc["t1w"][ti],
            tc["t2"][ti, 0], tc["t2"][ti, 1], tc["t2"][ti, 2], tc["t2w"][ti])
        upd = do_tri & hit & (t_tri < t) & (t_tri < t_max)
        t = jnp.where(upd, t_tri, t)
        idx = jnp.where(upd, ti, idx)

        j_next = j + 1
        leaf_done = is_leaf & (j_next >= count)
        advance = (~box_ok) | leaf_done | ~is_leaf
        node_next = jnp.where(~box_ok | leaf_done, skip,
                              jnp.where(is_leaf, node, node + 1))
        j_next = jnp.where(advance, 0, j_next)
        if any_hit:
            node_next = jnp.where(idx >= 0, n_nodes, node_next)
        node_next = jnp.where(active, node_next, node)
        j_next = jnp.where(active, j_next, j)
        return node_next, j_next, t, idx

    init = (
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32),
        jnp.full((n,), INF, jnp.float32),
        jnp.full((n,), -1, jnp.int32),
    )
    _, _, t, idx = jax.lax.while_loop(cond, body, init)
    return t, idx


def trace_bruteforce(tri: TriangleSoA, orig: Array, d: Array) -> tuple[Array, Array]:
    """O(N_rays * T) oracle used by tests: nearest hit over all triangles."""
    tc = triangle_constants(tri)

    def per_tri(carry, i):
        t_best, idx = carry
        hit, t = ray_triangle_pre(
            orig[:, 0], orig[:, 1], orig[:, 2], d[:, 0], d[:, 1], d[:, 2],
            tc["n"][i, 0], tc["n"][i, 1], tc["n"][i, 2], tc["np0"][i],
            tc["t1"][i, 0], tc["t1"][i, 1], tc["t1"][i, 2], tc["t1w"][i],
            tc["t2"][i, 0], tc["t2"][i, 1], tc["t2"][i, 2], tc["t2w"][i])
        upd = hit & (t < t_best)
        return (jnp.where(upd, t, t_best), jnp.where(upd, i, idx)), None

    n = orig.shape[0]
    init = (jnp.full((n,), INF, jnp.float32), jnp.full((n,), -1, jnp.int32))
    (t, idx), _ = jax.lax.scan(per_tri, init, jnp.arange(tri.count))
    return t, idx


def barycentrics(p: Array, p0: Array, p1: Array, p2: Array,
                 reference_quirks: bool = False) -> tuple[Array, Array, Array]:
    """Barycentric coordinates of point p in the triangle.

    Default: robust 3D derivation (project onto the triangle's own plane).
    Quirk mode replicates the reference's XY-plane projection
    (path_tracing.frag:261-263) which degenerates for XY-perpendicular
    triangles.
    """
    if reference_quirks:
        denom_a = (-(p0[..., 0] - p1[..., 0]) * (p2[..., 1] - p1[..., 1])
                   + (p0[..., 1] - p1[..., 1]) * (p2[..., 0] - p1[..., 0]) + 1e-7)
        alpha = (-(p[..., 0] - p1[..., 0]) * (p2[..., 1] - p1[..., 1])
                 + (p[..., 1] - p1[..., 1]) * (p2[..., 0] - p1[..., 0])) / denom_a
        denom_b = (-(p1[..., 0] - p2[..., 0]) * (p0[..., 1] - p2[..., 1])
                   + (p1[..., 1] - p2[..., 1]) * (p0[..., 0] - p2[..., 0]) + 1e-7)
        beta = (-(p[..., 0] - p2[..., 0]) * (p0[..., 1] - p2[..., 1])
                + (p[..., 1] - p2[..., 1]) * (p0[..., 0] - p2[..., 0])) / denom_b
        return alpha, beta, 1.0 - alpha - beta
    e0 = p1 - p0
    e1 = p2 - p0
    ep = p - p0
    d00 = jnp.sum(e0 * e0, axis=-1)
    d01 = jnp.sum(e0 * e1, axis=-1)
    d11 = jnp.sum(e1 * e1, axis=-1)
    d20 = jnp.sum(ep * e0, axis=-1)
    d21 = jnp.sum(ep * e1, axis=-1)
    denom = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
    beta = (d11 * d20 - d01 * d21) / denom   # weight of p1
    gamma = (d00 * d21 - d01 * d20) / denom  # weight of p2
    return 1.0 - beta - gamma, beta, gamma
