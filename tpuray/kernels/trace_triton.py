"""BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

One ray per lane. A block of rays walks the threaded skip-link BVH
(BVHSoA.skip) with the single-pointer state machine of the XLA wavefront
(integrator/intersect.trace): entering a node slab-tests its box against
the current best t; an inner hit descends to node + 1, a leaf hit scans its
triangles one per step, anything else follows the skip link. The walk is one
`while` inside the kernel, so a trace is one launch instead of a launch group
per step of the wavefront. The visit order equals the wavefront's, and the
triangle test keeps the op order of intersect.ray_triangle_pre, so the two
agree except where FMA contraction or the GPU's division rounding flips a
grazing test.

The scene is packed per trace (a few cheap XLA ops, shared under jit) into
row records that stay resident in L2: one 32-byte int32 record per node
(the box's float bits, first/count, skip link; integer storage keeps the
small integers, which are denormals as float bits, safe from any
flush-to-zero) and one 64-byte f32 record per triangle (the 12 precomputed
constants of intersect.triangle_constants).

Traversal is topology only: (t, triangle index) out. Shading re-derives
everything differentiable from them (integrator/path_tracer.resolve_hit), so
the kernel declares zero tangents and `jax.grad` through a frame works.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tpuray.accel.bvh import MAX_LEAF_SIZE
from tpuray.integrator.intersect import (
    INF, PARALLEL_EPS, T_MIN, triangle_constants)
from tpuray.scene.types import BVHSoA, TriangleSoA

Array = jax.Array

# rays per program, one per thread: one warp, so the loop's any-lane-alive
# reduction stays a warp shuffle (fastest of 32/64/128/256 on the H100 for
# primary and incoherent rays, PERF.md)
BLOCK = 32
TRI_W = 16        # f32 words per triangle record (12 used)
MAX_LEAF = MAX_LEAF_SIZE                 # enforced by accel.bvh.build_bvh
COUNT_BITS = MAX_LEAF.bit_length()       # leaf count packed below first_tri
KERNEL_NAME = "bvh_trace"


def pack_scene(bvh: BVHSoA, tri: TriangleSoA) -> tuple[Array, Array]:
    """(nodes (N, 8) int32, tris (T, 16) f32) row records.

    Node record: bitcast(amin xyz), bitcast(amax xyz),
    first_tri << 5 | tri_count, skip. Triangle record: n xyz, n.p0,
    T1 xyz, t1w, T2 xyz, t2w, four zero words of padding."""
    # a check for trees built outside accel.bvh; under jit the counts are
    # tracers and only the build-time check applies
    if not isinstance(bvh.tri_count, jax.core.Tracer):
        assert int(np.max(np.asarray(bvh.tri_count))) <= MAX_LEAF, (
            f"leaf holds more than {MAX_LEAF} triangles")
    count = bvh.tri_count.astype(jnp.int32)
    first_count = jnp.left_shift(bvh.first_tri.astype(jnp.int32),
                                 COUNT_BITS) | count
    as_i32 = partial(jax.lax.bitcast_convert_type, new_dtype=jnp.int32)
    nodes = jnp.concatenate([
        as_i32(bvh.aabb_min.astype(jnp.float32)),
        as_i32(bvh.aabb_max.astype(jnp.float32)),
        first_count[:, None], bvh.skip.astype(jnp.int32)[:, None]], axis=1)
    tc = triangle_constants(tri)
    tris = jnp.concatenate([
        tc["n"], tc["np0"][:, None], tc["t1"], tc["t1w"][:, None],
        tc["t2"], tc["t2w"][:, None],
        jnp.zeros((tri.count, TRI_W - 12), jnp.float32)], axis=1)
    return nodes, tris


def _kernel(nodes_ref, tris_ref, rays_ref, t_ref, idx_ref, *,
            n_nodes: int, n_tris: int, any_hit: bool):
    ox, oy, oz = rays_ref[0], rays_ref[1], rays_ref[2]
    dx, dy, dz = rays_ref[3], rays_ref[4], rays_ref[5]
    t_max = rays_ref[6]
    # dead-lane convention of intersect.trace: t_max <= 0 masks the lane off
    t_max = jnp.where(t_max <= 0.0, -INF, t_max)

    def safe_inv(v):
        tiny = jnp.where(v < 0, np.float32(-1e-20), np.float32(1e-20))
        return 1.0 / jnp.where(jnp.abs(v) < 1e-20, tiny, v)

    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)

    def box(nd, c):
        return jax.lax.bitcast_convert_type(nodes_ref[nd, c], jnp.float32)

    # the node pointer only moves forward (node + 1 or a skip link) and each
    # leaf triangle is tested once, so no walk takes more steps than this;
    # the bound keeps corrupt tables from hanging the card
    max_steps = n_nodes + n_tris

    def cond(carry):
        node, step = carry[0], carry[4]
        return (jnp.max((node < n_nodes).astype(jnp.int32)) > 0) & (
            step < max_steps)

    def body(carry):
        node, j, t, idx, step = carry
        active = node < n_nodes
        nd = jnp.minimum(node, n_nodes - 1)

        fc = nodes_ref[nd, 6]
        skip = nodes_ref[nd, 7]
        count = fc & MAX_LEAF
        first = jnp.right_shift(fc, COUNT_BITS)
        is_leaf = count > 0
        entering = j == 0

        # slab test, as intersect.ray_aabb
        limit = jnp.minimum(t, t_max)
        fx = (box(nd, 3) - ox) * ix
        nx = (box(nd, 0) - ox) * ix
        fy = (box(nd, 4) - oy) * iy
        ny = (box(nd, 1) - oy) * iy
        fz = (box(nd, 5) - oz) * iz
        nz = (box(nd, 2) - oz) * iz
        t1 = jnp.minimum(jnp.minimum(jnp.maximum(fx, nx), jnp.maximum(fy, ny)),
                         jnp.maximum(fz, nz))
        t0 = jnp.maximum(jnp.maximum(jnp.minimum(fx, nx), jnp.minimum(fy, ny)),
                         jnp.minimum(fz, nz))
        box_hit = (t1 >= jnp.maximum(t0, 0.0)) & (t0 < limit) & (t1 > 0.0)
        box_ok = jnp.where(entering, box_hit, True)

        # one triangle test per step while scanning a leaf, in the op order
        # of intersect.ray_triangle_pre
        do_tri = active & is_leaf & box_ok
        ti = jnp.clip(first + j, 0, n_tris - 1)
        tnx, tny, tnz = tris_ref[ti, 0], tris_ref[ti, 1], tris_ref[ti, 2]
        np0 = tris_ref[ti, 3]
        ndotd = tnx * dx + tny * dy + tnz * dz
        ndoto = tnx * ox + tny * oy + tnz * oz
        invalid = jnp.abs(ndotd) < PARALLEL_EPS
        denom = jnp.where(invalid, np.float32(1.0), ndotd)
        tt = (np0 - ndoto) / denom
        px = ox + dx * tt
        py = oy + dy * tt
        pz = oz + dz * tt
        u = (tris_ref[ti, 4] * px + tris_ref[ti, 5] * py
             + tris_ref[ti, 6] * pz + tris_ref[ti, 7])
        v = (tris_ref[ti, 8] * px + tris_ref[ti, 9] * py
             + tris_ref[ti, 10] * pz + tris_ref[ti, 11])
        in_tri = (u > 0) & (v > 0) & (u + v < 1)
        hit = jnp.logical_not(invalid) & (tt >= T_MIN) & in_tri
        upd = do_tri & hit & (tt < t) & (tt < t_max)
        t = jnp.where(upd, tt, t)
        idx = jnp.where(upd, ti, idx)

        j_next = j + 1
        leaf_done = is_leaf & (j_next >= count)
        advance = jnp.logical_not(box_ok) | leaf_done | jnp.logical_not(is_leaf)
        node_next = jnp.where(jnp.logical_not(box_ok) | leaf_done, skip,
                              jnp.where(is_leaf, node, node + 1))
        j_next = jnp.where(advance, 0, j_next)
        if any_hit:
            node_next = jnp.where(idx >= 0, n_nodes, node_next)
        node_next = jnp.where(active, node_next, node)
        j_next = jnp.where(active, j_next, j)
        return node_next, j_next, t, idx, step + 1

    shape = ox.shape
    init = (jnp.zeros(shape, jnp.int32), jnp.zeros(shape, jnp.int32),
            jnp.full(shape, INF, jnp.float32), jnp.full(shape, -1, jnp.int32),
            jnp.int32(0))
    _, _, t, idx, _ = jax.lax.while_loop(cond, body, init)
    t_ref[...] = t
    idx_ref[...] = idx


@partial(jax.jit, static_argnames=("any_hit", "block", "interpret"))
def _trace_impl(nodes: Array, tris: Array, orig: Array, d: Array,
                t_max: Array, any_hit: bool, block: int,
                interpret: bool) -> tuple[Array, Array]:
    n = orig.shape[0]
    n_pad = pl.cdiv(n, block) * block
    # (8, N) ray rows: origin, direction, t_max, padding. Padded lanes get
    # t_max = 0, i.e. dead.
    rays = jnp.concatenate([orig.T, d.T, t_max[None],
                            jnp.zeros((1, n), jnp.float32)], axis=0)
    rays = jnp.pad(rays.astype(jnp.float32), ((0, 0), (0, n_pad - n)))
    kernel = partial(_kernel, n_nodes=nodes.shape[0], n_tris=tris.shape[0],
                     any_hit=any_hit)
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    t, idx = pl.pallas_call(
        kernel,
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec(nodes.shape, lambda i: (0, 0)),
                  pl.BlockSpec(tris.shape, lambda i: (0, 0)),
                  pl.BlockSpec((8, block), lambda i: (0, i))],
        out_specs=[lane_spec, lane_spec],
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name=KERNEL_NAME,
    )(nodes, tris, rays)
    return t[:n], idx[:n]


@partial(jax.custom_jvp, nondiff_argnums=(5, 6, 7))
def _trace_cj(nodes, tris, orig, d, t_max, any_hit, block, interpret):
    return _trace_impl(nodes, tris, orig, d, t_max, any_hit, block,
                       interpret)


@_trace_cj.defjvp
def _trace_jvp(any_hit, block, interpret, primals, tangents):
    """Zero tangents: the output is topology (module docstring). A
    pallas_call has no JVP rule of its own, so without this an outer
    jax.grad through a rendered frame would fail."""
    del tangents
    t, idx = _trace_cj(*primals, any_hit, block, interpret)
    return (t, idx), (jnp.zeros_like(t),
                      np.zeros(idx.shape, jax.dtypes.float0))


def trace_triton(bvh: BVHSoA, tri: TriangleSoA, orig: Array, d: Array,
                 t_max: Array | float = INF, any_hit: bool = False,
                 block: int = BLOCK, interpret: bool = False
                 ) -> tuple[Array, Array]:
    """Drop-in for integrator.intersect.trace on a GPU.

    orig, d: (N, 3); t_max: scalar or (N,), <= 0 marks a dead lane.
    Returns (t (N,), tri_idx (N,) int32), idx = -1 and t = INF on a miss.
    interpret=True runs the kernel in the Pallas interpreter (tests)."""
    nodes, tris = pack_scene(bvh, tri)
    n = orig.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    return _trace_cj(nodes, tris, orig.astype(jnp.float32),
                     d.astype(jnp.float32), t_max, bool(any_hit), int(block),
                     bool(interpret))
