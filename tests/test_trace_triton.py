"""The GPU BVH traversal kernel (kernels/trace_triton.py) in interpret mode
against the XLA wavefront (intersect.trace) and brute force."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuray.accel.bvh import MAX_LEAF_SIZE
from tpuray.integrator.intersect import trace as trace_xla, trace_bruteforce
from tpuray.kernels.trace_triton import (
    COUNT_BITS, MAX_LEAF, pack_scene, trace_triton)
from tpuray.scene.procedural import make_large_scene, make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=2, env_width=32)


@pytest.fixture(scope="module")
def big_scene():
    """Above the old fast-memory ceiling: 20 spheres at subdiv 3 + ground
    (25.6k triangles), one tree."""
    return make_large_scene(n_spheres=20, subdiv=3, env_width=16)


def kernel(scene, o, d, **kw):
    return trace_triton(scene.bvh, scene.triangles, o, d, interpret=True, **kw)


def make_rays(seed, n):
    r = np.random.default_rng(seed)
    o = np.tile(np.asarray([[0.0, 0.3, 2.0]], np.float32), (n, 1))
    o += (r.random((n, 3)).astype(np.float32) - 0.5) * 0.4
    d = (r.random((n, 3)).astype(np.float32) - 0.5) * 1.5 - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def assert_same_hits(got, want, t_rtol=1e-5):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    m = np.asarray(want[1]) >= 0
    np.testing.assert_allclose(np.asarray(got[0])[m], np.asarray(want[0])[m],
                               rtol=t_rtol)


@pytest.mark.parametrize("block", [32, 64, 128])
def test_nearest_matches_wavefront(scene, block):
    o, d = make_rays(1, 1024)
    want = trace_xla(scene.bvh, scene.triangles, o, d)
    assert_same_hits(kernel(scene, o, d, block=block), want)
    assert (np.asarray(want[1]) >= 0).mean() > 0.3


@pytest.mark.parametrize("block", [32, 128])
def test_nearest_matches_bruteforce(scene, block):
    o, d = make_rays(2, 512)
    assert_same_hits(kernel(scene, o, d, block=block),
                     trace_bruteforce(scene.triangles, o, d))


@pytest.mark.parametrize("block", [32, 128])
def test_any_hit_matches_wavefront(scene, block):
    o, d = make_rays(3, 1024)
    tmax = jnp.full((1024,), 1.5, jnp.float32)
    _, got = kernel(scene, o, d, t_max=tmax, any_hit=True, block=block)
    _, want = trace_xla(scene.bvh, scene.triangles, o, d, t_max=tmax,
                        any_hit=True)
    np.testing.assert_array_equal(np.asarray(got) >= 0, np.asarray(want) >= 0)


@pytest.mark.parametrize("n", [1, 33, 777])
def test_ray_count_not_multiple_of_block(scene, n):
    o, d = make_rays(4, n)
    got = kernel(scene, o, d, block=64)
    assert got[0].shape == (n,) and got[1].shape == (n,)
    assert_same_hits(got, trace_xla(scene.bvh, scene.triangles, o, d))


def test_dead_lanes_inert(scene):
    """t_max <= 0 marks a lane dead: (INF, -1) out, nearest and any-hit, and
    live lanes match an unmasked trace."""
    n = 1024
    o, d = make_rays(5, n)
    dead = np.arange(n) % 3 == 0
    tm = jnp.where(jnp.asarray(dead), 0.0, 1e30).astype(jnp.float32)
    t, i = kernel(scene, o, d, t_max=tm)
    assert (np.asarray(i)[dead] == -1).all()
    assert (np.asarray(t)[dead] >= 1e29).all()
    _, i_full = trace_xla(scene.bvh, scene.triangles, o, d)
    np.testing.assert_array_equal(np.asarray(i)[~dead],
                                  np.asarray(i_full)[~dead])
    _, ia = kernel(scene, o, d, t_max=tm, any_hit=True)
    assert (np.asarray(ia)[dead] == -1).all()


def test_origins_inside_boxes(scene):
    """Origins inside node boxes (negative slab t0), live and dead."""
    n = 512
    o, d = make_rays(6, n)
    o = o.at[: n // 2].set(jnp.asarray([0.0, 0.0, 0.0]))  # sphere centre
    tm = jnp.where(jnp.arange(n) % 2 == 0, 0.0, 1e30).astype(jnp.float32)
    for t_max in (1e30, tm):
        assert_same_hits(kernel(scene, o, d, t_max=t_max),
                         trace_xla(scene.bvh, scene.triangles, o, d,
                                   t_max=t_max))


def test_zero_tangent_gradient(scene):
    """jax.grad through a function holding the kernel: the traversal
    declares zero tangents, gradients route around it."""
    o, d = make_rays(7, 256)

    def f(o_var):
        _, idx = kernel(scene, o_var, d)
        w = jnp.where(idx >= 0, 1.0, 0.0)
        return jnp.sum(w * o_var[:, 0]), idx

    (_, idx), g = jax.value_and_grad(f, has_aux=True)(o)
    np.testing.assert_allclose(np.asarray(g)[:, 0],
                               (np.asarray(idx) >= 0).astype(np.float32))
    np.testing.assert_allclose(np.asarray(g)[:, 1:], 0.0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_large_single_tree_scene(big_scene, any_hit):
    assert big_scene.triangles.count >= 20_000
    o, d = make_rays(8, 256)
    o = o * 2.0  # from outside the sphere field
    d = jnp.asarray(-np.asarray(o) / np.linalg.norm(o, axis=-1, keepdims=True)
                    + 0.2 * np.asarray(d))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    if any_hit:
        tmax = jnp.full((256,), 3.0, jnp.float32)
        _, got = kernel(big_scene, o, d, t_max=tmax, any_hit=True)
        _, want = trace_xla(big_scene.bvh, big_scene.triangles, o, d,
                            t_max=tmax, any_hit=True)
        np.testing.assert_array_equal(np.asarray(got) >= 0,
                                      np.asarray(want) >= 0)
    else:
        want = trace_bruteforce(big_scene.triangles, o, d)
        assert (np.asarray(want[1]) >= 0).mean() > 0.2
        assert_same_hits(kernel(big_scene, o, d), want)


def test_pack_scene_records(scene):
    nodes, tris = pack_scene(scene.bvh, scene.triangles)
    assert nodes.shape == (scene.bvh.count, 8)
    assert tris.shape == (scene.triangles.count, 16)
    assert nodes.dtype == jnp.int32
    fc = np.asarray(nodes[:, 6])
    skip = np.asarray(nodes[:, 7])
    np.testing.assert_array_equal(fc & MAX_LEAF, scene.bvh.tri_count)
    leaf = np.asarray(scene.bvh.tri_count) > 0
    np.testing.assert_array_equal((fc >> COUNT_BITS)[leaf],
                                  np.asarray(scene.bvh.first_tri)[leaf])
    np.testing.assert_array_equal(skip, scene.bvh.skip)
    np.testing.assert_array_equal(
        jax.lax.bitcast_convert_type(nodes[:, 0:3], jnp.float32),
        scene.bvh.aabb_min)


def test_pack_scene_rejects_oversized_leaf(scene):
    bvh = scene.bvh.replace(
        tri_count=scene.bvh.tri_count.at[-1].set(MAX_LEAF + 1))
    with pytest.raises(AssertionError, match="leaf"):
        pack_scene(bvh, scene.triangles)


def test_largest_leaves_under_jit():
    """A tree built with the largest leaf the node record holds, traced with
    the scene as a jit argument (tri_count a tracer, as in render_frame),
    equals brute force."""
    sc = make_test_scene(subdiv=2, env_width=16, leaf_size=MAX_LEAF_SIZE)
    assert int(np.max(np.asarray(sc.bvh.tri_count))) > 16
    o, d = make_rays(9, 512)
    got = jax.jit(lambda s, o, d: trace_triton(
        s.bvh, s.triangles, o, d, interpret=True))(sc, o, d)
    assert_same_hits(got, trace_bruteforce(sc.triangles, o, d))
