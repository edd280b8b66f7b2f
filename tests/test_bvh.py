"""BVH builder: native/numpy parity + structural invariants + traversal
equivalence against brute force."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuray.accel.bvh import MAX_LEAF_SIZE, build_bvh, validate_bvh
from tpuray.io import native
from tpuray.io.fallback import build_bvh_py
from tpuray.integrator.intersect import trace, trace_bruteforce
from tpuray.scene.types import TriangleSoA

HAS_NATIVE = native.get_lib() is not None


def random_tris(rng, t=64, spread=4.0):
    centers = (rng.random((t, 1, 3)) - 0.5) * spread
    verts = centers + (rng.random((t, 3, 3)) - 0.5) * 0.6
    return verts.astype(np.float32)


def make_soa(verts):
    t = verts.shape[0]
    z2 = jnp.zeros((t, 2), jnp.float32)
    return TriangleSoA(
        p0=jnp.asarray(verts[:, 0]), p1=jnp.asarray(verts[:, 1]),
        p2=jnp.asarray(verts[:, 2]),
        n0=jnp.zeros((t, 3)), n1=jnp.zeros((t, 3)), n2=jnp.zeros((t, 3)),
        uv0=z2, uv1=z2, uv2=z2,
        mat_id=jnp.zeros((t,), jnp.int32), obj_id=jnp.zeros((t,), jnp.int32))


def test_invariants(rng):
    verts = random_tris(rng, 200)
    bvh = build_bvh_py(verts, leaf_size=8)
    validate_bvh(bvh, verts, leaf_size=8)


def test_single_leaf(rng):
    verts = random_tris(rng, 5)
    bvh = build_bvh_py(verts, leaf_size=8)
    assert len(bvh["first_tri"]) == 1
    assert bvh["tri_count"][0] == 5
    assert bvh["skip"][0] == 1


@pytest.mark.skipif(not HAS_NATIVE, reason="native lib unavailable")
def test_native_matches_fallback(rng):
    for t in (3, 17, 150, 999):
        verts = random_tris(rng, t)
        a = native.build_bvh_native(verts, 8)
        b = build_bvh_py(verts, 8)
        for k in ("first_tri", "tri_count", "skip", "perm"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} t={t}")
        for k in ("aabb_min", "aabb_max"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=f"{k} t={t}")


def test_traversal_matches_bruteforce(rng):
    verts = random_tris(rng, 300)
    bvh = build_bvh(verts, leaf_size=8)
    soa = make_soa(verts[bvh["perm"]])
    from tpuray.scene.types import BVHSoA
    bsoa = BVHSoA(aabb_min=jnp.asarray(bvh["aabb_min"]),
                  aabb_max=jnp.asarray(bvh["aabb_max"]),
                  first_tri=jnp.asarray(bvh["first_tri"]),
                  tri_count=jnp.asarray(bvh["tri_count"]),
                  skip=jnp.asarray(bvh["skip"]))

    n = 512
    orig = (rng.random((n, 3)).astype(np.float32) - 0.5) * 12.0
    target = (rng.random((n, 3)).astype(np.float32) - 0.5) * 3.0
    d = target - orig
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    t_bvh, i_bvh = trace(bsoa, soa, jnp.asarray(orig), jnp.asarray(d))
    t_ref, i_ref = trace_bruteforce(soa, jnp.asarray(orig), jnp.asarray(d))

    hit_rate = float((np.asarray(i_ref) >= 0).mean())
    assert hit_rate > 0.1, "test scene should produce hits"
    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_ref), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(i_bvh), np.asarray(i_ref))


def test_any_hit_consistent(rng):
    verts = random_tris(rng, 100)
    bvh = build_bvh(verts, leaf_size=4)
    soa = make_soa(verts[bvh["perm"]])
    from tpuray.scene.types import BVHSoA
    bsoa = BVHSoA(aabb_min=jnp.asarray(bvh["aabb_min"]),
                  aabb_max=jnp.asarray(bvh["aabb_max"]),
                  first_tri=jnp.asarray(bvh["first_tri"]),
                  tri_count=jnp.asarray(bvh["tri_count"]),
                  skip=jnp.asarray(bvh["skip"]))
    n = 256
    orig = (rng.random((n, 3)).astype(np.float32) - 0.5) * 10.0
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, i_near = trace(bsoa, soa, jnp.asarray(orig), jnp.asarray(d))
    _, i_any = trace(bsoa, soa, jnp.asarray(orig), jnp.asarray(d), any_hit=True)
    # any-hit finds a hit iff nearest-hit does
    np.testing.assert_array_equal(np.asarray(i_any) >= 0, np.asarray(i_near) >= 0)


def test_tmax_occlusion(rng):
    # a single triangle; rays with t_max before/after it
    verts = np.array([[[-1, -1, 2], [1, -1, 2], [0, 1, 2]]], np.float32)
    bvh = build_bvh(verts, leaf_size=8)
    soa = make_soa(verts[bvh["perm"]])
    from tpuray.scene.types import BVHSoA
    bsoa = BVHSoA(aabb_min=jnp.asarray(bvh["aabb_min"]),
                  aabb_max=jnp.asarray(bvh["aabb_max"]),
                  first_tri=jnp.asarray(bvh["first_tri"]),
                  tri_count=jnp.asarray(bvh["tri_count"]),
                  skip=jnp.asarray(bvh["skip"]))
    orig = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    t, i = trace(bsoa, soa, orig, d, t_max=jnp.asarray([1.0, 3.0]))
    assert int(i[0]) == -1      # hit at t=2 beyond t_max=1
    assert int(i[1]) == 0
    np.testing.assert_allclose(float(t[1]), 2.0, rtol=1e-5)


@pytest.mark.parametrize("leaf_size", [0, MAX_LEAF_SIZE + 1])
def test_leaf_size_outside_kernel_limit_refused(rng, leaf_size):
    """The GPU kernel's node record holds a leaf count of at most
    MAX_LEAF_SIZE; a larger leaf_size must fail at build time, where the
    arrays are concrete, not trace wrong triangles under jit."""
    from tpuray.scene.procedural import make_test_scene
    with pytest.raises(ValueError, match="leaf_size"):
        build_bvh(random_tris(rng), leaf_size=leaf_size)
    with pytest.raises(ValueError, match="leaf_size"):
        make_test_scene(subdiv=1, env_width=16, leaf_size=leaf_size)
