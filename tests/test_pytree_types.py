"""Scene, BVH and FrameState are registered dataclasses: pytree round trips,
`.replace`, jit, and one-tree BVHs for scenes of any size."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuray.integrator.intersect import trace, trace_bruteforce
from tpuray.render.frame_state import FrameState
from tpuray.scene.builder import ObjectSpec, build_scene
from tpuray.scene.procedural import icosphere, make_test_scene
from tpuray.scene.types import BVHSoA, Scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=1, env_width=16)


def test_frame_state_round_trip_and_replace():
    s = FrameState.initial(4, 5)
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == len(dataclasses.fields(FrameState))
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, FrameState) and back.history_len.shape == (4, 5)
    s2 = s.replace(frame_idx=jnp.int32(3))
    assert int(s2.frame_idx) == 3 and int(s.frame_idx) == 0
    assert int(s2.reset_accumulation().frame_idx) == 0


def test_scene_round_trip_and_replace(scene):
    leaves, treedef = jax.tree_util.tree_flatten(scene)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, Scene) and back.textures is None
    np.testing.assert_array_equal(back.bvh.skip, scene.bvh.skip)
    lights = scene.lights.replace(radiance=scene.lights.radiance * 2)
    s2 = scene.replace(lights=lights)
    np.testing.assert_allclose(s2.lights.radiance, scene.lights.radiance * 2)
    assert s2.bvh is scene.bvh


def test_dataclasses_are_frozen(scene):
    with pytest.raises(dataclasses.FrozenInstanceError):
        scene.bvh.skip = None


def test_pytrees_pass_through_jit(scene):
    @jax.jit
    def f(s, st):
        return st.replace(frame_idx=st.frame_idx + s.bvh.count)
    out = f(scene, FrameState.initial(2, 2))
    assert int(out.frame_idx) == scene.bvh.count
    assert len(jax.tree_util.tree_leaves(scene.bvh)) == len(
        dataclasses.fields(BVHSoA))


def test_big_scene_builds_one_tree(tmp_path):
    """A scene far above the old fast-memory ceiling (~15-20k triangles) is
    one preorder tree: skip links end at the node count, every triangle in
    exactly one leaf, and traversal equals brute force."""
    tris = np.concatenate([icosphere(3, 0.3, (x, 0.0, z))
                           for x in (-0.8, 0.0, 0.8) for z in (-0.8, 0.0, 0.8)])
    path = tmp_path / "spheres.obj"
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in tris.reshape(-1, 3)]
    lines += [f"f {i} {i + 1} {i + 2}" for i in range(1, 3 * len(tris), 3)]
    path.write_text("\n".join(lines) + "\n")
    s = build_scene([ObjectSpec(path=str(path))], envmap=np.ones((4, 8, 3)))
    assert s.triangles.count == len(tris) >= 11_000
    skip = np.asarray(s.bvh.skip)
    assert skip[0] == s.bvh.count and (skip <= s.bvh.count).all()
    cnt = np.asarray(s.bvh.tri_count)
    first = np.asarray(s.bvh.first_tri)
    covered = np.zeros(s.triangles.count, int)
    for f, c in zip(first[cnt > 0], cnt[cnt > 0]):
        covered[f:f + c] += 1
    assert (covered == 1).all()
    lo = np.asarray(s.bvh.aabb_min[0])
    hi = np.asarray(s.bvh.aabb_max[0])
    r = np.random.default_rng(0)
    # from above the model toward random points of its footprint
    tgt = lo + r.random((256, 3)) * (hi - lo)
    o = np.tile((lo + hi) / 2 + [0.0, 2.0 * (hi - lo)[1] + 1.0, 0.0], (256, 1))
    d = tgt - o
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True), jnp.float32)
    got = trace(s.bvh, s.triangles, o, d)
    want = trace_bruteforce(s.triangles, o, d)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert (np.asarray(want[1]) >= 0).mean() > 0.3
