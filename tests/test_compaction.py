"""Bounce-boundary ray compaction (integrator/path_tracer.py).

The compacted shading loop evaluates the SAME per-pixel math as the
uncompacted loop: every sample stream is keyed on (pixel, frame), never on
lane position, so packing the surviving lanes densely cannot change any
pixel's estimate. Equality is asserted to tight tolerance (not bitwise:
XLA fuses the two programs differently, which reassociates float ops). Also covers the overflow residual pass (budget smaller
than the survivor count) and gradient equality through the compacted path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuray.integrator.path_tracer import _compact_budget, trace_paths
from tpuray.render.renderer import render_frame
from tpuray.render.frame_state import FrameState
from tpuray.scene.camera import OrbitCamera
from tpuray.scene.config import RenderConfig
from tpuray.scene.procedural import make_test_scene


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=2, env_width=32)


def _rays(n_side, cam):
    h = w = n_side
    yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
    xx = xx.reshape(-1)
    yy = yy.reshape(-1)
    xs = (2.0 * (xx + 0.5) / w - 1.0) * cam.tan_half_fov
    ys = -(2.0 * (yy + 0.5) / h - 1.0) * cam.tan_half_fov
    d = jnp.stack([xs, ys, -jnp.ones_like(xs)], axis=-1)
    d = jnp.einsum("ij,nj->ni", cam.cam_to_world, d)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.eye, (h * w, 3))
    return o, d, xx.astype(jnp.uint32), yy.astype(jnp.uint32)


def _run(scene, frac, size=48, depth=2):
    cfg = RenderConfig(width=size, height=size, max_tracing_depth=depth,
                       compact_frac=frac)
    cam = OrbitCamera(width=size, height=size).snapshot()
    o, d, px, py = _rays(size, cam)
    return jax.jit(
        lambda: trace_paths(scene, o, d, px, py, jnp.uint32(3), cfg))()


def test_budget_rounding():
    cfg = RenderConfig(compact_frac=0.5)
    assert _compact_budget(4096, cfg) == 2048
    assert _compact_budget(640000, cfg) % 512 == 0
    assert _compact_budget(4096, RenderConfig(compact_frac=0.0)) == 0
    # budget >= n degenerates to the plain loop
    assert _compact_budget(300, cfg) == 0


def test_compacted_bit_identical(scene):
    ref = _run(scene, 0.0)
    com = _run(scene, 0.5)
    np.testing.assert_allclose(np.asarray(ref.color), np.asarray(com.color), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref.emission),
                               np.asarray(com.emission), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref.albedo),
                               np.asarray(com.albedo), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ref.first_hit_valid),
                                  np.asarray(com.first_hit_valid))
    np.testing.assert_array_equal(np.asarray(ref.first_hit_t),
                                  np.asarray(com.first_hit_t))
    v = np.asarray(ref.first_hit_valid)
    np.testing.assert_allclose(np.asarray(ref.first_hit_point)[v],
                               np.asarray(com.first_hit_point)[v],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ref.first_hit_normal)[v],
                               np.asarray(com.first_hit_normal)[v],
                               rtol=2e-4, atol=2e-5)


def test_overflow_residual_pass(scene):
    """Budget far below the survivor count: the residual pass must make the
    result exact anyway."""
    ref = _run(scene, 0.0)
    com = _run(scene, 0.24)  # 48*48*0.24 -> 512-lane budget, overflows
    np.testing.assert_allclose(np.asarray(ref.color), np.asarray(com.color), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(ref.first_hit_valid),
                                  np.asarray(com.first_hit_valid))


def test_full_frame_matches(scene):
    """render_frame end-to-end with compaction on/off: identical PT color
    and final image."""
    size = 48
    cam = OrbitCamera(width=size, height=size).snapshot()
    outs = []
    for frac in (0.0, 0.5):
        cfg = RenderConfig(width=size, height=size, compact_frac=frac)
        st = FrameState.initial(size, size)
        for _ in range(2):
            st, out = render_frame(scene, cam, st, cfg, size, size)
        outs.append(out)
    np.testing.assert_allclose(np.asarray(outs[0].pt_color),
                               np.asarray(outs[1].pt_color),
                               rtol=2e-3, atol=3e-3)
    # the SVGF chain's edge-stopping weights can amplify fusion-level
    # float noise at isolated pixels (a 1e-6 input change near a weight
    # threshold): allow small absolute slack on the final image
    np.testing.assert_allclose(np.asarray(outs[0].final),
                               np.asarray(outs[1].final),
                               rtol=2e-3, atol=3e-3)


def test_gradients_match(scene):
    """d(mean color)/d(base-color scale) must agree compacted vs not."""
    size = 32
    cam = OrbitCamera(width=size, height=size).snapshot()

    def loss(s, frac):
        cfg = RenderConfig(width=size, height=size, max_tracing_depth=1,
                           compact_frac=frac, enable_svgf=False)
        mats = scene.materials.replace(
            base_color=jnp.abs(scene.materials.base_color) * s)
        sc = scene.replace(materials=mats)
        st = FrameState.initial(size, size)
        _, out = render_frame(sc, cam, st, cfg, size, size)
        return jnp.mean(out.pt_color)

    g0 = jax.grad(lambda s: loss(s, 0.0))(jnp.float32(0.7))
    g1 = jax.grad(lambda s: loss(s, 0.5))(jnp.float32(0.7))
    assert np.isfinite(float(g0)) and abs(float(g0)) > 0
    np.testing.assert_allclose(float(g0), float(g1), rtol=1e-3)
