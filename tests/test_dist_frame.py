"""Fully sharded frame (dist/frame.py): PT + SVGF + TAA over a mesh with
halo exchanges must match the single-device frame."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuray.dist.frame import render_frame_sharded, shard_state
from tpuray.dist.sharding import make_mesh
from tpuray.render.frame_state import FrameState
from tpuray.render.renderer import render_frame
from tpuray.scene.camera import OrbitCamera
from tpuray.scene.config import RenderConfig
from tpuray.scene.procedural import make_test_scene

H = W = 64
N_DEV = 8


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=1, env_width=32)


@pytest.fixture(scope="module")
def cfg():
    # shard rows are 8, so the largest a-trous halo (2*2+1) must fit
    return RenderConfig(width=W, height=H, max_tracing_depth=1,
                        num_atrous_iterations=2)


def assert_images_close(a, b, tol=5e-4, outlier_frac=0.005,
                        outlier_max=0.1, msg=""):
    """Sharded-vs-single and mesh-vs-mesh comparisons are exact when every
    path compiles with the same fusion shapes (verified: compact_frac=0
    matches bit-exactly across mesh sizes). With per-shard compaction the
    fusion shapes differ per mesh, and 1-ulp shifts in shadow-ray origins
    can flip a grazing visibility test on isolated pixels (then SVGF
    spreads it locally). Assert: almost all pixels tight, rare bounded
    outliers allowed."""
    d = np.abs(np.asarray(a) - np.asarray(b)).max(-1)
    frac = float((d > tol).mean())
    assert frac <= outlier_frac, f"{msg}: {frac:.4%} pixels differ > {tol}"
    assert d.max() < outlier_max, f"{msg}: max diff {d.max():.4f}"


def _run_single(scene, cfg, frames):
    cam = OrbitCamera(width=W, height=H)
    state = FrameState.initial(H, W)
    outs = []
    for i, rot in enumerate(frames):
        cam.rotate(rot, 0.0)
        state, out = render_frame(scene, cam.snapshot(), state, cfg, H, W,
                                  static_camera=False)
        outs.append(np.asarray(out.final))
    return outs, state


def _run_sharded(scene, cfg, frames, n_dev=N_DEV, halo=4):
    mesh = make_mesh(n_dev)
    cam = OrbitCamera(width=W, height=H)
    state = shard_state(FrameState.initial(H, W), mesh)
    outs = []
    for rot in frames:
        cam.rotate(rot, 0.0)
        state, final, pt = render_frame_sharded(
            scene, cam.snapshot(), state, cfg, H, W, mesh, halo=halo,
            static_camera=False)
        outs.append(np.asarray(final))
    return outs, state


def test_sharded_frame_matches_single(scene, cfg):
    """Two moving-camera frames: history flows through the sharded state and
    every stencil's halo; final frames must match the single-device path."""
    frames = [0.0, 1.5]
    single, s_state = _run_single(scene, cfg, frames)
    sharded, d_state = _run_sharded(scene, cfg, frames)
    for i, (a, b) in enumerate(zip(single, sharded)):
        assert np.isfinite(b).all()
        assert_images_close(b, a, msg=f"frame {i}")
    np.testing.assert_allclose(np.asarray(d_state.history_len),
                               np.asarray(s_state.history_len),
                               rtol=1e-5, atol=1e-5)


def test_sharded_frame_mesh_size_invariant(scene, cfg):
    """2-device and 8-device meshes render the identical image."""
    frames = [0.0, 1.0]
    two, _ = _run_sharded(scene, cfg, frames, n_dev=2, halo=6)
    eight, _ = _run_sharded(scene, cfg, frames, n_dev=8, halo=6)
    for a, b in zip(two, eight):
        assert_images_close(a, b, msg="mesh 2 vs 8")


def test_sharded_layout(scene, cfg):
    """The sharded state leaves really live row-sharded on the mesh."""
    mesh = make_mesh(N_DEV)
    state = shard_state(FrameState.initial(H, W), mesh)
    sh = state.illum_hist.sharding
    assert sh.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("tiles")),
        state.illum_hist.ndim)
