"""Elastic render loop (utils/elastic.py): fault injection -> checkpointed
resume -> bit-identical output vs an uninterrupted run."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuray.render.frame_state import FrameState
from tpuray.render.renderer import render_frame
from tpuray.scene.camera import OrbitCamera
from tpuray.scene.config import RenderConfig
from tpuray.scene.procedural import make_test_scene
from tpuray.utils.elastic import ElasticStats, is_device_fault, run_elastic


class FakeDeviceFault(RuntimeError):
    pass


@pytest.fixture(scope="module")
def setup():
    scene = make_test_scene(subdiv=1, env_width=32)
    h = w = 32
    cfg = RenderConfig(width=w, height=h, max_tracing_depth=1,
                       num_atrous_iterations=2)
    cam = OrbitCamera(width=w, height=h).snapshot()

    def frame_fn(state, frame):
        new_state, _ = render_frame(scene, cam, state, cfg, h, w)
        return new_state

    return frame_fn, FrameState.initial(h, w)


def test_fault_classification():
    assert is_device_fault(RuntimeError("UNAVAILABLE: GPU worker process "
                                        "crashed or restarted"))
    assert is_device_fault(RuntimeError("INTERNAL: something"))
    assert not is_device_fault(ValueError("bad argument"))
    assert not is_device_fault(KeyboardInterrupt())


def test_fault_classification_wrapped_runtime_errors():
    """Runtime-layer errors may WRAP the status code (ADVICE r4): match
    tokens anywhere for JaxRuntimeError/XlaRuntimeError, prefix-only for
    generic exceptions."""
    class XlaRuntimeError(RuntimeError):
        pass

    class JaxRuntimeError(RuntimeError):
        pass

    assert is_device_fault(
        XlaRuntimeError("Execution failed: INTERNAL: device connection reset"))
    assert is_device_fault(JaxRuntimeError("Internal: legacy lowercase form"))
    assert is_device_fault(XlaRuntimeError("rpc DEADLINE_EXCEEDED while "
                                           "waiting for transfer"))
    # programming errors from the runtime still re-raise
    assert not is_device_fault(
        XlaRuntimeError("INVALID_ARGUMENT: shape mismatch"))
    # generic exceptions keep the strict prefix rule: a mid-message token
    # must NOT trigger a restart
    assert not is_device_fault(
        RuntimeError("jit requires an internal buffer on device"))


def test_uninterrupted_run(setup, tmp_path):
    frame_fn, st0 = setup
    final, stats = run_elastic(frame_fn, st0, 6, str(tmp_path / "ck.npz"),
                               checkpoint_every=2)
    assert stats.frames_done == 6
    assert stats.faults == 0
    assert int(final.frame_idx) == 6


def test_fault_resume_bit_identical(setup, tmp_path):
    frame_fn, st0 = setup

    # reference: clean run
    ref_final, _ = run_elastic(frame_fn, st0, 7, str(tmp_path / "ref.npz"),
                               checkpoint_every=3)

    # faulty run: device faults injected before frames 4 and 6
    faults_at = {4, 6}
    armed = set(faults_at)

    def flaky(state, frame):
        if frame in armed:
            armed.discard(frame)
            raise FakeDeviceFault("UNAVAILABLE: injected device fault")
        return frame_fn(state, frame)

    restores = []
    final, stats = run_elastic(flaky, st0, 7, str(tmp_path / "ck.npz"),
                               checkpoint_every=3,
                               on_restore=lambda: restores.append(1))
    assert stats.faults == 2
    assert stats.restores == 2
    assert len(restores) == 2
    assert stats.replayed_frames > 0
    assert int(final.frame_idx) == 7
    for f in ("taa_color", "accum_color", "illum_hist", "history_len"):
        np.testing.assert_array_equal(np.asarray(getattr(final, f)),
                                      np.asarray(getattr(ref_final, f)),
                                      err_msg=f)


def test_persistent_fault_reraises(setup, tmp_path):
    frame_fn, st0 = setup

    def always_fails(state, frame):
        raise FakeDeviceFault("UNAVAILABLE: injected")

    with pytest.raises(FakeDeviceFault):
        run_elastic(always_fails, st0, 4, str(tmp_path / "ck.npz"),
                    max_restarts=2)


def test_programming_error_immediate(setup, tmp_path):
    frame_fn, st0 = setup

    def bug(state, frame):
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        run_elastic(bug, st0, 4, str(tmp_path / "ck.npz"))
