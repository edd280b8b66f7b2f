"""The one platform decision (utils/platform.py), the traversal dispatch that
follows it, the compile-cache path, and chip_smoke.py refusing to run
without a GPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import tpuray.integrator.path_tracer as pt
import tpuray.kernels.trace_triton as tt
from tpuray.integrator.intersect import trace as trace_xla
from tpuray.scene.procedural import make_test_scene
from tpuray.utils import platform as plat

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=1, env_width=16)


def rays(n=64):
    o = jnp.tile(jnp.asarray([[0.013, 0.3, 2.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([[0.002, -0.1, -1.0]], jnp.float32), (n, 1))
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def test_platform_is_cpu_here():
    assert plat.platform() == "cpu"


@pytest.mark.parametrize("name", ["gpu", "cuda"])
def test_platform_gpu_names(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert plat.platform() == "gpu"


@pytest.mark.parametrize("name", ["rocm", "metal"])
def test_platform_rejects_other(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        plat.platform()


def test_platform_follows_default_device_context(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert plat.platform() == "cpu"
    assert plat.platform() == "gpu"


def test_dispatch_gpu_calls_kernel(monkeypatch, scene):
    calls = []

    def fake(bvh, tri, orig, d, t_max, any_hit):
        calls.append(any_hit)
        return jnp.zeros(orig.shape[0]), jnp.full(orig.shape[0], -7)

    monkeypatch.setattr(pt, "platform", lambda: "gpu")
    monkeypatch.setattr(tt, "trace_triton", fake)
    o, d = rays()
    _, idx = pt.trace(scene.bvh, scene.triangles, o, d, any_hit=True)
    assert calls == [True] and (np.asarray(idx) == -7).all()


def test_dispatch_cpu_is_wavefront(scene):
    o, d = rays()
    got = pt.trace(scene.bvh, scene.triangles, o, d)
    want = trace_xla(scene.bvh, scene.triangles, o, d)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert (np.asarray(got[1]) >= 0).all()


def test_dispatch_raises_elsewhere(monkeypatch, scene):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    o, d = rays()
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        pt.trace(scene.bvh, scene.triangles, o, d)


def test_compile_cache_dir_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert plat.compile_cache_dir() == str(ROOT / ".jax_cache")


def test_compile_cache_dir_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.compile_cache_dir() == str(tmp_path)


def test_enable_compile_cache_sets_no_path_when_env_set(monkeypatch,
                                                        tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert plat.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _run_smoke(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_refuses_without_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
