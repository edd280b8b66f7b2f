"""Integrator: miss = envmap, first-hit exports, furnace sanity, gradients."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpuray.integrator.path_tracer import trace_paths
from tpuray.sampling.envmap import env_radiance
from tpuray.scene.builder import make_env_cache
from tpuray.scene.config import RenderConfig
from tpuray.scene.procedural import make_test_scene
from tpuray.scene.types import EnvMap


@pytest.fixture(scope="module")
def scene():
    return make_test_scene(subdiv=2, env_width=64)


def rays_toward_origin(n, rng, dist=2.0):
    o = np.tile(np.asarray([[0.0, 0.3, dist]], np.float32), (n, 1))
    tx = (rng.random((n, 2)).astype(np.float32) - 0.5) * 1.2
    target = np.concatenate([tx[:, :1], tx[:, 1:] * 0.5, np.zeros((n, 1), np.float32)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_miss_rays_see_envmap(scene, rng):
    n = 64
    o = jnp.tile(jnp.asarray([[0.0, 10.0, 0.0]]), (n, 1))
    d_np = rng.standard_normal((n, 3)).astype(np.float32)
    d_np[:, 1] = np.abs(d_np[:, 1]) + 0.5  # upward: guaranteed miss
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    d = jnp.asarray(d_np)
    cfg = RenderConfig(max_tracing_depth=2)
    px = jnp.arange(n, dtype=jnp.int32)
    py = jnp.zeros((n,), jnp.int32)
    out = trace_paths(scene, o, d, px, py, 0, cfg)
    expected = np.asarray(env_radiance(scene.envmap.image, d))
    expected = np.clip(expected, 0, cfg.clamp_threshold)
    np.testing.assert_allclose(np.asarray(out.color), expected, rtol=1e-5)
    assert not np.asarray(out.first_hit_valid).any()
    np.testing.assert_array_equal(np.asarray(out.albedo), 0.0)


def test_first_hit_exports(scene, rng):
    o, d = rays_toward_origin(128, rng)
    cfg = RenderConfig(max_tracing_depth=2)
    px = jnp.arange(128, dtype=jnp.int32)
    py = jnp.zeros((128,), jnp.int32)
    out = trace_paths(scene, o, d, px, py, 0, cfg)
    hits = np.asarray(out.first_hit_valid)
    assert hits.mean() > 0.5
    albedo = np.asarray(out.albedo)
    # sphere albedo (0.8,0.3,0.25) or ground (0.55,0.55,0.6)
    for a in albedo[hits]:
        assert (np.allclose(a, [0.8, 0.3, 0.25], atol=1e-5)
                or np.allclose(a, [0.55, 0.55, 0.6], atol=1e-5))
    np.testing.assert_array_equal(np.asarray(out.emission), 0.0)


def test_radiance_clamped_and_finite(scene, rng):
    o, d = rays_toward_origin(256, rng)
    cfg = RenderConfig(max_tracing_depth=3, clamp_threshold=10.0)
    px = jnp.arange(256, dtype=jnp.int32)
    py = jnp.ones((256,), jnp.int32)
    out = trace_paths(scene, o, d, px, py, 4, cfg)
    c = np.asarray(out.color)
    assert np.isfinite(c).all()
    assert (c >= 0).all() and (c <= 10.0).all()


def test_furnace_not_catastrophic():
    """Constant envmap, diffuse sphere: radiance should be order-1, not 0/inf.

    (The reference's pdf-weighted NEE combination is biased, so this is a
    sanity band rather than an exact white-furnace identity.)"""
    scene = make_test_scene(subdiv=2, with_lights=False, env_width=32)
    const = np.ones((16, 32, 3), np.float32)
    scene = scene.replace(envmap=EnvMap(image=jnp.asarray(const),
                                        cache=jnp.asarray(make_env_cache(const))))
    mats = scene.materials
    scene = scene.replace(materials=mats.replace(
        base_color=jnp.ones_like(mats.base_color),
        metallic=jnp.zeros_like(mats.metallic),
        clearcoat=jnp.zeros_like(mats.clearcoat),
        roughness=jnp.full_like(mats.roughness, 0.8)))
    rng = np.random.default_rng(23)
    o, d = rays_toward_origin(512, rng)
    cfg = RenderConfig(max_tracing_depth=4)
    px = jnp.arange(512, dtype=jnp.int32)
    py = jnp.full((512,), 3, jnp.int32)
    out = trace_paths(scene, o, d, px, py, 0, cfg)
    hits = np.asarray(out.first_hit_valid)
    mean_rad = np.asarray(out.color)[hits].mean()
    assert 0.4 < mean_rad < 2.0, mean_rad


def test_gradients_match_finite_differences(scene, rng):
    """d(mean image)/d(sphere base_color) — autodiff vs central differences.

    This is BASELINE.md's gradient-fidelity target in miniature."""
    o, d = rays_toward_origin(64, rng)
    cfg = RenderConfig(max_tracing_depth=2)
    px = jnp.arange(64, dtype=jnp.int32)
    py = jnp.zeros((64,), jnp.int32)

    def loss(base_color):
        s = scene.replace(materials=scene.materials.replace(base_color=base_color))
        out = trace_paths(s, o, d, px, py, 0, cfg)
        return jnp.mean(out.color)

    bc0 = np.asarray(scene.materials.base_color)
    g = np.asarray(jax.grad(loss)(jnp.asarray(bc0)))
    assert np.isfinite(g).all()

    eps = 5e-3
    for idx in [(0, 0), (0, 2), (1, 1)]:
        bp = bc0.copy(); bp[idx] += eps
        bm = bc0.copy(); bm[idx] -= eps
        fd = (float(loss(jnp.asarray(bp))) - float(loss(jnp.asarray(bm)))) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=0.05, atol=1e-4)


def test_gradients_wrt_light_radiance(scene, rng):
    o, d = rays_toward_origin(64, rng)
    cfg = RenderConfig(max_tracing_depth=2)
    px = jnp.arange(64, dtype=jnp.int32)
    py = jnp.zeros((64,), jnp.int32)

    def loss(radiance):
        s = scene.replace(lights=scene.lights.replace(radiance=radiance))
        out = trace_paths(s, o, d, px, py, 0, cfg)
        return jnp.mean(out.color)

    r0 = np.asarray(scene.lights.radiance)
    g = np.asarray(jax.grad(loss)(jnp.asarray(r0)))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0
    eps = 0.05
    rp = r0.copy(); rp[0, 0] += eps
    rm = r0.copy(); rm[0, 0] -= eps
    fd = (float(loss(jnp.asarray(rp))) - float(loss(jnp.asarray(rm)))) / (2 * eps)
    np.testing.assert_allclose(g[0, 0], fd, rtol=0.05, atol=1e-6)


def test_mis_integrator_sane(scene, rng):
    """MIS mode renders finite radiance in the same ballpark as NEE."""
    o, d = rays_toward_origin(256, rng)
    px = jnp.arange(256, dtype=jnp.int32)
    py = jnp.zeros((256,), jnp.int32)
    out_nee = trace_paths(scene, o, d, px, py, 0,
                          RenderConfig(max_tracing_depth=2))
    out_mis = trace_paths(scene, o, d, px, py, 0,
                          RenderConfig(max_tracing_depth=2, integrator="mis"))
    a = np.asarray(out_nee.color)
    b = np.asarray(out_mis.color)
    assert np.isfinite(b).all()
    assert (b >= 0).all()
    # agree within MC noise on the mean (different estimators, same scene)
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-3) < 0.5, (a.mean(), b.mean())


def test_mis_gradients_finite(scene, rng):
    o, d = rays_toward_origin(32, rng)
    px = jnp.arange(32, dtype=jnp.int32)
    py = jnp.zeros((32,), jnp.int32)
    cfg = RenderConfig(max_tracing_depth=2, integrator="mis")

    def loss(bc):
        s = scene.replace(materials=scene.materials.replace(base_color=bc))
        return jnp.mean(trace_paths(s, o, d, px, py, 0, cfg).color)

    g = np.asarray(jax.grad(loss)(scene.materials.base_color))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0


def test_anisotropic_path_wired(scene, rng):
    """mat.anisotropic > 0 must change the render (VERDICT r4: previously a
    parity artifact — the integrator always evaluated isotropic), and
    enable_aniso="auto" must resolve from the concrete material table."""
    n = 256
    o, d = rays_toward_origin(n, rng)
    px = jnp.arange(n, dtype=jnp.uint32)
    py = jnp.zeros((n,), jnp.uint32)
    cfg = RenderConfig(max_tracing_depth=2, compact_frac=0.0)

    def run(sc, **kw):
        c = cfg.replace(**kw) if kw else cfg
        return np.asarray(
            trace_paths(sc, o, d, px, py, jnp.uint32(2), c).color)

    iso = run(scene)
    an_mat = scene.materials.replace(
        anisotropic=jnp.full_like(scene.materials.anisotropic, 0.8),
        roughness=jnp.full_like(scene.materials.roughness, 0.3),
        metallic=jnp.full_like(scene.materials.metallic, 0.8))
    iso_m = run(scene.replace(materials=an_mat.replace(
        anisotropic=jnp.zeros_like(an_mat.anisotropic))))
    auto = run(scene.replace(materials=an_mat))           # "auto" detects
    forced_off = run(scene.replace(materials=an_mat), enable_aniso=False)
    assert np.isfinite(auto).all()
    # aniso rendering differs from the isotropic same-material render
    assert np.abs(auto - iso_m).max() > 1e-4
    # enable_aniso=False keeps the old isotropic behavior exactly
    np.testing.assert_allclose(forced_off, iso_m, rtol=1e-5, atol=1e-7)
    del iso
