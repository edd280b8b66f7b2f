"""SVGF stages + TAA: contracts each stage must satisfy."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuray.denoise.atrous import atrous_iteration
from tpuray.denoise.modulate import modulate
from tpuray.denoise.reproject import reproject
from tpuray.denoise.taa import taa, rgb_to_ycocgr, ycocgr_to_rgb
from tpuray.denoise.variance import estimate_variance
from tpuray.scene.config import RenderConfig

H = W = 32
CFG = RenderConfig(width=W, height=H)


def flat_gbuffer(rng, depth=2.0):
    normal = np.zeros((H, W, 3), np.float32); normal[..., 2] = 1.0
    linear_z = np.full((H, W), depth, np.float32)
    fw_n = np.full((H, W), 0.01, np.float32)
    fw_z = np.full((H, W), 0.01, np.float32)
    return jnp.asarray(normal), jnp.asarray(linear_z), jnp.asarray(fw_n), jnp.asarray(fw_z)


def test_reproject_static_accumulates(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    albedo = jnp.full((H, W, 3), 0.5)
    emission = jnp.zeros((H, W, 3))
    motion = jnp.zeros((H, W, 2))
    color = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))

    prev_illum = jnp.zeros((H, W, 3))
    prev_var = jnp.zeros((H, W))
    prev_moments = jnp.zeros((H, W, 2))
    prev_hist = jnp.zeros((H, W))
    # frame 1: no valid history (prev depth = sky) -> alpha 1
    out1 = reproject(color, emission, albedo, motion, normal, z, fw_n, fw_z,
                     prev_illum, prev_var, normal, jnp.ones((H, W)),
                     prev_moments, prev_hist, CFG)
    demod = np.asarray(color) / 0.5
    np.testing.assert_allclose(np.asarray(out1.illum), demod, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out1.history_len), 1.0)

    # frame 2: same signal, valid history -> EMA with alpha=max(0.2,1/2)=0.5
    out2 = reproject(color, emission, albedo, motion, normal, z, fw_n, fw_z,
                     out1.illum, out1.variance, normal, z,
                     out1.moments, out1.history_len, CFG)
    np.testing.assert_allclose(np.asarray(out2.history_len), 2.0)
    np.testing.assert_allclose(np.asarray(out2.illum), demod, rtol=1e-4)
    # constant signal -> variance ~ 0
    assert float(np.abs(np.asarray(out2.variance)).max()) < 1e-4


def test_reproject_rejects_depth_change(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    albedo = jnp.full((H, W, 3), 1.0)
    color = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    prev_z = jnp.full((H, W), 50.0)  # wildly different depth
    out = reproject(color, jnp.zeros((H, W, 3)), albedo, jnp.zeros((H, W, 2)),
                    normal, z, fw_n, fw_z,
                    jnp.full((H, W, 3), 99.0), jnp.zeros((H, W)),
                    normal, prev_z, jnp.full((H, W, 2), 9.0), jnp.full((H, W), 20.0), CFG)
    # history invalid everywhere -> restart at h=1, illum = current
    np.testing.assert_allclose(np.asarray(out.history_len), 1.0)
    np.testing.assert_allclose(np.asarray(out.illum), np.asarray(color), rtol=1e-5)


def test_variance_passthrough_with_history(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    illum = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    var = jnp.asarray(rng.random((H, W)).astype(np.float32))
    moments = jnp.zeros((H, W, 2))
    hist = jnp.full((H, W), 10.0)  # >= 4: passthrough
    out = estimate_variance(illum, var, moments, hist, normal, z, fw_z, CFG)
    np.testing.assert_array_equal(np.asarray(out.illum), np.asarray(illum))
    np.testing.assert_array_equal(np.asarray(out.variance), np.asarray(var))


def test_variance_spatial_fallback_smooths(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    illum = jnp.asarray((rng.random((H, W, 3)) * 2).astype(np.float32))
    lum = np.asarray(0.2125 * illum[..., 0] + 0.7154 * illum[..., 1] + 0.0721 * illum[..., 2])
    moments = jnp.asarray(np.stack([lum, lum ** 2], -1))
    hist = jnp.ones((H, W))
    out = estimate_variance(illum, jnp.zeros((H, W)), moments, hist, normal, z, fw_z, CFG)
    # spatial estimate reduces pixel-to-pixel scatter
    assert np.asarray(out.illum).std() < np.asarray(illum).std()
    assert (np.asarray(out.variance) >= 0).sum() > 0


def test_atrous_preserves_constant(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    illum = jnp.full((H, W, 3), 0.7)
    var = jnp.full((H, W), 0.1)
    out_i, out_v = atrous_iteration(illum, var, normal, z, fw_z, step=1, cfg=CFG)
    np.testing.assert_allclose(np.asarray(out_i), 0.7, rtol=1e-5)
    # squared-weight variance filtering must shrink variance
    assert (np.asarray(out_v) <= 0.1 + 1e-6).all()
    assert np.asarray(out_v).mean() < 0.1


def test_atrous_smooths_noise(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    illum = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    var = jnp.full((H, W), 0.5)
    out_i, _ = atrous_iteration(illum, var, normal, z, fw_z, step=1, cfg=CFG)
    assert np.asarray(out_i).std() < np.asarray(illum).std() * 0.8


def test_atrous_respects_sky(rng):
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    z = z.at[: H // 2].set(1.0)  # top half sky
    illum = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    var = jnp.full((H, W), 0.5)
    out_i, out_v = atrous_iteration(illum, var, normal, z, fw_z, step=2, cfg=CFG)
    np.testing.assert_array_equal(np.asarray(out_i)[: H // 2],
                                  np.asarray(illum)[: H // 2])


def test_modulate_inverts_demodulate(rng):
    albedo = jnp.asarray((rng.random((H, W, 3)) * 0.9 + 0.05).astype(np.float32))
    emission = jnp.asarray((rng.random((H, W, 3)) * 0.1).astype(np.float32))
    color = jnp.asarray(rng.random((H, W, 3)).astype(np.float32)) + emission
    z = jnp.full((H, W), 2.0)
    demod = (color - emission) / jnp.maximum(albedo, 1e-3)
    out = modulate(demod, albedo, emission, z)
    np.testing.assert_allclose(np.asarray(out), np.asarray(color), rtol=1e-4, atol=1e-5)


def test_ycocgr_roundtrip(rng):
    c = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    back = ycocgr_to_rgb(rgb_to_ycocgr(c))
    np.testing.assert_allclose(np.asarray(back), np.asarray(c), rtol=1e-5, atol=1e-6)


def test_taa_first_frame_passthrough(rng):
    z = jnp.full((H, W), 2.0)
    cur = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    prev = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    out = taa(cur, prev, jnp.zeros((H, W, 2)), z, frame=0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(cur))


def test_taa_static_blends_toward_history(rng):
    z = jnp.full((H, W), 2.0)
    cur = jnp.full((H, W, 3), 0.5)
    prev = jnp.full((H, W, 3), 0.5)
    out = taa(cur, prev, jnp.zeros((H, W, 2)), z, frame=3)
    np.testing.assert_allclose(np.asarray(out), 0.5, rtol=1e-5)


def test_static_camera_path_matches_general(rng):
    """static_camera=True must equal the general path when motion == 0."""
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    albedo = jnp.full((H, W, 3), 0.5)
    emission = jnp.zeros((H, W, 3))
    motion = jnp.zeros((H, W, 2))
    color = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    prev_illum = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    prev_var = jnp.asarray(rng.random((H, W)).astype(np.float32) * 0.1)
    prev_moments = jnp.asarray(rng.random((H, W, 2)).astype(np.float32))
    prev_hist = jnp.full((H, W), 5.0)
    args = (color, emission, albedo, motion, normal, z, fw_n, fw_z,
            prev_illum, prev_var, normal, z, prev_moments, prev_hist, CFG)
    gen = reproject(*args, static_camera=False)
    st = reproject(*args, static_camera=True)
    for a, b in zip(gen, st):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_taa_static_matches_general(rng):
    z = jnp.full((H, W), 2.0)
    cur = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    prev = jnp.asarray(rng.random((H, W, 3)).astype(np.float32))
    vel = jnp.zeros((H, W, 2))
    a = taa(cur, prev, vel, z, 3, static_camera=False)
    b = taa(cur, prev, vel, z, 3, static_camera=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def _shard(x, shard, rows, halo):
    """Rows [shard*rows - halo, (shard+1)*rows + halo) of x, edge rows
    repeated past the image, as the row-sharded frame's halo exchange
    builds them (tpuray.dist.frame)."""
    x = np.asarray(x)
    pad = np.pad(x, ((halo, halo),) + ((0, 0),) * (x.ndim - 1), mode="edge")
    return jnp.asarray(pad[shard * rows:(shard + 1) * rows + 2 * halo])


def _moving_history(rng):
    """Reprojection inputs with per-pixel motion of up to ~2.5 px in both
    directions (so the top and bottom rows read off-image) and a block
    whose bilinear taps fail, so the 3x3 rescue engages."""
    normal, z, fw_n, fw_z = flat_gbuffer(rng)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    motion = np.stack([(1.3 + np.sin(yy / 5.0)) / W,
                       2.4 * np.cos(xx / 4.0) / H], -1).astype(np.float32)
    f = lambda *shape: jnp.asarray(rng.random(shape).astype(np.float32))
    return dict(color=f(H, W, 3), emission=jnp.zeros((H, W, 3)),
                albedo=jnp.full((H, W, 3), 0.5), motion=jnp.asarray(motion),
                normal=normal, linear_z=z, fwidth_normal=fw_n, fwidth_z=fw_z,
                prev_illum=f(H, W, 3), prev_variance=f(H, W),
                prev_normal=normal, prev_linear_z=z.at[8:16, 8:16].add(5.0),
                prev_moments=f(H, W, 2), prev_history_len=jnp.full((H, W), 5.0))


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_reproject_row_window_matches_whole_image(rng, shard):
    """A halo-extended row shard (row_window) reprojects its rows exactly as
    the whole image does while the motion stays inside the halo."""
    rows, halo = H // 4, 4
    args = _moving_history(rng)
    whole = reproject(**args, cfg=CFG)
    part = reproject(**{k: _shard(v, shard, rows, halo)
                        for k, v in args.items()},
                     cfg=CFG, row_window=(shard * rows - halo, H))
    own = np.s_[shard * rows:(shard + 1) * rows]
    for a, b in zip(whole, part):
        np.testing.assert_allclose(np.asarray(b)[halo:-halo],
                                   np.asarray(a)[own], rtol=1e-6, atol=1e-6)


def test_reproject_row_window_far_reads_fail(rng):
    """History reads beyond the shard's halo count as failed taps (history
    restarts, values finite); reads inside it equal the whole image's."""
    rows, halo, shard = H // 4, 2, 1
    args = _moving_history(rng)
    args["motion"] = jnp.stack([jnp.zeros((H, W)), jnp.full((H, W), 6.0 / H)],
                               -1)  # every pixel reads the row 6 above
    args["prev_linear_z"] = args["linear_z"]  # every tap valid in the image
    whole = reproject(**args, cfg=CFG)
    part = reproject(**{k: _shard(v, shard, rows, halo)
                        for k, v in args.items()},
                     cfg=CFG, row_window=(shard * rows - halo, H))
    for a in part:
        assert np.isfinite(np.asarray(a)).all()
    hist = np.asarray(part.history_len)[halo:-halo]
    ref = np.asarray(whole.history_len)[shard * rows:(shard + 1) * rows]
    np.testing.assert_array_equal(ref, 6.0)
    # local row i reads rows i-7..i-5 (rescue) and i-6, i-5 (bilinear)
    local = np.arange(halo, halo + rows)
    np.testing.assert_array_equal(hist[local < 5], 1.0)
    np.testing.assert_array_equal(hist[local >= 6], 6.0)


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_taa_row_window_matches_whole_image(rng, shard):
    rows, halo = H // 4, 4
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    vel = np.stack([(1.3 + np.sin(yy / 5.0)) / W,
                    2.4 * np.cos(xx / 4.0) / H], -1).astype(np.float32)
    z = np.full((H, W), 2.0, np.float32)
    z[:, :3] = 1.0   # sky passthrough
    cur = rng.random((H, W, 3)).astype(np.float32)
    prev = rng.random((H, W, 3)).astype(np.float32)
    whole = taa(jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(vel),
                jnp.asarray(z), 3)
    part = taa(*(_shard(x, shard, rows, halo) for x in (cur, prev, vel, z)),
               3, row_window=(shard * rows - halo, H))
    np.testing.assert_allclose(
        np.asarray(part)[halo:-halo],
        np.asarray(whole)[shard * rows:(shard + 1) * rows],
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("yc,row0,h,gh,held", [
    (5, 2, 8, 32, True),     # both rows of the quad inside the shard
    (1, 2, 8, 32, False),    # above the shard
    (9, 2, 8, 32, False),    # the quad's second row is past the shard
    (31, 24, 8, 32, True),   # image's last row: the quad repeats it
    (31, 0, 32, 32, True),   # whole image
])
def test_quad_in_rows(yc, row0, h, gh, held):
    from tpuray.denoise.common import quad_in_rows
    assert bool(quad_in_rows(jnp.int32(yc), (row0, gh), h)) == held
