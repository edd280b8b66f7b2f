"""SVGF temporal reprojection.

Re-derivation of shaders/svgf_reproject.frag: demodulate the 1spp color,
back-project via motion vectors, validate the 4 bilinear taps against
depth/normal consistency, 3x3 cross-bilateral rescue when all fail, then EMA
of illumination and luminance moments with history-length control.

All previous-frame reads go through the packed history atlas
(denoise/history_atlas.py): the 4 bilinear taps of every buffer are ONE
gather; the rescue is 9 atlas gathers (27+ narrow gathers before).

Default bilinear weights are the standard pixel-space fractional weights; the
reference's sub-pixel-scaled weights (svgf_reproject.frag:84-91 computes the
fraction in *uv* units, making taps 1-3 nearly weightless) are available via
reference_quirks.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuray.denoise.common import luminance, quad_in_rows
from tpuray.denoise.history_atlas import build_atlas, fetch_quad
from tpuray.scene.config import RenderConfig

Array = jax.Array


class ReprojectOutput(NamedTuple):
    illum: Array      # (H, W, 3) temporally accumulated illumination
    variance: Array   # (H, W)
    moments: Array    # (H, W, 2)
    history_len: Array  # (H, W)


def _tap_valid(yi, xi, h, w, z_cur, fw_z, n_cur, fw_n, tap, cfg):
    """isReprjValid (svgf_reproject.frag:31-43) against an atlas tap."""
    in_b = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    depth_ok = (jnp.abs(tap["linear_z"] - z_cur) / (fw_z + 1e-2)) \
        <= cfg.reproj_depth_threshold
    ndist = jnp.linalg.norm(n_cur - tap["normal"], axis=-1)
    normal_ok = (ndist / (fw_n + 1e-2)) <= cfg.reproj_normal_threshold
    return in_b & depth_ok & normal_ok


def reproject(color: Array, emission: Array, albedo: Array,
              motion: Array, normal: Array, linear_z: Array,
              fwidth_normal: Array, fwidth_z: Array,
              prev_illum: Array, prev_variance: Array,
              prev_normal: Array, prev_linear_z: Array,
              prev_moments: Array, prev_history_len: Array,
              cfg: RenderConfig, static_camera: bool = False,
              row_window: tuple | None = None) -> ReprojectOutput:
    # row_window=(row0, global_h): inputs are a halo-extended row shard of a
    # taller image; all uv/pixel math runs in global coordinates and a
    # history read beyond the shard's rows counts as a failed tap, so a shard
    # whose motion stays inside its halo computes exactly the single-device
    # result (tpuray.dist.frame).
    if static_camera:
        return _reproject_static(
            color, emission, albedo, normal, linear_z, fwidth_normal,
            fwidth_z, prev_illum, prev_variance, prev_normal, prev_linear_z,
            prev_moments, prev_history_len, cfg, row_window)
    h, w = color.shape[:2]
    row0, gh = row_window if row_window is not None else (0, h)
    yy, xx = jnp.meshgrid(jnp.arange(h) + row0, jnp.arange(w), indexing="ij")

    sky = linear_z == 1.0

    qatlas = build_atlas(prev_illum, prev_variance, prev_normal,
                         prev_linear_z, prev_moments, prev_history_len)

    def fetch(y, x):
        """The quad at global (y, x) and, on a row shard, whether the shard
        holds it (y is clamped to the image as a whole-image fetch does)."""
        yc = jnp.clip(y, 0, gh - 1)
        quad = fetch_quad(qatlas, yc - row0, x)
        if row_window is None:
            return quad, True
        return quad, quad_in_rows(yc, row_window, h)

    # demodulate (svgf_reproject.frag:26-29, 174)
    illum = (color - emission) / jnp.maximum(albedo, 1e-3)
    illum = jnp.where(jnp.isnan(illum), 0.0, illum)

    # back-projected float pixel position: uv_prev = uv - motion; pixel
    # centers at (i + 0.5)
    uv_x = (xx.astype(jnp.float32) + 0.5) / w - motion[..., 0]
    uv_y = (yy.astype(jnp.float32) + 0.5) / gh - motion[..., 1]
    fx = uv_x * w - 0.5
    fy = uv_y * gh - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    if cfg.reference_quirks:
        # frac computed in uv units (svgf_reproject.frag:84-85): w/h times
        # smaller, so tap 0 dominates
        frac_x = (uv_x % (1.0 / w))
        frac_y = (uv_y % (1.0 / gh))
    else:
        frac_x = fx - x0
        frac_y = fy - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    taps, held = fetch(y0i, x0i)  # one gather: 4 bilinear taps
    offsets = [(0, 0), (1, 0), (0, 1), (1, 1)]
    weights = [
        (1 - frac_x) * (1 - frac_y), frac_x * (1 - frac_y),
        (1 - frac_x) * frac_y, frac_x * frac_y,
    ]

    sum_w = jnp.zeros((h, w), jnp.float32)
    acc_illum = jnp.zeros((h, w, 4), jnp.float32)
    acc_mom = jnp.zeros((h, w, 2), jnp.float32)
    any_valid = jnp.zeros((h, w), bool)
    for (dx, dy), wt, tap in zip(offsets, weights, taps):
        v = held & _tap_valid(y0i + dy, x0i + dx, gh, w, linear_z, fwidth_z,
                              normal, fwidth_normal, tap, cfg)
        any_valid = any_valid | v
        wv = jnp.where(v, wt, 0.0)
        sum_w = sum_w + wv
        illum_var = jnp.concatenate([tap["illum"], tap["variance"][..., None]], -1)
        acc_illum = acc_illum + wv[..., None] * illum_var
        acc_mom = acc_mom + wv[..., None] * tap["moments"]

    bilinear_ok = any_valid & (sum_w >= 0.01)
    safe_w = jnp.maximum(sum_w, 1e-6)
    prev_i = jnp.where(bilinear_ok[..., None], acc_illum / safe_w[..., None], 0.0)
    prev_mo = jnp.where(bilinear_ok[..., None], acc_mom / safe_w[..., None], 0.0)

    # 3x3 cross-bilateral rescue (svgf_reproject.frag:111-141): the 9 taps
    # are covered by 4 quad fetches (2x2 blocks tiling the 4x4 neighborhood).
    # Quad bases clamp to [0, dim-2] so fetched data always matches the tap's
    # true position; taps outside the 3x3 window are masked per pixel.
    n_valid = jnp.zeros((h, w), jnp.float32)
    r_illum = jnp.zeros((h, w, 4), jnp.float32)
    r_mom = jnp.zeros((h, w, 2), jnp.float32)
    for base_dy, base_dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        yb = jnp.clip(y0i + base_dy, 0, gh - 2)
        xb = jnp.clip(x0i + base_dx, 0, w - 2)
        quad, held = fetch(yb, xb)
        for (qdx, qdy), tap in zip(((0, 0), (1, 0), (0, 1), (1, 1)), quad):
            ty = yb + qdy
            tx = xb + qdx
            in_window = (jnp.abs(ty - y0i) <= 1) & (jnp.abs(tx - x0i) <= 1)
            # interior pixels see each window position exactly once (the 4
            # quads tile a disjoint 4x4); at image borders clamped quads may
            # overlap, double-weighting an edge tap — matching clamp-to-edge
            # border behavior closely enough
            if (base_dy, base_dx) != (-1, -1):
                # drop the quad's duplicate coverage of the (0,0)..(-1,-1)
                # block for interior pixels: only the first quad owns taps
                # with ty<=y0 and tx<=x0
                in_window = in_window & ~((ty <= y0i) & (tx <= x0i))
            v = in_window & held & _tap_valid(
                ty, tx, gh, w, linear_z, fwidth_z, normal, fwidth_normal,
                tap, cfg)
            vf = v.astype(jnp.float32)
            n_valid = n_valid + vf
            illum_var = jnp.concatenate([tap["illum"], tap["variance"][..., None]], -1)
            r_illum = r_illum + vf[..., None] * illum_var
            r_mom = r_mom + vf[..., None] * tap["moments"]
    rescue_ok = (~bilinear_ok) & (n_valid > 0)
    safe_n = jnp.maximum(n_valid, 1.0)
    prev_i = jnp.where(rescue_ok[..., None], r_illum / safe_n[..., None], prev_i)
    prev_mo = jnp.where(rescue_ok[..., None], r_mom / safe_n[..., None], prev_mo)

    return _finish(color, illum, prev_i, prev_mo, bilinear_ok, rescue_ok,
                   taps, fx, fy, x0i, y0i, sky, prev_moments,
                   prev_history_len, linear_z, cfg, gh, w)


def _finish(color, illum, prev_i, prev_mo, bilinear_ok, rescue_ok, taps,
            fx, fy, x0i, y0i, sky, prev_moments, prev_history_len,
            linear_z, cfg, h, w) -> ReprojectOutput:
    """EMA + history-length tail of the reprojection pass
    (svgf_reproject.frag:143-205)."""
    success = bilinear_ok | rescue_ok

    # history length fetched at the reprojected position (frag:143-147).
    # round(fy/fx) is always one of the 4 bilinear corners already gathered,
    # so select from the quad instead of issuing another full-frame gather.
    # (clamped-index compare so screen borders match the clamped fetch)
    near_x = jnp.clip(jnp.round(fx).astype(jnp.int32), 0, w - 1) \
        > jnp.clip(x0i, 0, w - 1)
    near_y = jnp.clip(jnp.round(fy).astype(jnp.int32), 0, h - 1) \
        > jnp.clip(y0i, 0, h - 1)
    h00 = taps[0]["history_len"]
    h10 = taps[1]["history_len"]
    h01 = taps[2]["history_len"]
    h11 = taps[3]["history_len"]
    hist_prev = jnp.where(
        near_y, jnp.where(near_x, h11, h01), jnp.where(near_x, h10, h00))
    hist = jnp.minimum(cfg.history_cap,
                       jnp.where(success, hist_prev + 1.0, 1.0))

    alpha = jnp.where(success, jnp.maximum(cfg.alpha_min, 1.0 / hist), 1.0)

    lum = luminance(illum)
    mom_new = jnp.stack([lum, lum * lum], axis=-1)
    moments = (1.0 - alpha)[..., None] * prev_mo + alpha[..., None] * mom_new
    variance = jnp.maximum(0.0, moments[..., 1] - moments[..., 0] ** 2)

    out_illum = (1.0 - alpha)[..., None] * prev_i[..., :3] + alpha[..., None] * illum

    # sky passthrough (frag:166-171): raw color, keep prior moments buffer
    out_illum = jnp.where(sky[..., None], color, out_illum)
    variance = jnp.where(sky, 0.0, variance)
    moments = jnp.where(sky[..., None], prev_moments, moments)
    hist = jnp.where(sky, prev_history_len, hist)

    return ReprojectOutput(illum=out_illum, variance=variance,
                           moments=moments, history_len=hist)


def _reproject_static(color, emission, albedo, normal, linear_z,
                      fwidth_normal, fwidth_z, prev_illum, prev_variance,
                      prev_normal, prev_linear_z, prev_moments,
                      prev_history_len, cfg,
                      row_window: tuple | None = None) -> ReprojectOutput:
    """Static-camera specialization: motion == 0, so every history read is
    the same pixel (bilinear collapses to the base tap) and the 3x3 rescue
    uses static shifts — the whole pass is gather-free. Semantically
    identical to the general path with motion = 0."""
    from tpuray.denoise.common import inside_mask, shift2d

    h, w = color.shape[:2]
    sky = linear_z == 1.0

    illum = (color - emission) / jnp.maximum(albedo, 1e-3)
    illum = jnp.where(jnp.isnan(illum), 0.0, illum)

    def tap_valid(z_p, n_p):
        depth_ok = (jnp.abs(z_p - linear_z) / (fwidth_z + 1e-2)) \
            <= cfg.reproj_depth_threshold
        ndist = jnp.linalg.norm(normal - n_p, axis=-1)
        normal_ok = (ndist / (fwidth_normal + 1e-2)) <= cfg.reproj_normal_threshold
        return depth_ok & normal_ok

    # bilinear collapses to the center tap (frac == 0)
    base_valid = tap_valid(prev_linear_z, prev_normal)
    prev_i = jnp.where(base_valid[..., None],
                       jnp.concatenate([prev_illum, prev_variance[..., None]], -1),
                       0.0)
    prev_mo = jnp.where(base_valid[..., None], prev_moments, 0.0)

    # 3x3 rescue with static shifts
    n_valid = jnp.zeros((h, w), jnp.float32)
    r_illum = jnp.zeros((h, w, 4), jnp.float32)
    r_mom = jnp.zeros((h, w, 2), jnp.float32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            z_p = shift2d(prev_linear_z, dy, dx)
            n_p = shift2d(prev_normal, dy, dx)
            v = tap_valid(z_p, n_p) & inside_mask((h, w), dy, dx, row_window)
            vf = v.astype(jnp.float32)
            n_valid = n_valid + vf
            iv = jnp.concatenate([shift2d(prev_illum, dy, dx),
                                  shift2d(prev_variance, dy, dx)[..., None]], -1)
            r_illum = r_illum + vf[..., None] * iv
            r_mom = r_mom + vf[..., None] * shift2d(prev_moments, dy, dx)
    rescue_ok = (~base_valid) & (n_valid > 0)
    safe_n = jnp.maximum(n_valid, 1.0)
    prev_i = jnp.where(rescue_ok[..., None], r_illum / safe_n[..., None], prev_i)
    prev_mo = jnp.where(rescue_ok[..., None], r_mom / safe_n[..., None], prev_mo)

    success = base_valid | rescue_ok
    hist = jnp.minimum(cfg.history_cap,
                       jnp.where(success, prev_history_len + 1.0, 1.0))
    alpha = jnp.where(success, jnp.maximum(cfg.alpha_min, 1.0 / hist), 1.0)

    lum = luminance(illum)
    mom_new = jnp.stack([lum, lum * lum], axis=-1)
    moments = (1.0 - alpha)[..., None] * prev_mo + alpha[..., None] * mom_new
    variance = jnp.maximum(0.0, moments[..., 1] - moments[..., 0] ** 2)
    out_illum = (1.0 - alpha)[..., None] * prev_i[..., :3] + alpha[..., None] * illum

    out_illum = jnp.where(sky[..., None], color, out_illum)
    variance = jnp.where(sky, 0.0, variance)
    moments = jnp.where(sky[..., None], prev_moments, moments)
    hist = jnp.where(sky, prev_history_len, hist)
    return ReprojectOutput(illum=out_illum, variance=variance,
                           moments=moments, history_len=hist)
