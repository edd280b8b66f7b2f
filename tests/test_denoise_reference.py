"""The jnp SVGF stages against plain per-pixel numpy references: reprojection
(whole image and row shard), the spatial variance fallback, one a-trous iteration and
the a-trous chain with its history tap."""
import numpy as np
import pytest
import jax.numpy as jnp

from tpuray.denoise.atrous import atrous_iteration
from tpuray.denoise.reproject import reproject
from tpuray.denoise.svgf import svgf_pipeline
from tpuray.denoise.variance import estimate_variance
from tpuray.integrator.gbuffer import GBuffer
from tpuray.render.frame_state import FrameState
from tpuray.scene.config import RenderConfig

H, W = 12, 14
K1 = (1.0, 2.0 / 3.0, 1.0 / 6.0)


def lum(c):
    return 0.2125 * c[..., 0] + 0.7154 * c[..., 1] + 0.0721 * c[..., 2]


def weight(z_c, z_p, phi_z, n_c, n_p, phi_n, l_c, l_p, phi_l):
    w_n = np.clip(np.dot(n_c, n_p), 0.0, 1.0) ** phi_n
    w_z = 0.0 if phi_z == 0.0 else abs(z_c - z_p) / phi_z
    w_l = abs(l_c - l_p) / max(phi_l, 1e-10)
    return np.exp(-max(w_l, 0.0) - max(w_z, 0.0)) * w_n


def clamp_at(img, y, x):
    return img[min(max(y, 0), img.shape[0] - 1), min(max(x, 0), img.shape[1] - 1)]


def np_atrous(illum, var, normal, z, fwz, step, cfg):
    h, w = z.shape
    lu = lum(illum)
    out_i, out_v = illum.copy(), var.copy()
    for y in range(h):
        for x in range(w):
            if z[y, x] == 1.0:
                continue
            if cfg.reference_quirks:
                vb = var[y, x]
            else:
                vb = sum(k * clamp_at(var, y + dy, x + dx)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                         for k in [(1 / 4, 1 / 8, 1 / 16)[abs(dy) + abs(dx)]])
            phi_l = cfg.sigma_l * np.sqrt(max(1e-10, 1e-10 + vb))
            phi_z = max(fwz[y, x], 1e-8) * step
            sw, si, sv = 1.0, illum[y, x].copy(), var[y, x]
            for yy in range(-2, 3):
                for xx in range(-2, 3):
                    py, px = y + yy * step, x + xx * step
                    if (yy, xx) == (0, 0) or not (0 <= py < h and 0 <= px < w):
                        continue
                    wt = weight(z[y, x], z[py, px],
                                phi_z * np.hypot(xx, yy), normal[y, x],
                                normal[py, px], cfg.sigma_n, lu[y, x],
                                lu[py, px], phi_l) * K1[abs(xx)] * K1[abs(yy)]
                    sw += wt
                    si = si + wt * illum[py, px]
                    sv += wt * wt * var[py, px]
            out_i[y, x] = si / sw
            out_v[y, x] = sv / (sw * sw)
    return out_i, out_v


def np_variance(illum, var, moments, hist, normal, z, fwz, cfg):
    h, w = z.shape
    lu = lum(illum)
    out_i, out_v = illum.copy(), var.copy()
    for y in range(h):
        for x in range(w):
            if not (hist[y, x] < 4.0 and z[y, x] != 1.0):
                continue
            phi_z = max(fwz[y, x], 1e-8) * 3.0
            sw, si, sm = 0.0, np.zeros(3), np.zeros(2)
            for dy in range(-3, 4):
                for dx in range(-3, 4):
                    py, px = y + dy, x + dx
                    if not (0 <= py < h and 0 <= px < w):
                        continue
                    wt = weight(z[y, x], z[py, px], phi_z * np.hypot(dx, dy),
                                normal[y, x], normal[py, px], cfg.sigma_n,
                                lu[y, x], lu[py, px], cfg.sigma_l)
                    sw += wt
                    si += wt * illum[py, px]
                    sm += wt * moments[py, px]
            sw = max(sw, 1e-6)
            m = sm / sw
            out_i[y, x] = si / sw
            out_v[y, x] = (m[1] - m[0] ** 2) * (4.0 / max(hist[y, x], 1e-3))
    return out_i, out_v


def np_reproject(a, cfg):
    """Per-pixel reprojection (svgf_reproject.frag) on interior pixels."""
    h, w = a["z"].shape
    illum = (a["color"] - a["emission"]) / np.maximum(a["albedo"], 1e-3)
    out = {k: np.zeros(s) for k, s in (("illum", (h, w, 3)),
                                       ("variance", (h, w)),
                                       ("moments", (h, w, 2)),
                                       ("history_len", (h, w)))}

    def valid(ty, tx, y, x):
        if not (0 <= ty < h and 0 <= tx < w):
            return False
        dz = abs(a["prev_z"][ty, tx] - a["z"][y, x]) / (a["fwz"][y, x] + 1e-2)
        dn = np.linalg.norm(a["normal"][y, x] - a["prev_normal"][ty, tx]) / (
            a["fwn"][y, x] + 1e-2)
        return dz <= cfg.reproj_depth_threshold and dn <= cfg.reproj_normal_threshold

    def tap(ty, tx):
        return (np.append(a["prev_illum"][ty, tx], a["prev_var"][ty, tx]),
                a["prev_moments"][ty, tx])

    for y in range(h):
        for x in range(w):
            fx = ((x + 0.5) / w - a["motion"][y, x, 0]) * w - 0.5
            fy = ((y + 0.5) / h - a["motion"][y, x, 1]) * h - 0.5
            x0, y0 = int(np.floor(fx)), int(np.floor(fy))
            frx, fry = fx - x0, fy - y0
            sw, acc_i, acc_m, anyv = 0.0, np.zeros(4), np.zeros(2), False
            for (dx, dy), wt in (((0, 0), (1 - frx) * (1 - fry)),
                                 ((1, 0), frx * (1 - fry)),
                                 ((0, 1), (1 - frx) * fry), ((1, 1), frx * fry)):
                if valid(y0 + dy, x0 + dx, y, x):
                    anyv = True
                    ti, tm = tap(y0 + dy, x0 + dx)
                    sw += wt
                    acc_i += wt * ti
                    acc_m += wt * tm
            bil = anyv and sw >= 0.01
            prev_i = acc_i / max(sw, 1e-6) if bil else np.zeros(4)
            prev_m = acc_m / max(sw, 1e-6) if bil else np.zeros(2)
            rescue = False
            if not bil:
                n, ri, rm = 0, np.zeros(4), np.zeros(2)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        if valid(y0 + dy, x0 + dx, y, x):
                            ti, tm = tap(y0 + dy, x0 + dx)
                            n, ri, rm = n + 1, ri + ti, rm + tm
                if n:
                    rescue, prev_i, prev_m = True, ri / n, rm / n
            ok = bil or rescue
            cy = y0 + int(round(fy) > y0)
            cx = x0 + int(round(fx) > x0)
            hist = min(cfg.history_cap,
                       clamp_at(a["prev_hist"], cy, cx) + 1.0 if ok else 1.0)
            alpha = max(cfg.alpha_min, 1.0 / hist) if ok else 1.0
            lu = lum(illum[y, x])
            mom = (1 - alpha) * prev_m + alpha * np.array([lu, lu * lu])
            if a["z"][y, x] == 1.0:
                out["illum"][y, x] = a["color"][y, x]
                out["variance"][y, x] = 0.0
                out["moments"][y, x] = a["prev_moments"][y, x]
                out["history_len"][y, x] = a["prev_hist"][y, x]
                continue
            out["illum"][y, x] = (1 - alpha) * prev_i[:3] + alpha * illum[y, x]
            out["variance"][y, x] = max(0.0, mom[1] - mom[0] ** 2)
            out["moments"][y, x] = mom
            out["history_len"][y, x] = hist
    return out


def make_buffers(seed, motion="smooth", sky=False):
    r = np.random.default_rng(seed)
    f = lambda *s: r.random(s).astype(np.float32)
    n = f(H, W, 3) * 0.2 + np.array([0, 0, 1], np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = 2.0 + f(H, W) * 0.05
    if sky:
        z[:, -3:] = 1.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if motion == "smooth":
        mv = np.stack([0.3 / W + 0.02 * xx / W ** 2, -0.7 / H + 0.0 * yy], -1)
    else:  # a depth step: the right half moved and fails its depth test
        mv = np.stack([np.where(xx > W / 2, 1.6 / W, 0.4 / W),
                       np.full_like(yy, 0.2 / H)], -1)
    prev_z = z + (xx > W / 2) * (5.0 if motion != "smooth" else 0.0)
    return dict(color=f(H, W, 3), emission=f(H, W, 3) * 0.05,
                albedo=f(H, W, 3) * 0.8 + 0.2, motion=mv.astype(np.float32),
                normal=n, z=z, fwn=f(H, W) * 0.05, fwz=f(H, W) * 0.02,
                prev_illum=f(H, W, 3), prev_var=f(H, W) * 0.1,
                prev_normal=n, prev_z=prev_z.astype(np.float32),
                prev_moments=f(H, W, 2), prev_hist=np.floor(f(H, W) * 8))


@pytest.mark.parametrize("window,motion,sky", [
    ("whole", "smooth", False), ("whole", "smooth", True),
    ("whole", "step", False), ("shard", "smooth", False),
    ("shard", "step", True)])
def test_reproject_matches_numpy(window, motion, sky):
    """window='shard': rows 4-7 reprojected on a halo-extended row shard
    (row_window, as the row-sharded frame runs it)."""
    a = make_buffers(3, motion, sky)
    cfg = RenderConfig(width=W, height=H)
    names = ("color", "emission", "albedo", "motion", "normal", "z", "fwn",
             "fwz", "prev_illum", "prev_var", "prev_normal", "prev_z",
             "prev_moments", "prev_hist")
    ref = np_reproject(a, cfg)
    if window == "whole":
        out = reproject(*(jnp.asarray(a[k]) for k in names), cfg=cfg)
        rows = slice(2, H - 2)
    else:
        lo, hi, halo = 4, 8, 2
        out = reproject(*(jnp.asarray(a[k][lo - halo:hi + halo])
                          for k in names), cfg=cfg,
                        row_window=(lo - halo, H))
        out = type(out)(*(x[halo:-halo] for x in out))
        ref = {k: v[lo:hi] for k, v in ref.items()}
        rows = slice(None)
    inner = (rows, slice(2, W - 2))  # every tap in the image
    for k in ("illum", "variance", "moments", "history_len"):
        np.testing.assert_allclose(np.asarray(getattr(out, k))[inner],
                                   ref[k][inner], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("sky", [False, True])
def test_variance_matches_numpy(sky):
    a = make_buffers(5, sky=sky)
    hist = np.where(np.arange(W)[None, :] % 3 == 0, 6.0, 2.0) * np.ones((H, 1))
    cfg = RenderConfig(width=W, height=H)
    out = estimate_variance(
        jnp.asarray(a["prev_illum"]), jnp.asarray(a["prev_var"]),
        jnp.asarray(a["prev_moments"]), jnp.asarray(hist, jnp.float32),
        jnp.asarray(a["normal"]), jnp.asarray(a["z"]), jnp.asarray(a["fwz"]),
        cfg)
    ri, rv = np_variance(a["prev_illum"], a["prev_var"], a["prev_moments"],
                         hist, a["normal"], a["z"], a["fwz"], cfg)
    np.testing.assert_allclose(np.asarray(out.illum), ri, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.variance), rv, rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("step", [1, 2, 4])
@pytest.mark.parametrize("quirks", [False, True])
def test_atrous_iteration_matches_numpy(step, quirks):
    a = make_buffers(7, sky=True)
    cfg = RenderConfig(width=W, height=H, reference_quirks=quirks)
    oi, ov = atrous_iteration(
        jnp.asarray(a["prev_illum"]), jnp.asarray(a["prev_var"]),
        jnp.asarray(a["normal"]), jnp.asarray(a["z"]), jnp.asarray(a["fwz"]),
        step=step, cfg=cfg)
    ri, rv = np_atrous(a["prev_illum"], a["prev_var"], a["normal"], a["z"],
                       a["fwz"], step, cfg)
    np.testing.assert_allclose(np.asarray(oi), ri, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ov), rv, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("iters,tap", [(3, 0), (3, 1), (3, 2), (1, 1)])
def test_atrous_chain_history_tap(iters, tap):
    """svgf_pipeline's chain: output of iteration `tap` feeds the history
    (the input itself when the tap is past the last iteration)."""
    a = make_buffers(9)
    cfg = RenderConfig(width=W, height=H, num_atrous_iterations=iters,
                       history_atrous_tap=tap)
    gbuf = GBuffer(normal=jnp.asarray(a["normal"]), linear_z=jnp.asarray(a["z"]),
                   velocity=jnp.asarray(a["motion"]),
                   fwidth_normal=jnp.asarray(a["fwn"]),
                   fwidth_z=jnp.asarray(a["fwz"]),
                   world_pos=jnp.zeros((H, W, 3)))
    state = FrameState.initial(H, W).replace(
        illum_hist=jnp.asarray(a["prev_illum"]),
        variance_hist=jnp.asarray(a["prev_var"]),
        prev_normal=jnp.asarray(a["prev_normal"]),
        prev_linear_z=jnp.asarray(a["prev_z"]),
        moments=jnp.asarray(a["prev_moments"]),
        history_len=jnp.asarray(a["prev_hist"]), frame_idx=jnp.int32(3))
    out = svgf_pipeline(jnp.asarray(a["color"]), jnp.asarray(a["emission"]),
                        jnp.asarray(a["albedo"]), gbuf, state, cfg)
    il = np.asarray(out.variance_illum, np.float64)
    va = np.asarray(out.variance_var, np.float64)
    tap_i, tap_v = il, va
    for i in range(iters):
        il, va = np_atrous(il, va, a["normal"], a["z"], a["fwz"], 1 << i, cfg)
        if i == tap:
            tap_i, tap_v = il, va
    np.testing.assert_allclose(np.asarray(out.atrous), il, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.history_tap), tap_i, rtol=5e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.history_tap_var), tap_v,
                               rtol=5e-4, atol=1e-7)
