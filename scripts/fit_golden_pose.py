"""Recover the camera pose behind the reference's golden screenshots.

The result/*.png captures were taken after the user orbited/dollied the
camera (the clock is larger and off-center vs the startup pose), so
pixel-framing comparisons need the pose. Geometry IS shipped (clock.obj), so
we fit it: render a facing-ratio proxy shading (|n . v| over the
primary-hit mask — structurally close to the metallic clock's real look:
bright dial center, darker rim/bells) for candidate (yaw, pitch, radius)
poses with the packet trace kernel and template-match it against the
screenshot luminance with LOCALLY NORMALIZED cross-correlation over all
integer offsets (FFT + box-filter local statistics). Edge-ring metrics
(silhouette gradient vs image gradient) are degenerate here: the room
background is edge-rich, so bigger silhouettes score higher regardless of
alignment. The translation peak stands in for the reference's WASD pan.

Usage: PYTHONPATH=. python scripts/fit_golden_pose.py
Prints JSON {yaw, pitch, radius, dy, dx, score}; feed to compare_golden.py.
"""
from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np

from tpuray.utils.platform import enable_compile_cache

enable_compile_cache()

import jax
import jax.numpy as jnp

# the reference checkout's result/ screenshots
GOLD = os.path.join(os.environ.get("TPURAY_REFERENCE_RESULTS",
                                  "reference/result"),
                    "accumulate_output.png")
RES = 400          # fit resolution (golden viewport is 800 -> /2)
ROI_FRAC = 0.63    # below this the screenshot is imgui-overlaid
MARGIN = 60        # template crop: allows +-MARGIN placement both ways


def downsample(img: np.ndarray, k: int) -> np.ndarray:
    h, w = img.shape[0] // k * k, img.shape[1] // k * k
    return img[:h, :w].reshape(h // k, k, w // k, k).mean((1, 3))


def _box_sum(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H-h+1, W-w+1) sliding-window sums via 2D cumsum."""
    c = np.cumsum(np.cumsum(img, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    return c[h:, w:] - c[:-h, w:] - c[h:, :-w] + c[:-h, :-w]


def ncc_match(template: np.ndarray, image: np.ndarray,
              max_shift: int = 160) -> tuple[float, int, int]:
    """Max locally-normalized cross-correlation of template over image.
    Returns (score, dy, dx): template placed at image[dy:, dx:]."""
    t = template - template.mean()
    tn = np.linalg.norm(t)
    if tn == 0:
        return -1.0, 0, 0
    h, w = t.shape
    H, W = image.shape
    pad = np.zeros((H, W), np.float32)
    pad[:h, :w] = t[::-1, ::-1]
    corr_full = np.fft.irfft2(np.fft.rfft2(image) * np.fft.rfft2(pad),
                              s=(H, W))
    # valid placements: corr_full[y + h - 1, x + w - 1] = sum T*I_patch(y,x)
    corr = corr_full[h - 1:, w - 1:]
    s1 = _box_sum(image, h, w)
    s2 = _box_sum(image * image, h, w)
    var = np.maximum(s2 - s1 * s1 / (h * w), 1e-12)
    score_map = corr / (np.sqrt(var) * tn)
    dy, dx = np.unravel_index(np.argmax(score_map), score_map.shape)
    return float(score_map[dy, dx]), int(dy), int(dx)


def main() -> int:
    from tpuray.io.image import read_png
    from tpuray.integrator.intersect import triangle_constants
    from tpuray.integrator.path_tracer import trace
    from tpuray.scene.builder import reference_default_scene
    from tpuray.scene.camera import OrbitCamera
    from tpuray.utils.imgcmp import luminance

    scene = reference_default_scene(reference_quirks=True)
    plane_n = triangle_constants(scene.triangles)["n"]  # unit plane normals

    gold = read_png(GOLD)
    k = 800 // RES
    gold_small = downsample(luminance(gold), k).astype(np.float32)
    roi = int(RES * ROI_FRAC)

    @jax.jit
    def silhouette(eye, cam_to_world, tan_half_fov):
        ys, xs = jnp.meshgrid(
            (jnp.arange(RES) + 0.5) / RES * 2.0 - 1.0,
            (jnp.arange(RES) + 0.5) / RES * 2.0 - 1.0, indexing="ij")
        d_cam = jnp.stack([xs * tan_half_fov, -ys * tan_half_fov,
                           -jnp.ones_like(xs)], axis=-1).reshape(-1, 3)
        d = jnp.einsum("ij,nj->ni", cam_to_world, d_cam,
                       precision=jax.lax.Precision.HIGHEST)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o = jnp.broadcast_to(eye, d.shape)
        _, idx = trace(scene.bvh, scene.triangles, o, d)
        hitn = plane_n[jnp.maximum(idx, 0)]
        facing = jnp.abs(jnp.sum(hitn * d, axis=-1))
        facing = jnp.where(idx >= 0, facing, 0.0)
        return facing.reshape(RES, RES).astype(jnp.float32)

    def score(yaw, pitch, radius):
        cam = OrbitCamera(width=RES, height=RES, yaw_deg=float(yaw),
                          pitch_deg=float(pitch), radius=float(radius)
                          ).snapshot()
        m = np.asarray(silhouette(cam.eye, cam.cam_to_world,
                                  cam.tan_half_fov))
        # physical constraint: the screenshot's clock covers ~11% of the
        # viewport (dial radius ~137px at 800 + bells/handle). Without it
        # the NCC surface has degenerate attractors: an extreme-zoom
        # silhouette is a big smooth bright blob that correlates with the
        # room's bright walls no matter the pose.
        area = float((m > 0).mean())
        if not 0.09 <= area <= 0.155:
            return -1e9, 0, 0
        s, dy, dx = ncc_match(m[MARGIN:roi, MARGIN:RES - MARGIN], gold_small)
        return s, dy - MARGIN, dx - MARGIN

    # bounds from direct measurement of the screenshot's dial ellipse
    # (center ~(400,396), rx~137, ry~124 at 800px): vertical foreshortening
    # ry/rx = 0.905 -> ~25 deg tilt above the dial normal; horizontal
    # symmetry -> yaw near face-on; rx + 90 deg fov -> dial-center distance
    # ~1.1-1.3 -> orbit radius ~1.45-1.85
    coarse = list(itertools.product(
        np.arange(-18, 19, 4.0),
        np.arange(12, 35, 4.0),
        np.arange(1.45, 1.86, 0.08)))
    best = (-1e9, None)
    for y, p, r in coarse:
        s, dy, dx = score(y, p, r)
        if s > best[0]:
            best = (s, (y, p, r, dy, dx))
            print(f"coarse {s:.4f} yaw={y} pitch={p} r={r:.2f} "
                  f"off=({dy},{dx})", file=sys.stderr)

    steps = [(4.0, 4.0, 0.08), (1.5, 1.5, 0.03), (0.5, 0.5, 0.01)]
    for sy, sp, sr in steps:
        _, (y0, p0, r0, _, _) = best
        for y, p, r in itertools.product(
                np.arange(y0 - 2 * sy, y0 + 2 * sy + 1e-6, sy),
                np.arange(p0 - 2 * sp, p0 + 2 * sp + 1e-6, sp),
                np.arange(max(r0 - 2 * sr, 0.3), r0 + 2 * sr + 1e-6, sr)):
            s, dy, dx = score(y, p, r)
            if s > best[0]:
                best = (s, (y, p, r, dy, dx))
                print(f"refine {s:.4f} yaw={y:.1f} pitch={p:.1f} r={r:.2f} "
                      f"off=({dy},{dx})", file=sys.stderr)

    s, (y, p, r, dy, dx) = best
    out = {"yaw": round(float(y), 2), "pitch": round(float(p), 2),
           "radius": round(float(r), 3),
           "dy": dy * k, "dx": dx * k, "score": round(s, 4), "fit_res": RES}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
