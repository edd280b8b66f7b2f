"""Disney ("principled") BRDF: evaluation, pdf, and lobe sampling.

Standard Burley 2012 model, same lobe set the reference evaluates
(path_tracing.frag:620-669: diffuse + Fd90 retro, subsurface mix, sheen,
GTR2 isotropic specular with Smith-GGX, GTR1 clearcoat) and the same
lobe-probability sampling (diffuse ~ 1-metallic, specular ~ 1,
clearcoat ~ 0.25*clearcoat — path_tracing.frag:753-784) and mixed pdf
(path_tracing.frag:837-874). Vectorized over arbitrary batch shapes and
fully differentiable w.r.t. material parameters.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array
PI = np.float32(np.pi)


class ShadeMaterial(NamedTuple):
    """Per-hit resolved material (textures already applied)."""

    emissive: Array      # (..., 3)
    base_color: Array    # (..., 3)
    subsurface: Array    # (...)
    metallic: Array
    specular: Array
    specular_tint: Array
    roughness: Array
    sheen: Array
    sheen_tint: Array
    clearcoat: Array
    clearcoat_gloss: Array
    anisotropic: Array = 0.0


def safe_normalize(v: Array, eps: float = 1e-20) -> Array:
    """Normalize without the 0*inf NaN-gradient trap of norm() at zero:
    sqrt is evaluated on a clamped sum-of-squares, so its vjp stays finite."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps))


def schlick_fresnel(u: Array) -> Array:
    m = jnp.clip(1.0 - u, 0.0, 1.0)
    return (m * m) * (m * m) * m


def gtr1(ndoth: Array, a: Array) -> Array:
    a = jnp.asarray(a)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    val = (a2 - 1.0) / (PI * jnp.log(jnp.maximum(a2, 1e-8)) * t)
    return jnp.where(a >= 1.0, 1.0 / PI, val)


def gtr2(ndoth: Array, a: Array) -> Array:
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    return a2 / (PI * t * t)


def smith_g_ggx(ndotv: Array, alpha_g: Array) -> Array:
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / (ndotv + jnp.sqrt(jnp.maximum(a + b - a * b, 0.0)))


def gtr2_aniso(ndoth: Array, hdotx: Array, hdoty: Array,
               ax: Array, ay: Array) -> Array:
    """Anisotropic GTR2 (path_tracing.frag:543-545)."""
    t = (hdotx / ax) ** 2 + (hdoty / ay) ** 2 + ndoth * ndoth
    return 1.0 / (PI * ax * ay * jnp.maximum(t * t, 1e-12))


def smith_g_ggx_aniso(ndotv: Array, vdotx: Array, vdoty: Array,
                      ax: Array, ay: Array) -> Array:
    """Anisotropic Smith-GGX shadowing (path_tracing.frag:553-555)."""
    t = (vdotx * ax) ** 2 + (vdoty * ay) ** 2 + ndotv * ndotv
    return 1.0 / jnp.maximum(ndotv + jnp.sqrt(jnp.maximum(t, 0.0)), 1e-8)


def aniso_alphas(mat: ShadeMaterial) -> tuple[Array, Array]:
    """Disney aspect-ratio roughness split (path_tracing.frag:584-586)."""
    aspect = jnp.sqrt(jnp.maximum(1.0 - mat.anisotropic * 0.9, 1e-6))
    r2 = mat.roughness * mat.roughness
    ax = jnp.maximum(0.001, r2 / aspect)
    ay = jnp.maximum(0.001, r2 * aspect)
    return ax, ay


def _colors(mat: ShadeMaterial):
    cdlin = mat.base_color
    cdlum = (0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2])
    ctint = jnp.where(cdlum[..., None] > 0, cdlin / jnp.maximum(cdlum[..., None], 1e-12), 1.0)
    cspec = mat.specular[..., None] * (
        (1.0 - mat.specular_tint[..., None]) + mat.specular_tint[..., None] * ctint)
    cspec0 = (0.08 * cspec * (1.0 - mat.metallic[..., None])
              + cdlin * mat.metallic[..., None])
    csheen = (1.0 - mat.sheen_tint[..., None]) + mat.sheen_tint[..., None] * ctint
    return cdlin, cspec0, csheen


def evaluate(v: Array, n: Array, l: Array, mat: ShadeMaterial,
             frame: tuple[Array, Array] | None = None) -> Array:
    """f_r(V, L). Zero when either direction is under the shading normal.

    v: toward viewer; l: toward light; n: shading normal. All unit (..., 3).
    frame=(tangent, bitangent) switches lanes with mat.anisotropic > 0 to
    the anisotropic specular path (see precompute_view).
    """
    if frame is not None:
        f, _ = _eval_core(precompute_view(v, n, mat, frame), v, n, l, mat,
                          want_pdf=False)
        return f
    ndotl = jnp.sum(n * l, axis=-1)
    ndotv = jnp.sum(n * v, axis=-1)
    valid = (ndotl >= 0) & (ndotv >= 0)
    # clamp the internal cosines: invalid lanes are masked at the end, but
    # an inf/NaN produced on them (smith G at ndotl<=-sqrt(a)) would poison
    # the backward pass through the final where
    ndotl = jnp.maximum(ndotl, 1e-6)
    ndotv = jnp.maximum(ndotv, 1e-6)

    h = safe_normalize(l + v)
    ndoth = jnp.sum(n * h, axis=-1)
    ldoth = jnp.sum(l * h, axis=-1)

    cdlin, cspec0, csheen = _colors(mat)

    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fl = schlick_fresnel(ndotl)
    fv = schlick_fresnel(ndotv)
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)

    fss90 = ldoth * ldoth * mat.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = jnp.maximum(ndotl + ndotv, 1e-8)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)

    alpha = jnp.maximum(0.001, mat.roughness * mat.roughness)
    ds = gtr2(ndoth, alpha)
    fh = schlick_fresnel(ldoth)
    fs = cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    gs = smith_g_ggx(ndotl, mat.roughness) * smith_g_ggx(ndotv, mat.roughness)

    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = smith_g_ggx(ndotl, 0.25) * smith_g_ggx(ndotv, 0.25)

    fsheen = fh[..., None] * mat.sheen[..., None] * csheen

    diffuse_scalar = (1.0 / PI) * (fd + (ss - fd) * mat.subsurface)
    diffuse = diffuse_scalar[..., None] * cdlin + fsheen
    specular = (gs * ds)[..., None] * fs
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat)[..., None]

    f = diffuse * (1.0 - mat.metallic[..., None]) + specular + clearcoat
    return jnp.where(valid[..., None], f, 0.0)


def evaluate_aniso(v: Array, n: Array, l: Array, x: Array, y: Array,
                   mat: ShadeMaterial) -> Array:
    """Anisotropic f_r(V, L) with tangent frame (x, y).

    The reference carries this variant as dead code (BRDF_Evaluate_aniso,
    path_tracing.frag:557-618, aniso branch commented at :583-593); here it
    is live: GTR2_aniso specular with aspect-split alphas and anisotropic
    Smith-GGX, identical diffuse/sheen/clearcoat terms. The integrator
    selects this math per-lane whenever mat.anisotropic > 0 and the scene
    enables the path (RenderConfig.enable_aniso, resolved automatically
    from the material table) — evaluate()/evaluate_pdf()/sample() take a
    `frame` argument and route through the same formulas (_eval_core), so
    this standalone form is the oracle the integrator path is tested
    against. Reduces to evaluate() when mat.anisotropic == 0 up to the
    Smith-G alpha convention (reference isotropic G uses roughness, not
    roughness^2 — kept faithfully in both paths)."""
    ndotl = jnp.sum(n * l, axis=-1)
    ndotv = jnp.sum(n * v, axis=-1)
    valid = (ndotl >= 0) & (ndotv >= 0)
    ndotl = jnp.maximum(ndotl, 1e-6)
    ndotv = jnp.maximum(ndotv, 1e-6)

    h = safe_normalize(l + v)
    ndoth = jnp.sum(n * h, axis=-1)
    ldoth = jnp.sum(l * h, axis=-1)

    cdlin, cspec0, csheen = _colors(mat)

    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fl = schlick_fresnel(ndotl)
    fv = schlick_fresnel(ndotv)
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * mat.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = jnp.maximum(ndotl + ndotv, 1e-8)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)

    ax, ay = aniso_alphas(mat)
    ds = gtr2_aniso(ndoth, jnp.sum(h * x, axis=-1), jnp.sum(h * y, axis=-1), ax, ay)
    fh = schlick_fresnel(ldoth)
    fs = cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    gs = (smith_g_ggx_aniso(ndotl, jnp.sum(l * x, axis=-1), jnp.sum(l * y, axis=-1), ax, ay)
          * smith_g_ggx_aniso(ndotv, jnp.sum(v * x, axis=-1), jnp.sum(v * y, axis=-1), ax, ay))

    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = smith_g_ggx(ndotl, 0.25) * smith_g_ggx(ndotv, 0.25)

    fsheen = fh[..., None] * mat.sheen[..., None] * csheen
    diffuse_scalar = (1.0 / PI) * (fd + (ss - fd) * mat.subsurface)
    diffuse = diffuse_scalar[..., None] * cdlin + fsheen
    specular = (gs * ds)[..., None] * fs
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat)[..., None]

    f = diffuse * (1.0 - mat.metallic[..., None]) + specular + clearcoat
    return jnp.where(valid[..., None], f, 0.0)


def _lobe_probs(mat: ShadeMaterial):
    r_diffuse = 1.0 - mat.metallic
    r_specular = jnp.ones_like(mat.metallic)
    r_clearcoat = 0.25 * mat.clearcoat
    r_sum = r_diffuse + r_specular + r_clearcoat
    return r_diffuse / r_sum, r_specular / r_sum, r_clearcoat / r_sum


def pdf(v: Array, n: Array, l: Array, mat: ShadeMaterial,
        frame: tuple[Array, Array] | None = None) -> Array:
    """Mixed sampling pdf of direction l (path_tracing.frag:837-874).

    frame=(tangent, bitangent) switches lanes with mat.anisotropic > 0 to
    the anisotropic specular density (see precompute_view)."""
    if frame is not None:
        _, p = _eval_core(precompute_view(v, n, mat, frame), v, n, l, mat,
                          want_pdf=True)
        return p
    ndotl = jnp.sum(n * l, axis=-1)
    ndotv = jnp.sum(n * v, axis=-1)
    valid = (ndotl >= 0) & (ndotv >= 0)
    ndotl = jnp.maximum(ndotl, 1e-6)  # see evaluate(): keep masked lanes finite

    h = safe_normalize(l + v)
    ndoth = jnp.sum(n * h, axis=-1)
    ldoth = jnp.sum(l * h, axis=-1)

    alpha = jnp.maximum(0.001, mat.roughness * mat.roughness)
    ds = gtr2(ndoth, alpha)
    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)

    pdf_diffuse = ndotl / PI
    safe_ldoth = jnp.where(jnp.abs(ldoth) < 1e-8, 1e-8, ldoth)
    pdf_specular = ds * ndoth / (4.0 * safe_ldoth)
    pdf_clearcoat = dr * ndoth / (4.0 * safe_ldoth)

    p_d, p_s, p_c = _lobe_probs(mat)
    p = p_d * pdf_diffuse + p_s * pdf_specular + p_c * pdf_clearcoat
    return jnp.where(valid, jnp.maximum(p, 1e-10), 0.0)


def evaluate_pdf(v: Array, n: Array, l: Array, mat: ShadeMaterial,
                 frame: tuple[Array, Array] | None = None
                 ) -> tuple[Array, Array]:
    """(f_r, pdf) of one direction, sharing every common subexpression.

    evaluate() and pdf() both build h/ndoth/ldoth and the GTR2/GTR1
    densities; the integrator needs both for the sampled bounce direction
    every bounce, so this fused form halves that work and keeps the traced
    graph smaller than two separate calls.

    frame=(tangent, bitangent) switches lanes with mat.anisotropic > 0 to
    the anisotropic specular path (see precompute_view)."""
    if frame is not None:
        return _eval_core(precompute_view(v, n, mat, frame), v, n, l, mat,
                          want_pdf=True)
    ndotl = jnp.sum(n * l, axis=-1)
    ndotv = jnp.sum(n * v, axis=-1)
    valid = (ndotl >= 0) & (ndotv >= 0)
    ndotl = jnp.maximum(ndotl, 1e-6)
    ndotv = jnp.maximum(ndotv, 1e-6)

    h = safe_normalize(l + v)
    ndoth = jnp.sum(n * h, axis=-1)
    ldoth = jnp.sum(l * h, axis=-1)

    cdlin, cspec0, csheen = _colors(mat)

    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fl = schlick_fresnel(ndotl)
    fv = schlick_fresnel(ndotv)
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * mat.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = jnp.maximum(ndotl + ndotv, 1e-8)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)

    alpha = jnp.maximum(0.001, mat.roughness * mat.roughness)
    ds = gtr2(ndoth, alpha)
    fh = schlick_fresnel(ldoth)
    fs = cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    gs = smith_g_ggx(ndotl, mat.roughness) * smith_g_ggx(ndotv, mat.roughness)

    dr = gtr1(ndoth, 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss)
    fr = 0.04 + 0.96 * fh
    gr = smith_g_ggx(ndotl, 0.25) * smith_g_ggx(ndotv, 0.25)

    fsheen = fh[..., None] * mat.sheen[..., None] * csheen
    diffuse_scalar = (1.0 / PI) * (fd + (ss - fd) * mat.subsurface)
    diffuse = diffuse_scalar[..., None] * cdlin + fsheen
    specular = (gs * ds)[..., None] * fs
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat)[..., None]
    f = diffuse * (1.0 - mat.metallic[..., None]) + specular + clearcoat
    f = jnp.where(valid[..., None], f, 0.0)

    pdf_diffuse = ndotl / PI
    safe_ldoth = jnp.where(jnp.abs(ldoth) < 1e-8, 1e-8, ldoth)
    pdf_specular = ds * ndoth / (4.0 * safe_ldoth)
    pdf_clearcoat = dr * ndoth / (4.0 * safe_ldoth)
    p_d, p_s, p_c = _lobe_probs(mat)
    p = p_d * pdf_diffuse + p_s * pdf_specular + p_c * pdf_clearcoat
    p = jnp.where(valid, jnp.maximum(p, 1e-10), 0.0)
    return f, p


def build_onb(n: Array) -> tuple[Array, Array]:
    """Orthonormal basis around n (path_tracing.frag:681-687 convention)."""
    helper = jnp.where(
        (jnp.abs(n[..., 0]) > 0.999)[..., None],
        jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], n.dtype), n.shape),
        jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0], n.dtype), n.shape))
    tangent = safe_normalize(jnp.cross(n, helper))
    bitangent = safe_normalize(jnp.cross(n, tangent))
    return tangent, bitangent


def to_normal_hemisphere(v_local: Array, n: Array) -> Array:
    tangent, bitangent = build_onb(n)
    return (v_local[..., 0:1] * tangent + v_local[..., 1:2] * bitangent
            + v_local[..., 2:3] * n)


def sample_cosine_hemisphere(xi1: Array, xi2: Array, n: Array) -> Array:
    r = jnp.sqrt(xi1)
    theta = xi2 * 2.0 * PI
    x = r * jnp.cos(theta)
    y = r * jnp.sin(theta)
    z = jnp.sqrt(jnp.maximum(1.0 - x * x - y * y, 0.0))
    return to_normal_hemisphere(jnp.stack([x, y, z], axis=-1), n)


def _reflect(v: Array, h: Array) -> Array:
    return v - 2.0 * jnp.sum(v * h, axis=-1, keepdims=True) * h


def _sqrt0(x: Array) -> Array:
    """sqrt of a clamped-nonnegative value with a zero (not 0 * inf = NaN)
    gradient where the value is 0."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def sample_gtr2(xi1: Array, xi2: Array, v: Array, n: Array, alpha: Array) -> Array:
    phi = 2.0 * PI * xi1
    ct = _sqrt0(jnp.clip((1.0 - xi2) / (1.0 + (alpha * alpha - 1.0) * xi2), 0.0, 1.0))
    st = _sqrt0(jnp.maximum(0.0, 1.0 - ct * ct))
    h = to_normal_hemisphere(
        jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1), n)
    return _reflect(-v, h)


def sample_gtr2_aniso(xi1: Array, xi2: Array, v: Array, n: Array,
                      ax: Array, ay: Array, x: Array, y: Array) -> Array:
    """Sample the anisotropic GTR2 half-vector distribution (h ~ D(h)|h.n|,
    the standard Disney-BRDF-explorer transform) and reflect.

    The sampled-h density matches gtr2_aniso * ndoth, so the mixed pdf in
    _eval_core (which switches ds to gtr2_aniso on aniso lanes) stays
    consistent with this sampler."""
    phi = 2.0 * PI * xi1
    t = jnp.sqrt(xi2 / jnp.maximum(1.0 - xi2, 1e-8))
    h = (t * ax * jnp.cos(phi))[..., None] * x \
        + (t * ay * jnp.sin(phi))[..., None] * y + n
    h = safe_normalize(h)
    return _reflect(-v, h)


def sample_gtr1(xi1: Array, xi2: Array, v: Array, n: Array, alpha: Array) -> Array:
    phi = 2.0 * PI * xi1
    a2 = alpha * alpha
    ct = _sqrt0(jnp.clip((1.0 - jnp.power(a2, 1.0 - xi2)) / jnp.maximum(1.0 - a2, 1e-8), 0.0, 1.0))
    st = _sqrt0(jnp.maximum(0.0, 1.0 - ct * ct))
    h = to_normal_hemisphere(
        jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1), n)
    return _reflect(-v, h)


def sample(xi1: Array, xi2: Array, xi3: Array, v: Array, n: Array,
           mat: ShadeMaterial,
           frame: tuple[Array, Array] | None = None) -> Array:
    """Pick a lobe by radiance share (xi3) and sample it (xi1, xi2).

    frame=(tangent, bitangent): lanes with mat.anisotropic > 0 draw their
    specular lobe from the anisotropic GTR2 sampler instead (same frame the
    evaluator uses). None = isotropic fast path."""
    alpha_gtr1 = 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss
    alpha_gtr2 = jnp.maximum(0.001, mat.roughness * mat.roughness)
    p_d, p_s, _ = _lobe_probs(mat)

    l_diffuse = sample_cosine_hemisphere(xi1, xi2, n)
    l_specular = sample_gtr2(xi1, xi2, v, n, alpha_gtr2)
    l_clearcoat = sample_gtr1(xi1, xi2, v, n, alpha_gtr1)
    if frame is not None:
        fx, fy = frame
        ax, ay = aniso_alphas(mat)
        l_spec_a = sample_gtr2_aniso(xi1, xi2, v, n, ax, ay, fx, fy)
        l_specular = jnp.where((mat.anisotropic > 0.0)[..., None],
                               l_spec_a, l_specular)

    use_d = (xi3 <= p_d)[..., None]
    use_s = ((xi3 > p_d) & (xi3 <= p_d + p_s))[..., None]
    return jnp.where(use_d, l_diffuse, jnp.where(use_s, l_specular, l_clearcoat))


class ViewPre(NamedTuple):
    """L-independent precompute shared by every BSDF evaluation at one
    shading point (the integrator evaluates f_r for 3 directions per
    bounce: envmap NEE, point NEE, sampled bounce — path_tracing.frag:948-968
    re-derives all of this per call; the whole frame is one fused XLA
    graph, so sharing it only keeps the graph smaller)."""

    ndotv: Array
    fv: Array            # schlick_fresnel(ndotv)
    cdlin: Array
    cspec0: Array
    csheen: Array
    alpha: Array         # GTR2 roughness^2 (clamped)
    alpha_cc: Array      # GTR1 clearcoat alpha
    gs_v: Array          # smith_g_ggx(ndotv, roughness)
    gr_v: Array          # smith_g_ggx(ndotv, 0.25)
    p_d: Array           # lobe probabilities
    p_s: Array
    p_c: Array
    # anisotropic specular path (set only when a tangent frame was given —
    # None keeps the isotropic fast path with zero extra ops)
    fx: Array | None = None   # tangent
    fy: Array | None = None   # bitangent
    ax: Array | None = None   # aspect-split alphas (aniso_alphas)
    ay: Array | None = None
    gs_v_aniso: Array | None = None  # smith_g_ggx_aniso(ndotv, v.x, v.y)


def precompute_view(v: Array, n: Array, mat: ShadeMaterial,
                    frame: tuple[Array, Array] | None = None) -> ViewPre:
    """frame=(tangent, bitangent): enables the per-lane anisotropic
    specular path for lanes with mat.anisotropic > 0 (GTR2_aniso +
    anisotropic Smith-GGX, path_tracing.frag:543-555,594-602). frame=None
    is the isotropic fast path — callers gate on a static flag so scenes
    whose anisotropic column is all zero pay nothing."""
    ndotv = jnp.sum(n * v, axis=-1)
    ndotv_c = jnp.maximum(ndotv, 1e-6)
    cdlin, cspec0, csheen = _colors(mat)
    alpha = jnp.maximum(0.001, mat.roughness * mat.roughness)
    alpha_cc = 0.1 + (0.001 - 0.1) * mat.clearcoat_gloss
    p_d, p_s, p_c = _lobe_probs(mat)
    pre = ViewPre(
        ndotv=ndotv, fv=schlick_fresnel(ndotv_c), cdlin=cdlin,
        cspec0=cspec0, csheen=csheen, alpha=alpha, alpha_cc=alpha_cc,
        gs_v=smith_g_ggx(ndotv_c, mat.roughness),
        gr_v=smith_g_ggx(ndotv_c, 0.25), p_d=p_d, p_s=p_s, p_c=p_c)
    if frame is not None:
        fx, fy = frame
        ax, ay = aniso_alphas(mat)
        pre = pre._replace(
            fx=fx, fy=fy, ax=ax, ay=ay,
            gs_v_aniso=smith_g_ggx_aniso(
                ndotv_c, jnp.sum(v * fx, axis=-1),
                jnp.sum(v * fy, axis=-1), ax, ay))
    return pre


def _eval_core(pre: ViewPre, v: Array, n: Array, l: Array,
               mat: ShadeMaterial, want_pdf: bool):
    ndotl = jnp.sum(n * l, axis=-1)
    valid = (ndotl >= 0) & (pre.ndotv >= 0)
    ndotl = jnp.maximum(ndotl, 1e-6)
    ndotv = jnp.maximum(pre.ndotv, 1e-6)

    h = safe_normalize(l + v)
    ndoth = jnp.sum(n * h, axis=-1)
    ldoth = jnp.sum(l * h, axis=-1)

    fd90 = 0.5 + 2.0 * ldoth * ldoth * mat.roughness
    fl = schlick_fresnel(ndotl)
    fv = pre.fv
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * mat.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    denom = jnp.maximum(ndotl + ndotv, 1e-8)
    ss = 1.25 * (fss * (1.0 / denom - 0.5) + 0.5)

    ds = gtr2(ndoth, pre.alpha)
    fh = schlick_fresnel(ldoth)
    fs = pre.cspec0 * (1.0 - fh[..., None]) + fh[..., None]
    gs = smith_g_ggx(ndotl, mat.roughness) * pre.gs_v
    if pre.fx is not None:
        # per-lane anisotropic specular (BRDF_Evaluate_aniso,
        # path_tracing.frag:557-618): lanes with anisotropic == 0 keep the
        # reference's isotropic math exactly (incl. its roughness-not-
        # roughness^2 Smith-G convention), so wiring this in changes
        # nothing for isotropic scenes
        am = mat.anisotropic > 0.0
        ds_a = gtr2_aniso(ndoth, jnp.sum(h * pre.fx, axis=-1),
                          jnp.sum(h * pre.fy, axis=-1), pre.ax, pre.ay)
        gs_a = smith_g_ggx_aniso(
            ndotl, jnp.sum(l * pre.fx, axis=-1),
            jnp.sum(l * pre.fy, axis=-1), pre.ax, pre.ay) * pre.gs_v_aniso
        ds = jnp.where(am, ds_a, ds)
        gs = jnp.where(am, gs_a, gs)

    dr = gtr1(ndoth, pre.alpha_cc)
    fr = 0.04 + 0.96 * fh
    gr = smith_g_ggx(ndotl, 0.25) * pre.gr_v

    fsheen = fh[..., None] * mat.sheen[..., None] * pre.csheen
    diffuse_scalar = (1.0 / PI) * (fd + (ss - fd) * mat.subsurface)
    diffuse = diffuse_scalar[..., None] * pre.cdlin + fsheen
    specular = (gs * ds)[..., None] * fs
    clearcoat = (0.25 * gr * fr * dr * mat.clearcoat)[..., None]
    f = diffuse * (1.0 - mat.metallic[..., None]) + specular + clearcoat
    f = jnp.where(valid[..., None], f, 0.0)
    if not want_pdf:
        return f, None

    pdf_diffuse = ndotl / PI
    safe_ldoth = jnp.where(jnp.abs(ldoth) < 1e-8, 1e-8, ldoth)
    pdf_specular = ds * ndoth / (4.0 * safe_ldoth)
    pdf_clearcoat = dr * ndoth / (4.0 * safe_ldoth)
    p = (pre.p_d * pdf_diffuse + pre.p_s * pdf_specular
         + pre.p_c * pdf_clearcoat)
    p = jnp.where(valid, jnp.maximum(p, 1e-10), 0.0)
    return f, p


def evaluate_pre(pre: ViewPre, v: Array, n: Array, l: Array,
                 mat: ShadeMaterial) -> Array:
    """evaluate() with the view-dependent terms shared (exact same math)."""
    f, _ = _eval_core(pre, v, n, l, mat, want_pdf=False)
    return f


def evaluate_pdf_pre(pre: ViewPre, v: Array, n: Array, l: Array,
                     mat: ShadeMaterial) -> tuple[Array, Array]:
    """evaluate_pdf() with the view-dependent terms shared."""
    f, p = _eval_core(pre, v, n, l, mat, want_pdf=True)
    return f, p
