"""The path-tracing integrator: 1spp progressive tracing with NEE.

Re-derivation of the reference megakernel's light transport
(path_tracing.frag:948-1128) as pure differentiable jnp over ray wavefronts:

  per bounce: nearest-hit traversal (non-differentiable topology) ->
  differentiable hit resolution (re-gather triangle/material by index) ->
  BSDF sampling (Sobol + Cranley-Patterson + Wang-hash stream, matching the
  reference's draw order) -> shade() combining envmap NEE, point-light NEE
  and BSDF emissive hits with pdf-proportional weights
  (path_tracing.frag:960-967) -> throughput update.

Gradients flow to MaterialTable rows, PointLights radiance/position and the
envmap image; hit topology (triangle indices, traversal t) is stopped.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.integrator import disney
from tpuray.integrator.disney import ShadeMaterial, safe_normalize
from tpuray.integrator.gather_tables import (
    PackedScene, fetch_material, fetch_tri, pack_scene_tables,
    tex_fetch_packed)
from tpuray.integrator.intersect import INF, barycentrics
from tpuray.integrator.intersect import trace as trace_xla
from tpuray.sampling import envmap as env
from tpuray.sampling import rng
from tpuray.scene.config import RenderConfig
from tpuray.scene.types import Scene
from tpuray.utils.platform import platform

Array = jax.Array
PI = np.float32(np.pi)
EPS = np.float32(1e-6)

def trace(bvh, tri, orig, d, t_max=INF, any_hit=False):
    """Nearest-hit (or any-hit) traversal on the platform's path: the BVH
    kernel (kernels/trace_triton.py) on a GPU, the XLA wavefront
    (intersect.trace) on the CPU, where it is also the tests' oracle."""
    if platform() == "gpu":
        from tpuray.kernels.trace_triton import trace_triton
        return trace_triton(bvh, tri, orig, d, t_max=t_max, any_hit=any_hit)
    return trace_xla(bvh, tri, orig, d, t_max=t_max, any_hit=any_hit)


def resolve_aniso(scene: Scene, cfg: RenderConfig) -> bool:
    """Static resolution of RenderConfig.enable_aniso ("auto" -> whether the
    material table has any anisotropic > 0 row). Must run on CONCRETE
    materials: under jit the data is unknowable and "auto" degrades to the
    isotropic fast path — the Renderer resolves it at construction, before
    compiling; direct render_frame callers with anisotropic scenes should
    pass enable_aniso=True (or pre-resolve with this helper)."""
    ea = cfg.enable_aniso
    if ea != "auto":
        return bool(ea)
    arr = scene.materials.anisotropic
    if isinstance(arr, jax.core.Tracer):
        return False
    return bool(np.any(np.asarray(arr) > 0.0))


class Hit(NamedTuple):
    valid: Array      # (N,) bool
    point: Array      # (N, 3)
    normal: Array     # (N, 3) shading normal (flipped toward ray origin side)
    geo_normal: Array  # (N, 3) flipped geometric normal
    inside: Array     # (N,) bool
    uv: Array         # (N, 2)
    mat: ShadeMaterial
    tri_idx: Array    # (N,) int32
    t: Array          # (N,)


def _tex_fetch(scene: Scene, obj_id: Array, layer: int, uv: Array) -> Array:
    """Bilinear fetch from the per-object texture stack (layer 0..3)."""
    tex = scene.textures.data  # (O, 4, H, W, 3)
    o, _, h, w, _ = tex.shape
    u = jnp.clip(uv[..., 0], 0.0, 1.0)
    v = jnp.clip(1.0 - uv[..., 1], 0.0, 1.0)  # GL images are y-up
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)
    obj = jnp.clip(obj_id, 0, o - 1)
    c00 = tex[obj, layer, y0i, x0i]
    c10 = tex[obj, layer, y0i, x1i]
    c01 = tex[obj, layer, y1i, x0i]
    c11 = tex[obj, layer, y1i, x1i]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def resolve_hit(scene: Scene, orig: Array, d: Array, t: Array, idx: Array,
                cfg: RenderConfig, pk: PackedScene | None = None) -> Hit:
    """Differentiable hit resolution from (t, triangle index) topology.

    Equivalent of hitArray's material/normal resolution
    (path_tracing.frag:298-369): smooth normal from barycentric vertex
    normals, texture-driven material via the negative-value sentinel,
    optional normal mapping through the per-triangle TBN. All lookups go
    through single-wide-gather tables (gather_tables): one 128B gather
    instead of fifteen 4B ones.
    """
    if pk is None:
        pk = pack_scene_tables(scene)
    valid = idx >= 0
    i = jnp.maximum(idx, 0)
    t = jax.lax.stop_gradient(jnp.where(valid, t, 1.0))

    tri = fetch_tri(pk.tri_table, i)  # ONE gather for all attributes
    p0, p1, p2 = tri.p0, tri.p1, tri.p2
    point = orig + d * t[..., None]

    ng = safe_normalize(jnp.cross(p1 - p0, p2 - p0), eps=1e-30)
    inside = jnp.sum(ng * d, axis=-1) > 0.0
    ng_f = jnp.where(inside[..., None], -ng, ng)

    a, b, c = barycentrics(point, p0, p1, p2, cfg.reference_quirks)
    ns = (a[..., None] * tri.n0 + b[..., None] * tri.n1 + c[..., None] * tri.n2)
    ns = safe_normalize(ns, eps=1e-30)
    ns = jnp.where(inside[..., None], -ns, ns)

    uv = (a[..., None] * tri.uv0 + b[..., None] * tri.uv1 + c[..., None] * tri.uv2)

    mat = fetch_material(pk.mat_table, tri.mat_id)  # one gather
    if pk.tex_q is not None:
        obj = jnp.clip(tri.obj_id, 0, pk.tex_q.shape[0] - 1)
        tu = jnp.clip(uv[..., 0], 0.0, 1.0)
        tv = jnp.clip(1.0 - uv[..., 1], 0.0, 1.0)  # GL images are y-up
        texel = tex_fetch_packed(pk.tex_q, obj, tu, tv)  # one gather
        tex_albedo = texel[..., 0:3]
        tex_metallic = texel[..., 3]
        tex_rough = texel[..., 4]
        base_neg = jnp.any(mat.base_color < 0.0, axis=-1, keepdims=True)
        mat = mat._replace(
            base_color=jnp.where(base_neg, tex_albedo, mat.base_color),
            metallic=jnp.where(mat.metallic < 0.0, tex_metallic, mat.metallic),
            roughness=jnp.where(mat.roughness < 0.0, tex_rough, mat.roughness),
        )
        if cfg.use_normal_map:
            e1 = p1 - p0
            e2 = p2 - p0
            duv1 = tri.uv1 - tri.uv0
            duv2 = tri.uv2 - tri.uv0
            det = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
            f = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
            tangent = f[..., None] * (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2)
            tangent = safe_normalize(tangent)
            bitangent = jnp.cross(tangent, ns)
            tex_n = _tex_fetch(scene, tri.obj_id, 2, uv) * 2.0 - 1.0
            tex_n = safe_normalize(tex_n)
            mapped = (tex_n[..., 0:1] * tangent + tex_n[..., 1:2] * bitangent
                      + tex_n[..., 2:3] * ns)
            ns = safe_normalize(mapped)
    else:
        # sentinel without textures: clamp so shading stays sane
        mat = mat._replace(
            base_color=jnp.abs(mat.base_color),
            metallic=jnp.abs(mat.metallic),
            roughness=jnp.abs(mat.roughness),
        )

    return Hit(valid=valid, point=point, normal=ns, geo_normal=ng_f,
               inside=inside, uv=uv, mat=mat, tri_idx=idx, t=t)


def _env_nee(scene: Scene, pk: PackedScene, hit: Hit, v: Array,
             r1: Array, r2: Array, active: Array | None = None,
             pre: "disney.ViewPre | None" = None) -> tuple[Array, Array]:
    """Envmap NEE (hdriLight, path_tracing.frag:787-799, 922-946) with its
    own any-hit shadow trace. Returns (contribution, pdf).

    (direction, radiance, pdf) come from ONE row gather of the precomputed
    NEE table (sampling.envmap.pack_env_nee_table) instead of three separate
    cache/image/cache gathers."""
    l, radiance, p = env.sample_env_nee(pk.env_nee_t, r1, r2)
    # dead lanes (terminated paths / sky pixels) get t_max = 0: traversal
    # treats them as inert, so they finish their walk at once. Their
    # outputs are garbage but every consumer below re-masks.
    s_tmax = INF if active is None else jnp.where(active, INF, 0.0)
    _, sidx = trace(scene.bvh, scene.triangles, hit.point, l, t_max=s_tmax,
                    any_hit=True)
    blocked = sidx >= 0
    f_r = (disney.evaluate_pre(pre, v, hit.normal, l, hit.mat)
           if pre is not None else disney.evaluate(v, hit.normal, l, hit.mat))
    p = jnp.where(blocked, 0.0, p)
    # divisor must stay finite on blocked lanes: an inf in the unselected
    # where-branch turns into 0*inf = NaN in the backward pass
    p_safe = jnp.where(blocked, 1.0, jnp.maximum(p, 1e-12))
    contrib = (f_r * jnp.abs(jnp.sum(l * hit.normal, axis=-1))[..., None]
               * radiance / p_safe[..., None])
    contrib = jnp.where(blocked[..., None], 0.0, contrib)
    return contrib, p


def _point_nee(scene: Scene, pk: PackedScene, hit: Hit, v: Array, u: Array,
               active: Array | None = None,
               pre: "disney.ViewPre | None" = None) -> tuple[Array, Array]:
    """Point-light NEE (calculatePointLight, path_tracing.frag:884-919) with
    its own any-hit shadow trace: uniform light pick, pdf = 2*pi/n_lights,
    quadratic falloff. Returns (contribution, pdf)."""
    n_lights = scene.lights.count
    if n_lights == 0:
        z = jnp.zeros(hit.point.shape, jnp.float32)
        return z, jnp.zeros(hit.point.shape[:-1], jnp.float32)
    li = jnp.minimum((u * n_lights).astype(jnp.int32), n_lights - 1)
    from tpuray.integrator.gather_tables import fetch_small_table
    lrow = fetch_small_table(pk.light_table, li)  # select-chain, no gather
    lpos = lrow[..., 0:3]
    lrad = lrow[..., 3:6]
    delta = lpos - hit.point
    dist = jnp.sqrt(jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-24))
    ldir = delta / dist[..., None]
    s_tmax = dist if active is None else jnp.where(active, dist, 0.0)
    _, sidx = trace(scene.bvh, scene.triangles, hit.point, ldir,
                    t_max=s_tmax, any_hit=True)
    pdf = jnp.full(dist.shape, 2.0 * PI / n_lights, jnp.float32)
    falloff = lrad / jnp.maximum(dist * dist, 1e-12)[..., None]
    f_r = (disney.evaluate_pre(pre, v, hit.normal, ldir, hit.mat)
           if pre is not None else disney.evaluate(v, hit.normal, ldir,
                                                   hit.mat))
    contrib = (falloff * f_r
               * jnp.abs(jnp.sum(ldir * hit.normal, axis=-1))[..., None] / pdf[..., None])
    contrib = jnp.where((sidx >= 0)[..., None], 0.0, contrib)
    return contrib, pdf


class PTOutput(NamedTuple):
    color: Array     # (N, 3) per-ray radiance (1 spp)
    emission: Array  # (N, 3) first-hit emissive
    albedo: Array    # (N, 3) first-hit base color (texture-resolved)
    first_hit_t: Array     # (N,) traversal t of the primary ray (INF = sky)
    first_hit_valid: Array  # (N,) bool
    first_hit_point: Array  # (N, 3)
    first_hit_normal: Array  # (N, 3)


class _ShadeOut(NamedTuple):
    """Per-lane results of the NEE + bounce loop (before the env fetch)."""
    light: Array           # (N, 3) accumulated NEE/emissive radiance
    miss_any: Array        # (N,) bool — ray escaped at some bounce
    miss_dir: Array        # (N, 3) escape direction
    miss_reduction: Array  # (N, 3) throughput at escape
    emission0: Array       # (N, 3) first-hit emissive (zero for miss lanes)
    albedo0: Array         # (N, 3) first-hit base color
    valid0: Array          # (N,) bool first-hit validity
    point0: Array          # (N, 3) first-hit point (zero for miss lanes)
    normal0: Array         # (N, 3) first-hit shading normal


def _shade_loop(scene: Scene, pk: PackedScene, cfg: RenderConfig,
                orig: Array, d: Array, px: Array, py: Array,
                frame: Array | int, first_t: Array, first_idx: Array,
                aniso: bool = False) -> _ShadeOut:
    """The per-bounce NEE + BSDF loop, with the bounce-0 traversal given.

    Every sample stream is keyed on (px, py, frame) — lane POSITION never
    enters the math — so running this loop on a compacted subset of lanes
    yields the same per-pixel math (identical up to XLA fusion
    reassociation — the compaction property trace_paths relies on). Lanes
    whose first_idx is < 0 are miss lanes: they report the environment
    escape at bounce 0.
    """
    n = orig.shape[0]
    seed = rng.pixel_seed(px, py, frame)
    # the reference draws (and discards) an AA jitter first
    # (path_tracing.frag:1060) — consume the stream identically
    _, seed = rng.rand(seed)
    _, seed = rng.rand(seed)

    cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    light = jnp.zeros((n, 3), jnp.float32)
    reduction = jnp.ones((n, 3), jnp.float32)
    alive = jnp.ones((n,), bool)
    # each ray misses at most once; record (direction, throughput) at the
    # miss and fetch the environment radiance ONCE after the loop — the
    # bilinear env fetch is a full-frame gather, so
    # per-bounce fetches would cost depth x that
    miss_any = jnp.zeros((n,), bool)
    miss_dir = d
    miss_reduction = jnp.zeros((n, 3), jnp.float32)

    emission0 = jnp.zeros((n, 3), jnp.float32)
    albedo0 = jnp.zeros((n, 3), jnp.float32)
    valid0 = jnp.zeros((n,), bool)
    point0 = jnp.zeros((n, 3), jnp.float32)
    normal0 = jnp.zeros((n, 3), jnp.float32)

    t, idx = first_t, first_idx
    for bounce in range(cfg.max_tracing_depth):
        last = bounce == cfg.max_tracing_depth - 1
        hit = resolve_hit(scene, orig, d, t, idx, cfg, pk)

        if bounce == 0:
            vmask = hit.valid[..., None]
            emission0 = jnp.where(vmask, hit.mat.emissive, 0.0)
            albedo0 = jnp.where(vmask, hit.mat.base_color, 0.0)
            valid0 = hit.valid
            point0 = jnp.where(vmask, hit.point, 0.0)
            normal0 = jnp.where(vmask, hit.normal, 0.0)

        # miss -> environment radiance, terminate (path_tracing.frag:1084-1087)
        miss = alive & ~hit.valid
        miss_dir = jnp.where(miss[..., None], d, miss_dir)
        miss_reduction = jnp.where(miss[..., None], reduction, miss_reduction)
        miss_any = miss_any | miss
        alive = alive & hit.valid

        # sample the BSDF (Sobol + CPR + stream xi3, frag:1089-1096)
        sob = rng.sobol_vec2(jnp.asarray(frame, jnp.uint32) + jnp.uint32(1), bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        xi3, seed = rng.rand(seed)

        v = -d
        # anisotropic path (static gate, see resolve_aniso): tangent frame
        # from the same ONB convention as toNormalHemisphere; the sampler
        # and all three evaluations below share it through `pre`
        tb = disney.build_onb(hit.normal) if aniso else None
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat,
                              frame=tb)
        ndotl = jnp.sum(hit.normal * l_new, axis=-1)
        alive = alive & (ndotl > 0.0)

        # shade (frag:948-968): env NEE + point NEE + BSDF-emissive, weighted
        # — three BSDF evaluations share one view-dependent precompute
        pre = disney.precompute_view(v, hit.normal, hit.mat, frame=tb)
        f_r, brdf_pdf = disney.evaluate_pdf_pre(pre, v, hit.normal, l_new,
                                                hit.mat)
        er1, seed = rng.rand(seed)
        er2, seed = rng.rand(seed)
        lu, seed = rng.rand(seed)
        env_c, env_pdf_v = _env_nee(scene, pk, hit, v, er1, er2,
                                    active=alive, pre=pre)
        pt_c, pt_pdf_v = _point_nee(scene, pk, hit, v, lu, active=alive,
                                    pre=pre)
        cos_term = jnp.abs(ndotl)[..., None]
        brdf_c = hit.mat.emissive * f_r * cos_term / jnp.maximum(brdf_pdf, 1e-12)[..., None]

        wsum = env_pdf_v + pt_pdf_v + brdf_pdf + EPS
        hit_light = reduction * (
            (env_pdf_v / wsum)[..., None] * env_c
            + (pt_pdf_v / wsum)[..., None] * pt_c
            + (brdf_pdf / wsum)[..., None] * brdf_c)
        light = light + jnp.where(alive[..., None], hit_light, 0.0)

        reduction = reduction * jnp.where(
            alive[..., None],
            f_r * cos_term / jnp.maximum(brdf_pdf, 1e-12)[..., None], 1.0)

        orig = hit.point
        d = jnp.where(alive[..., None], l_new, d)
        if not last:
            # terminated paths stop paying for traversal: t_max = 0 marks
            # the lane dead
            b_tmax = jnp.where(alive, INF, 0.0)
            t, idx = trace(scene.bvh, scene.triangles, orig, d, t_max=b_tmax)

    return _ShadeOut(light=light, miss_any=miss_any, miss_dir=miss_dir,
                     miss_reduction=miss_reduction, emission0=emission0,
                     albedo0=albedo0, valid0=valid0, point0=point0,
                     normal0=normal0)


def _compact_budget(n: int, cfg: RenderConfig) -> int:
    """Compacted-wavefront size: compact_frac * n rounded up to 512 lanes
    (the traversal kernel pads its own input to its block size)."""
    if cfg.compact_frac <= 0.0:
        return 0
    budget = (int(n * cfg.compact_frac) + 511) // 512 * 512
    if budget <= 0 or budget >= n:
        return 0
    return budget


def trace_paths(scene: Scene, orig: Array, d: Array, px: Array, py: Array,
                frame: Array | int, cfg: RenderConfig) -> PTOutput:
    """One sample per ray, up to cfg.max_tracing_depth bounces.

    orig/d: (N, 3); px/py: (N,) integer *global* pixel coords (RNG seeds —
    global so image tiles shard without changing the picture); frame: scalar.

    Bounce-boundary compaction (cfg.compact_frac): after the primary trace,
    the surviving lanes are packed densely into a compact_frac-sized buffer
    and the whole shading loop runs at that size — sky lanes stop paying for
    Disney/RNG math, table gathers and (because the dead tail forms whole
    dead blocks) the incoherent secondary traversals. Per-pixel results
    are identical up to XLA fusion reassociation (sample streams are keyed
    on pixel, not lane; the differently-fused programs can flip grazing
    visibility tests at isolated pixels — see RenderConfig.compact_frac).
    If more lanes survive than the budget, a residual
    full-width pass handles the overflow lanes under lax.cond, so the
    fast path stays exact for any scene coverage.
    """
    if cfg.integrator == "mis":
        from tpuray.integrator.mis import trace_paths_mis
        return trace_paths_mis(scene, orig, d, px, py, frame, cfg)
    n = orig.shape[0]
    pk = pack_scene_tables(scene)  # wide-gather tables (cheap reshuffles)
    aniso = resolve_aniso(scene, cfg)

    t0_full, idx0_full = trace(scene.bvh, scene.triangles, orig, d,
                               t_max=INF)
    alive0 = idx0_full >= 0

    budget = _compact_budget(n, cfg)
    if budget == 0:
        out = _shade_loop(scene, pk, cfg, orig, d, px, py, frame,
                          t0_full, idx0_full, aniso=aniso)
    else:
        # stable compaction: sel = the first `budget` surviving lane ids in
        # tile order (preserves spatial coherence inside blocks); padding
        # lanes get first_idx = -1 (treated as miss; their zero
        # contributions are masked at scatter time)
        rank = jnp.cumsum(alive0.astype(jnp.int32)) - 1
        n_alive = rank[-1] + 1
        in_sel = alive0 & (rank < budget)
        sel = jnp.nonzero(in_sel, size=budget, fill_value=0)[0]
        lane_ok = (jnp.arange(budget) < n_alive)

        # ONE fused gather per dtype instead of 7 narrow ones
        gf = jnp.concatenate([orig, d, t0_full[:, None]], axis=1)[sel]
        gi = jnp.stack([px.astype(jnp.int32), py.astype(jnp.int32),
                        idx0_full], axis=1)[sel]
        c_d = gf[:, 3:6]
        c = _shade_loop(
            scene, pk, cfg, gf[:, 0:3], c_d,
            gi[:, 0].astype(jnp.uint32), gi[:, 1].astype(jnp.uint32), frame,
            jnp.where(lane_ok, gf[:, 6], INF),
            jnp.where(lane_ok, gi[:, 2], -1), aniso=aniso)

        # ONE fused scatter of every per-lane output (7x3 f32 + 2 flags).
        # miss_dir is scattered as a delta on top of d so lanes that never
        # miss keep a unit direction — a zero direction would NaN the env
        # fetch's normalization (poisoning the backward pass even under
        # where). miss bookkeeping covers compacted lanes that escaped at a
        # later bounce plus every primary-miss lane (never selected).
        packed = jnp.concatenate([
            c.light, c.emission0, c.albedo0, c.point0, c.normal0,
            c.miss_dir - c_d,
            jnp.where(c.miss_any[..., None], c.miss_reduction, 0.0),
            c.valid0[..., None].astype(jnp.float32),
            c.miss_any[..., None].astype(jnp.float32)], axis=1)
        scattered = jnp.zeros((n, 23), jnp.float32).at[sel].add(
            jnp.where(lane_ok[..., None], packed, 0.0))
        light = scattered[:, 0:3]
        emission0 = scattered[:, 3:6]
        albedo0 = scattered[:, 6:9]
        point0 = scattered[:, 9:12]
        normal0 = scattered[:, 12:15]
        miss_dir = d + scattered[:, 15:18]
        miss_red = scattered[:, 18:21]
        valid0 = scattered[:, 21] > 0.5
        miss_any = (scattered[:, 22] > 0.5) | ~alive0
        miss_red = jnp.where((~alive0)[..., None], 1.0, miss_red)
        z3 = jnp.zeros((n, 3), jnp.float32)

        # residual pass: only if more lanes survived than the budget (rare
        # with a sane compact_frac; exact either way). Runs the full-width
        # loop with every in-sel/miss lane masked off.
        def residual(_):
            r_alive = alive0 & ~in_sel
            r = _shade_loop(scene, pk, cfg, orig, d, px, py, frame,
                            jnp.where(r_alive, t0_full, INF),
                            jnp.where(r_alive, idx0_full, -1),
                            aniso=aniso)
            # lanes masked OFF this pass (first_idx forced to -1) report a
            # bounce-0 "miss" — scrub it, or the merge below would hand
            # every such lane a full-strength env contribution on top of
            # its real (compacted-pass) radiance
            mm = r.miss_any & r_alive
            return r._replace(
                miss_any=mm,
                miss_reduction=jnp.where(mm[..., None], r.miss_reduction, 0.0))

        def no_residual(_):
            return _ShadeOut(
                light=z3, miss_any=jnp.zeros((n,), bool), miss_dir=z3,
                miss_reduction=z3, emission0=z3, albedo0=z3,
                valid0=jnp.zeros((n,), bool), point0=z3, normal0=z3)

        r = jax.lax.cond(n_alive > budget, residual, no_residual, 0)
        light = light + r.light
        emission0 = emission0 + r.emission0
        albedo0 = albedo0 + r.albedo0
        point0 = point0 + r.point0
        normal0 = normal0 + r.normal0
        valid0 = valid0 | r.valid0
        miss_dir = jnp.where(r.miss_any[..., None], r.miss_dir, miss_dir)
        miss_red = jnp.where(r.miss_any[..., None], r.miss_reduction, miss_red)
        miss_any = miss_any | r.miss_any

        out = _ShadeOut(light=light, miss_any=miss_any, miss_dir=miss_dir,
                        miss_reduction=miss_red, emission0=emission0,
                        albedo0=albedo0, valid0=valid0, point0=point0,
                        normal0=normal0)

    env_rad = env.env_radiance_packed(pk.env_image_q, out.miss_dir)
    light = out.light + jnp.where(out.miss_any[..., None],
                                  env_rad * out.miss_reduction, 0.0)

    # clamp + NaN scrub (frag:1110-1113)
    light = jnp.clip(light, 0.0, cfg.clamp_threshold)
    light = jnp.where(jnp.isnan(light), 0.0, light)

    return PTOutput(color=light, emission=out.emission0, albedo=out.albedo0,
                    first_hit_t=t0_full, first_hit_valid=out.valid0,
                    first_hit_point=out.point0,
                    first_hit_normal=out.normal0)
