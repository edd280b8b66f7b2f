"""Multiple-importance-sampling integrator.

The reference ships a full MIS integrator that is never called from main()
(pathTracingImportanceSampling, path_tracing.frag:972-1052, weight
misMixWeight a^2/(a^2+b^2) at :876-879). Here it is a first-class mode
(RenderConfig.integrator = "mis"): per bounce, an envmap light sample and a
BSDF sample are combined with the squared-balance heuristic. Point lights
are not part of the reference's MIS path and are likewise omitted here.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.integrator import disney
from tpuray.integrator import path_tracer as pt
from tpuray.sampling import envmap as env
from tpuray.sampling import rng
from tpuray.scene.config import RenderConfig
from tpuray.scene.types import Scene

Array = jax.Array


def mis_mix_weight(a: Array, b: Array) -> Array:
    """Squared balance heuristic (path_tracing.frag:876-879)."""
    t = a * a
    return t / jnp.maximum(b * b + t, 1e-20)


def trace_paths_mis(scene: Scene, orig: Array, d: Array, px: Array, py: Array,
                    frame, cfg: RenderConfig) -> "pt.PTOutput":
    n = orig.shape[0]
    pk = pt.pack_scene_tables(scene)
    aniso = pt.resolve_aniso(scene, cfg)

    seed = rng.pixel_seed(px, py, frame)
    _, seed = rng.rand(seed)
    _, seed = rng.rand(seed)

    cpr_u, cpr_v = rng.cranley_patterson_offsets(px, py)

    light = jnp.zeros((n, 3), jnp.float32)
    history = jnp.ones((n, 3), jnp.float32)
    alive = jnp.ones((n,), bool)

    emission0 = jnp.zeros((n, 3), jnp.float32)
    albedo0 = jnp.zeros((n, 3), jnp.float32)
    t0 = jnp.full((n,), pt.INF, jnp.float32)
    valid0 = jnp.zeros((n,), bool)
    point0 = jnp.zeros((n, 3), jnp.float32)
    normal0 = jnp.zeros((n, 3), jnp.float32)

    for bounce in range(cfg.max_tracing_depth):
        # dead-lane masking: terminated paths get t_max = 0 so all-dead
        # packets skip the BVH walk entirely (see path_tracer.trace_paths)
        b_tmax = pt.INF if bounce == 0 else jnp.where(alive, pt.INF, 0.0)
        t, idx = pt.trace(scene.bvh, scene.triangles, orig, d, t_max=b_tmax)
        hit = pt.resolve_hit(scene, orig, d, t, idx, cfg, pk)

        if bounce == 0:
            emission0 = jnp.where(hit.valid[..., None], hit.mat.emissive, 0.0)
            albedo0 = jnp.where(hit.valid[..., None], hit.mat.base_color, 0.0)
            t0, valid0 = t, hit.valid
            point0, normal0 = hit.point, hit.normal

        # primary/continuation miss handled by the BSDF-sample MIS below for
        # bounce > 0; the camera ray itself just sees the envmap
        if bounce == 0:
            miss = alive & ~hit.valid
            env_rad = env.env_radiance_packed(pk.env_image_q, d)
            light = light + jnp.where(miss[..., None], env_rad, 0.0)
        alive = alive & hit.valid
        v = -d
        # anisotropic path (static gate, see path_tracer.resolve_aniso)
        tb = disney.build_onb(hit.normal) if aniso else None

        # --- light sampling arm (frag:981-1004) ---
        r1, seed = rng.rand(seed)
        r2, seed = rng.rand(seed)
        l_light = env.sample_env_packed(pk.env_cache_q, r1, r2)
        front = jnp.sum(hit.normal * l_light, axis=-1) > 0.0
        s_tmax = jnp.where(alive & front, pt.INF, 0.0)
        _, sidx = pt.trace(scene.bvh, scene.triangles, hit.point, l_light,
                           t_max=s_tmax, any_hit=True)
        unblocked = sidx < 0
        radiance_l = env.env_radiance_packed(pk.env_image_q, l_light)
        pdf_light = env.env_pdf_packed(pk.env_cache_q, l_light)
        f_r_l, pdf_brdf_l = disney.evaluate_pdf(v, hit.normal, l_light,
                                                hit.mat, frame=tb)
        w_l = mis_mix_weight(pdf_light, pdf_brdf_l)
        ndotl_l = jnp.maximum(jnp.sum(hit.normal * l_light, axis=-1), 0.0)
        contrib_l = (w_l[..., None] * history * radiance_l * f_r_l
                     * ndotl_l[..., None]
                     / jnp.maximum(pdf_light, 1e-12)[..., None])
        use_l = alive & front & unblocked
        light = light + jnp.where(use_l[..., None], contrib_l, 0.0)

        # --- BSDF sampling arm (frag:1006-1048) ---
        sob = rng.sobol_vec2(jnp.asarray(frame, jnp.uint32) + jnp.uint32(1), bounce)
        xi1, xi2 = rng.cranley_patterson_rotate(sob, cpr_u, cpr_v)
        xi3, seed = rng.rand(seed)
        l_new = disney.sample(xi1, xi2, xi3, v, hit.normal, hit.mat,
                              frame=tb)
        ndotl = jnp.sum(hit.normal * l_new, axis=-1)
        alive = alive & (ndotl > 0.0)

        f_r, pdf_brdf = disney.evaluate_pdf(v, hit.normal, l_new, hit.mat,
                                            frame=tb)
        alive = alive & (pdf_brdf > 0.0)

        t2, idx2 = pt.trace(scene.bvh, scene.triangles, hit.point, l_new,
                            t_max=jnp.where(alive, pt.INF, 0.0))
        next_missed = idx2 < 0

        env_rad2 = env.env_radiance_packed(pk.env_image_q, l_new)
        pdf_light2 = env.env_pdf_packed(pk.env_cache_q, l_new)
        w_b = mis_mix_weight(pdf_brdf, pdf_light2)
        throughput = (f_r * jnp.maximum(ndotl, 0.0)[..., None]
                      / jnp.maximum(pdf_brdf, 1e-12)[..., None])
        contrib_miss = w_b[..., None] * history * env_rad2 * throughput
        light = light + jnp.where((alive & next_missed)[..., None],
                                  contrib_miss, 0.0)

        # emissive surface hit by the BSDF ray (frag:1042-1044)
        hit2_mat = pt.fetch_material(pk.mat_table,
                                     pt.fetch_tri(pk.tri_table,
                                                  jnp.maximum(idx2, 0)).mat_id)
        le = jnp.where((alive & ~next_missed)[..., None], hit2_mat.emissive, 0.0)
        light = light + history * le * throughput

        history = history * jnp.where(alive[..., None], throughput, 1.0)
        alive = alive & ~next_missed
        orig = hit.point
        d = jnp.where(alive[..., None], l_new, d)

    light = jnp.clip(light, 0.0, cfg.clamp_threshold)
    light = jnp.where(jnp.isnan(light), 0.0, light)
    return pt.PTOutput(color=light, emission=emission0, albedo=albedo0,
                       first_hit_t=t0, first_hit_valid=valid0,
                       first_hit_point=point0, first_hit_normal=normal0)
