"""The full SVGF + TAA denoising pipeline as one pure function.

Wires the stages exactly as the reference frame loop does
(main.cpp:474-553): reproject -> spatial variance fallback -> N a-trous
iterations with step 1<<i (saving the iteration-`tap` output as next frame's
illumination history) -> modulate -> TAA.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpuray.denoise.atrous import atrous_iteration
from tpuray.denoise.modulate import modulate
from tpuray.denoise.reproject import reproject
from tpuray.denoise.taa import taa
from tpuray.denoise.variance import estimate_variance
from tpuray.integrator.gbuffer import GBuffer
from tpuray.render.frame_state import FrameState
from tpuray.scene.config import RenderConfig

Array = jax.Array


class SVGFOutput(NamedTuple):
    reprojected: Array      # (H, W, 3) post-temporal-accumulation illumination
    reprojected_var: Array  # (H, W)
    variance_illum: Array   # (H, W, 3) after the spatial fallback
    variance_var: Array     # (H, W)
    atrous: Array           # (H, W, 3) final a-trous output
    atrous_var: Array       # (H, W)
    history_tap: Array      # (H, W, 3) the feedback tap for next frame
    history_tap_var: Array  # (H, W)
    modulated: Array        # (H, W, 3)
    taa: Array              # (H, W, 3)
    moments: Array          # (H, W, 2)
    history_len: Array      # (H, W)


def svgf_pipeline(color: Array, emission: Array, albedo: Array,
                  gbuf: GBuffer, state: FrameState,
                  cfg: RenderConfig, static_camera: bool = False) -> SVGFOutput:
    rep = reproject(
        color=color, emission=emission, albedo=albedo,
        motion=gbuf.velocity, normal=gbuf.normal, linear_z=gbuf.linear_z,
        fwidth_normal=gbuf.fwidth_normal, fwidth_z=gbuf.fwidth_z,
        prev_illum=state.illum_hist, prev_variance=state.variance_hist,
        prev_normal=state.prev_normal, prev_linear_z=state.prev_linear_z,
        prev_moments=state.moments, prev_history_len=state.history_len,
        cfg=cfg, static_camera=static_camera)

    var = estimate_variance(
        illum=rep.illum, variance=rep.variance, moments=rep.moments,
        history_len=rep.history_len, normal=gbuf.normal,
        linear_z=gbuf.linear_z, fwidth_z=gbuf.fwidth_z, cfg=cfg)

    illum, variance = var.illum, var.variance
    history_tap, history_tap_var = illum, variance
    for i in range(cfg.num_atrous_iterations):
        illum, variance = atrous_iteration(
            illum, variance, gbuf.normal, gbuf.linear_z, gbuf.fwidth_z,
            step=1 << i, cfg=cfg)
        if i == cfg.history_atrous_tap:
            history_tap, history_tap_var = illum, variance

    mod = modulate(illum, albedo, emission, gbuf.linear_z)
    taa_out = taa(mod, state.taa_color, gbuf.velocity, gbuf.linear_z,
                  state.frame_idx, static_camera=static_camera)

    return SVGFOutput(
        reprojected=rep.illum, reprojected_var=rep.variance,
        variance_illum=var.illum, variance_var=var.variance,
        atrous=illum, atrous_var=variance,
        history_tap=history_tap, history_tap_var=history_tap_var,
        modulated=mod, taa=taa_out,
        moments=rep.moments, history_len=rep.history_len)
