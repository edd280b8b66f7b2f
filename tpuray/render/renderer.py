"""Frame orchestration: one jitted pure function per frame.

The reference drives 9 GL passes per frame from main() (main.cpp:436-590);
here the whole frame — path trace, G-buffer, SVGF, TAA, history save,
tonemap — is a single jitted function of (Scene, Camera, FrameState), so XLA
fuses across stage boundaries and there is no host round-trip inside a frame.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.denoise.svgf import SVGFOutput, svgf_pipeline
from tpuray.integrator.gbuffer import GBuffer, build_gbuffer
from tpuray.integrator.path_tracer import PTOutput, trace_paths
from tpuray.render.frame_state import FrameState
from tpuray.scene.config import DebugView, RenderConfig
from tpuray.scene.types import Camera, Scene

Array = jax.Array


class FrameOutputs(NamedTuple):
    pt_color: Array       # (H, W, 3) 1spp (or accumulated) path-traced color
    accum_color: Array    # (H, W, 3)
    svgf: SVGFOutput
    gbuffer: GBuffer
    final: Array          # (H, W, 3) TAA output (linear)
    coverage: Array       # () fraction of primary rays that hit geometry


def tonemap(c: Array, limit: float = 1.5, gamma: float = 2.2) -> Array:
    """Output transform (shaders/output_pass.frag:12-31): Reinhard-style
    luminance compression then gamma."""
    lum = 0.3 * c[..., 0] + 0.6 * c[..., 1] + 0.1 * c[..., 2]
    c = c / (1.0 + lum / limit)[..., None]
    return jnp.power(jnp.clip(c, 0.0, None), 1.0 / gamma)


@partial(jax.jit, static_argnames=("cfg", "height", "width", "static_camera"))
def render_frame(scene: Scene, camera: Camera, state: FrameState,
                 cfg: RenderConfig, height: int, width: int,
                 static_camera: bool = False) -> tuple[FrameState, FrameOutputs]:
    """Render one frame and advance the temporal state.

    static_camera=True compiles the gather-free temporal path (motion == 0);
    the Renderer selects it automatically when the view matrix is unchanged.
    """
    frame = state.frame_idx

    # primary rays in 32x32-tile-major order: neighbouring rays walk the
    # same BVH nodes (tpuray.render.tiling)
    from tpuray.render.tiling import tile_pixel_coords, untile
    xx, yy = tile_pixel_coords(height, width)  # (N,) padded
    n = xx.shape[0]
    xs = (2.0 * (xx.astype(jnp.float32) + 0.5) / width - 1.0) * camera.tan_half_fov
    ys = -(2.0 * (yy.astype(jnp.float32) + 0.5) / height - 1.0) * camera.tan_half_fov
    d_cam = jnp.stack([xs, ys, -jnp.ones_like(xs)], axis=-1)
    d = jnp.einsum("ij,nj->ni", camera.cam_to_world, d_cam,
                   precision=jax.lax.Precision.HIGHEST)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    orig = jnp.broadcast_to(camera.eye, (n, 3))
    px = xx
    py = height - 1 - yy  # GL frag coords are bottom-up

    pt = trace_paths(scene, orig, d, px, py, frame.astype(jnp.uint32), cfg)

    color = untile(pt.color, height, width)
    emission = untile(pt.emission, height, width)
    albedo = untile(pt.albedo, height, width)

    # progressive accumulation (path_tracing.frag:1116-1119)
    if cfg.accumulate:
        t = 1.0 / (frame.astype(jnp.float32) + 1.0)
        accum = state.accum_color + (color - state.accum_color) * t
    else:
        accum = color
    pt_color = accum if cfg.accumulate else color

    gbuf = build_gbuffer(
        point=untile(pt.first_hit_point, height, width),
        normal=untile(pt.first_hit_normal, height, width),
        valid=untile(pt.first_hit_valid, height, width),
        view_proj=camera.view_proj, prev_view_proj=state.prev_view_proj)

    if cfg.enable_svgf:
        svgf = svgf_pipeline(pt_color, emission, albedo, gbuf, state, cfg,
                             static_camera=static_camera)
        final = svgf.taa if cfg.enable_taa else svgf.modulated
        new_state = state.replace(
            illum_hist=svgf.history_tap,
            variance_hist=svgf.history_tap_var,
            prev_normal=gbuf.normal,
            prev_linear_z=gbuf.linear_z,
            moments=svgf.moments,
            history_len=svgf.history_len,
            accum_color=accum,
            taa_color=svgf.taa,
            frame_idx=frame + 1,
            prev_view_proj=camera.view_proj,
        )
    else:
        z1 = jnp.zeros((height, width), jnp.float32)
        svgf = SVGFOutput(
            reprojected=pt_color, reprojected_var=z1, variance_illum=pt_color,
            variance_var=z1, atrous=pt_color, atrous_var=z1,
            history_tap=pt_color, history_tap_var=z1, modulated=pt_color,
            taa=pt_color, moments=jnp.zeros((height, width, 2), jnp.float32),
            history_len=z1)
        final = pt_color
        new_state = state.replace(
            prev_normal=gbuf.normal, prev_linear_z=gbuf.linear_z,
            accum_color=accum, taa_color=final, frame_idx=frame + 1,
            prev_view_proj=camera.view_proj)

    outputs = FrameOutputs(pt_color=pt_color, accum_color=accum, svgf=svgf,
                           gbuffer=gbuf, final=final,
                           coverage=jnp.mean(
                               pt.first_hit_valid.astype(jnp.float32)))
    return new_state, outputs


def select_debug_view(outputs: FrameOutputs, view: DebugView) -> Array:
    """The output-pass texture switch (main.cpp:556-590)."""
    table = {
        DebugView.PATH_TRACING_1SPP: outputs.pt_color,
        DebugView.SVGF_REPROJECTED: outputs.svgf.reprojected,
        DebugView.SVGF_VARIANCE: outputs.svgf.variance_illum,
        DebugView.SVGF_ATROUS: outputs.svgf.atrous,
        DebugView.SVGF_MODULATE: outputs.svgf.modulated,
        DebugView.TAA: outputs.svgf.taa,
        DebugView.FINAL: outputs.final,
        DebugView.ACCUMULATE_COLOR: outputs.accum_color,
    }
    return table[view]


class Renderer:
    """Host-side convenience wrapper: owns Scene/config/state, drives frames."""

    _BUCKETS = (0.125, 0.25, 0.5)
    _TUNE_EVERY = 8  # frames between coverage reads (each read is a host
    #                  round-trip that would stall the dispatch pipeline)

    def __init__(self, scene: Scene, cfg: RenderConfig):
        if cfg.enable_aniso == "auto":
            # resolve on the CONCRETE material table now — inside the jitted
            # frame the data is a tracer and "auto" would silently pick the
            # isotropic path (integrator/path_tracer.resolve_aniso)
            from tpuray.integrator.path_tracer import resolve_aniso
            cfg = cfg.replace(enable_aniso=resolve_aniso(scene, cfg))
        self.scene = scene
        self.cfg = cfg
        self.state = FrameState.initial(cfg.height, cfg.width)
        # host copies of what the static-camera check needs, so deciding it
        # never reads device memory
        self._prev_view_proj: np.ndarray | None = None
        self._frames_since_reset = 0
        self.last_outputs: FrameOutputs | None = None
        self._frame_cfg = cfg  # cfg actually compiled (auto compact bucket)
        self._steps = 0
        self._pending_cov = None  # device scalar from an earlier frame

    def reset(self) -> None:
        self.state = self.state.reset_accumulation()
        self._frames_since_reset = 0

    def _tune_compaction(self, out: FrameOutputs) -> None:
        """Pick the compact budget bucket from a PAST frame's hit coverage
        (see RenderConfig.compact_auto). Reads the device scalar only every
        _TUNE_EVERY frames, one tuning period late, so the async dispatch
        pipeline never blocks on the host round-trip. The residual pass
        keeps overflow frames exact, so a stale bucket costs speed only."""
        self._steps += 1
        if self._steps % self._TUNE_EVERY != 0:
            return
        if self._pending_cov is not None:
            cov = float(self._pending_cov)  # computed a period ago: no stall
            want = cov * 1.3
            bucket = next((b for b in self._BUCKETS if b >= want), 0.0)
            if bucket != self._frame_cfg.compact_frac:
                self._frame_cfg = self.cfg.replace(compact_frac=bucket)
        self._pending_cov = out.coverage

    def step(self, camera: Camera) -> FrameOutputs:
        # an unchanged view compiles the gather-free temporal path (zero
        # motion, same semantics)
        view_proj = np.asarray(camera.view_proj)
        static = bool(self._frames_since_reset > 0
                      and self._prev_view_proj is not None
                      and np.allclose(view_proj, self._prev_view_proj))
        cfg = self._frame_cfg if self.cfg.compact_auto else self.cfg
        self.state, out = render_frame(
            self.scene, camera, self.state, cfg,
            self.cfg.height, self.cfg.width, static_camera=static)
        self.last_outputs = out
        self._prev_view_proj = view_proj
        self._frames_since_reset += 1
        if self.cfg.compact_auto:
            self._tune_compaction(out)
        return out

    def render(self, camera: Camera, n_frames: int = 1) -> FrameOutputs:
        out = None
        for _ in range(n_frames):
            out = self.step(camera)
        return out

    def display_image(self, view: DebugView = DebugView.FINAL) -> np.ndarray:
        img = select_debug_view(self.last_outputs, view)
        return np.asarray(tonemap(img, self.cfg.tonemap_limit, self.cfg.gamma))
