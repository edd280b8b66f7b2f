"""Render configuration.

Parameter names and defaults mirror the reference GUI config
(reference Utils/gui_config.h:21-34) so a reference user can map their
slider settings 1:1. Static fields (depth, iterations, resolution) are Python
ints — they shape the compiled program; float thresholds are runtime values.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import pathlib


class DebugView(enum.IntEnum):
    """Intermediate buffers exposed for inspection (gui_config.h:7-17)."""

    PATH_TRACING_1SPP = 0
    SVGF_REPROJECTED = 1
    SVGF_VARIANCE = 2
    SVGF_ATROUS = 3
    SVGF_MODULATE = 4
    TAA = 5
    FINAL = 6
    ACCUMULATE_COLOR = 7


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # image
    width: int = 800
    height: int = 800

    # path tracing (gui_config.h:27-29)
    # "nee": the reference's active integrator (pdf-weighted env+point NEE,
    #        path_tracing.frag:948-968)
    # "mis": the reference's written-but-unused MIS integrator, made usable
    #        (path_tracing.frag:972-1052)
    integrator: str = "nee"
    max_tracing_depth: int = 2          # bounces per 1spp frame (slider 1-4)

    # Anisotropic Disney specular (GTR2_aniso + aniso Smith-GGX, the
    # reference's BRDF_Evaluate_aniso made live — path_tracing.frag:557-618):
    # "auto" resolves to True iff the material table has any
    # anisotropic > 0 row (resolved on concrete materials by the Renderer /
    # eager trace_paths; inside a jit trace "auto" degrades to False, so
    # direct render_frame callers with aniso scenes pass True). Isotropic
    # scenes keep the exact reference math and pay zero extra ops.
    enable_aniso: bool | str = "auto"
    clamp_threshold: float = 10.0       # radiance clamp
    accumulate: bool = True             # progressive accumulation
    use_normal_map: bool = False

    # SVGF (gui_config.h:21-26, 31)
    sigma_n: float = 128.0              # gPhiNormal
    sigma_l: float = 4.0                # gPhiColor
    reproj_depth_threshold: float = 10.0
    reproj_normal_threshold: float = 16.0
    num_atrous_iterations: int = 5      # step sizes 1<<i (main.cpp:499-504)
    history_cap: float = 32.0           # svgf_reproject.frag:185
    alpha_min: float = 0.2              # EMA floor, svgf_reproject.frag:187

    # feedback tap: which a-trous iteration feeds next frame's illum history
    # (the reference saves after iteration index 1, main.cpp:521-525)
    history_atrous_tap: int = 1

    # denoiser toggles
    enable_svgf: bool = True
    enable_taa: bool = True

    # Bounce-boundary ray compaction (integrator/path_tracer.py): after the
    # primary trace, pack the surviving (hit) lanes densely into a buffer of
    # compact_frac * n rays and run the whole NEE + bounce loop at that
    # size — sky lanes stop paying for shading, gathers AND the incoherent
    # secondary traversals (dead lanes at the compacted tail finish their
    # walk at once). Per-pixel output is identical up to XLA fusion
    # reassociation: every sample stream is keyed on (pixel, frame), not
    # lane position, so the math is the same, but the two programs fuse
    # differently and float reassociation can flip grazing shadow-
    # visibility tests at isolated pixels (tests/test_compaction uses
    # rtol=2e-4; exact-invariance users should set compact_frac=0 and
    # compact_auto=False). Frames where
    # more rays survive than the budget run a residual full-width pass for
    # the overflow lanes (lax.cond — only pays when it happens).
    # 0 disables.
    compact_frac: float = 0.5

    # Renderer-level auto-tuning of compact_frac: after each frame the
    # Renderer reads the frame's hit coverage (one scalar) and picks the
    # smallest budget bucket from {1/8, 1/4, 1/2} with ~30% headroom for
    # the NEXT frame (the reference clock scene covers only ~8% of the
    # 800x800 frame at the startup pose — a fixed 0.5 budget wastes most
    # of the compaction win). Each bucket is a separate XLA compilation
    # (cached); the residual pass keeps overflow frames exact while the
    # bucket catches up.
    compact_auto: bool = True

    # output
    tonemap_limit: float = 1.5          # output_pass.frag:13
    gamma: float = 2.2

    # reference-quirk emulation (SURVEY.md "Hard parts"): when True, replicate
    # behaviors of the reference that are arguably bugs, for image parity:
    #  - identity variance "blur" in a-trous (svgf_Atrous.frag:36 reads the
    #    center texel for all 9 taps)
    #  - sub-pixel-scaled bilinear weights in reprojection
    #    (svgf_reproject.frag:84-91)
    reference_quirks: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    # --- (de)serialization: JSON config files, the reference has GUI only ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RenderConfig":
        return RenderConfig(**json.loads(text))

    @staticmethod
    def load(path: str | pathlib.Path) -> "RenderConfig":
        return RenderConfig.from_json(pathlib.Path(path).read_text())

    def save(self, path: str | pathlib.Path) -> None:
        pathlib.Path(path).write_text(self.to_json())
