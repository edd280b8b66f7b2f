"""tpuray — a differentiable path tracer with SVGF denoising, in JAX, for NVIDIA GPUs.

A from-scratch re-design of the capabilities of blxl909/path-tracing-svgf
(an OpenGL fragment-shader path tracer) as a JAX program:

- stackless threaded-BVH ray traversal over flat SoA scene arrays
  (vs. the reference's per-fragment 256-entry stack, path_tracing.frag:372-424)
- pure-functional differentiable integrator (Disney BSDF, NEE on point lights
  and an HDR envmap with importance sampling)
- SVGF (reproject / variance / a-trous / modulate) + TAA as fused image ops
- explicit FrameState pytree for the temporal loop -> checkpoint/resume for free
- shard_map ray-tile data parallelism over a jax.sharding.Mesh
"""

__version__ = "0.1.0"

from tpuray.scene.types import (  # noqa: F401
    Scene,
    TriangleSoA,
    MaterialTable,
    BVHSoA,
    PointLights,
    EnvMap,
    Camera,
)
from tpuray.scene.config import RenderConfig, DebugView  # noqa: F401
from tpuray.render.frame_state import FrameState  # noqa: F401
from tpuray.render.renderer import Renderer, render_frame  # noqa: F401
