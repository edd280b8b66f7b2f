"""Explicit temporal state of the render loop, as a pytree.

The reference keeps inter-frame state in 5 'last_*' GL textures copied by a
dedicated pass (main.cpp:317-333, shaders/save_frame_data.frag) plus
frameCounter and pre_viewproj (main.cpp:599-602). Here it is one pytree —
which makes checkpoint/resume trivial (tpuray.utils.checkpoint) and lets the
whole frame step be a pure function FrameState -> FrameState.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpuray.scene.types import pytree_dataclass

Array = jax.Array


@pytree_dataclass
class FrameState:
    # last SVGF illumination history: the a-trous feedback tap
    # (output of iteration cfg.history_atrous_tap, main.cpp:521-525)
    illum_hist: Array     # (H, W, 3)
    variance_hist: Array  # (H, W)
    # previous G-buffer for reprojection validation
    prev_normal: Array    # (H, W, 3)
    prev_linear_z: Array  # (H, W)  (1.0 = sky)
    # temporal moments
    moments: Array        # (H, W, 2)
    history_len: Array    # (H, W)
    # progressive accumulation + TAA history
    accum_color: Array    # (H, W, 3)
    taa_color: Array      # (H, W, 3)
    # frame bookkeeping
    frame_idx: Array      # () int32
    prev_view_proj: Array  # (4, 4)

    @staticmethod
    def initial(height: int, width: int, view_proj=None) -> "FrameState":
        z3 = jnp.zeros((height, width, 3), jnp.float32)
        z1 = jnp.zeros((height, width), jnp.float32)
        vp = (jnp.asarray(view_proj, jnp.float32) if view_proj is not None
              else jnp.eye(4, dtype=jnp.float32))
        return FrameState(
            illum_hist=z3, variance_hist=z1,
            prev_normal=z3, prev_linear_z=jnp.ones((height, width), jnp.float32),
            moments=jnp.zeros((height, width, 2), jnp.float32),
            history_len=z1, accum_color=z3, taa_color=z3,
            frame_idx=jnp.zeros((), jnp.int32), prev_view_proj=vp,
        )

    def reset_accumulation(self) -> "FrameState":
        """Equivalent of frameCounter=0 on camera/parameter change
        (Utils/camera.h:72, main.cpp:372-387)."""
        return self.replace(frame_idx=jnp.zeros((), jnp.int32))
