"""Elastic render-loop supervision: failure detection + checkpointed resume.

The reference hard-exits on any fault (obj_loader.h:17, shader.h:11,41) and
keeps all temporal state in GL textures, so a crash loses everything. Here
the whole inter-frame state is an explicit FrameState pytree
(render/frame_state.py), which makes restartable rendering cheap: the
supervisor checkpoints every `checkpoint_every` frames, classifies
exceptions from the frame function as device faults vs programming errors,
and on a fault rebuilds device state from the last checkpoint and replays
the missed frames. Because a frame is a pure function of
(scene, camera, state), a replayed run is bit-identical to an uninterrupted
one — asserted in tests/test_elastic.py with injected faults.

Multi-host: jax.distributed-backed runs (tpuray.dist.multihost) layer on
top — each process supervises its own shard and restores from its own
checkpoint; the jax.distributed barrier at re-init is the coordinator's
job, not this module's.
"""
from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import jax

from tpuray.render.frame_state import FrameState
from tpuray.utils.checkpoint import load_frame_state, save_frame_state

log = logging.getLogger("tpuray.elastic")

# Status codes that indicate a *device/runtime* fault (worth a restart)
# rather than a programming error (re-raise immediately). For generic
# exceptions they must appear as message PREFIXES — substring search over
# an arbitrary message would misclassify ordinary JAX type/placement
# errors whose text mentions a device (ADVICE r3). For runtime-layer error
# types (JaxRuntimeError/XlaRuntimeError) the code may be wrapped
# ("Execution failed: INTERNAL: ...", legacy "Internal:"), so there the tokens are matched anywhere on a word boundary
# (ADVICE r4: prefix-only matching let wrapped device faults kill an
# elastic run instead of restoring from checkpoint).
_FAULT_CODES = (
    "UNAVAILABLE", "INTERNAL", "DATA_LOSS", "ABORTED", "DEADLINE_EXCEEDED",
)
_FAULT_SUBSTRINGS = ("worker process crashed",)
_FAULT_TOKEN_RE = None  # compiled lazily


def _fault_token_anywhere(msg: str) -> bool:
    global _FAULT_TOKEN_RE
    if _FAULT_TOKEN_RE is None:
        import re
        alts = "|".join(_FAULT_CODES)
        _FAULT_TOKEN_RE = re.compile(rf"\b({alts})\b", re.IGNORECASE)
    return _FAULT_TOKEN_RE.search(msg) is not None


def is_device_fault(exc: BaseException) -> bool:
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return False
    name = type(exc).__name__
    msg = str(exc)
    if name in ("JaxRuntimeError", "XlaRuntimeError"):
        # already a runtime-layer error: a status-code token anywhere in
        # the (possibly wrapping) message marks it a device fault;
        # INVALID_ARGUMENT etc. are programming errors even from the
        # runtime and carry none of the fault codes
        return (_fault_token_anywhere(msg)
                or any(m in msg for m in _FAULT_SUBSTRINGS))
    return (msg.lstrip().startswith(_FAULT_CODES)
            or any(m in msg for m in _FAULT_SUBSTRINGS))


@dataclass
class ElasticStats:
    frames_done: int = 0
    faults: int = 0
    restores: int = 0
    replayed_frames: int = 0
    checkpoints: int = 0
    fault_log: list = field(default_factory=list)


def run_elastic(frame_fn: Callable[[FrameState, int], FrameState],
                initial_state: FrameState,
                n_frames: int,
                checkpoint_path: str,
                checkpoint_every: int = 8,
                max_restarts: int = 3,
                on_restore: Callable[[], None] | None = None) -> tuple[FrameState, ElasticStats]:
    """Drive `frame_fn(state, frame_index) -> state` for n_frames with
    fault supervision.

    On a device fault: reload the newest checkpoint (or the initial state),
    call `on_restore` (hook for backend re-init / cache clear), and replay
    from the checkpointed frame index. Raises after `max_restarts`
    consecutive faults, and immediately for non-fault exceptions.
    Returns (final state, stats).
    """
    stats = ElasticStats()
    state = initial_state
    frame = int(state.frame_idx)
    restarts_in_row = 0
    # Write an initial checkpoint at loop entry so a first-frame fault can
    # only ever restore state produced by THIS run — a stale file from a
    # previous run (different scene/config, or frame_idx >= n_frames which
    # would silently end the loop) must never be trusted (ADVICE r3).
    save_frame_state(checkpoint_path, state)
    stats.checkpoints += 1

    while frame < n_frames:
        try:
            state = frame_fn(state, frame)
            jax.block_until_ready(state.frame_idx)
            frame += 1
            stats.frames_done += 1
            restarts_in_row = 0
            if frame % checkpoint_every == 0 or frame == n_frames:
                save_frame_state(checkpoint_path, state)
                stats.checkpoints += 1
        except Exception as exc:  # noqa: BLE001 — classified below
            if not is_device_fault(exc):
                raise
            stats.faults += 1
            stats.fault_log.append((frame, repr(exc)[:200], time.time()))
            restarts_in_row += 1
            log.warning("device fault at frame %d (%d/%d): %r",
                        frame, restarts_in_row, max_restarts, exc)
            if restarts_in_row > max_restarts:
                raise
            if on_restore is not None:
                on_restore()
            if os.path.exists(checkpoint_path):
                state = load_frame_state(checkpoint_path)
                stats.restores += 1
            else:
                state = initial_state
            resumed = int(state.frame_idx)
            stats.replayed_frames += max(0, frame - resumed)
            frame = resumed

    return state, stats
