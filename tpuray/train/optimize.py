"""Differentiable rendering: optimize materials / lights to match a target.

The path tracer (tpuray.integrator.path_tracer) is pure differentiable jnp
with hit topology stopped, so pixel gradients flow to MaterialTable rows,
PointLights radiance/position, and the envmap image. This module provides
the training step — single-device and mesh-parallel (rows sharded, gradient
psum over the 'tiles' axis on NCCL over NVLink, overlapped by XLA with the backward).
The reference has no training capability; this realizes BASELINE.md's
"gradient fidelity" target.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuray.integrator.path_tracer import trace_paths
from tpuray.scene.config import RenderConfig
from tpuray.scene.types import Camera, Scene

Array = jax.Array


def split_trainable(scene: Scene, train_materials: bool = True,
                    train_lights: bool = True):
    """-> (params pytree, rebuild(params) -> Scene)."""
    params = {}
    if train_materials:
        params["materials"] = scene.materials
    if train_lights:
        params["lights"] = scene.lights

    def rebuild(p) -> Scene:
        s = scene
        if "materials" in p:
            s = s.replace(materials=p["materials"])
        if "lights" in p:
            s = s.replace(lights=p["lights"])
        return s

    return params, rebuild


def render_flat(scene: Scene, camera: Camera, cfg: RenderConfig,
                height: int, width: int, frame) -> Array:
    dirs = camera.ray_directions(height, width)
    n = height * width
    yy, xx = jnp.meshgrid(jnp.arange(height), jnp.arange(width), indexing="ij")
    pt = trace_paths(
        scene, jnp.broadcast_to(camera.eye, (n, 3)), dirs.reshape(n, 3),
        xx.reshape(n), (height - 1 - yy).reshape(n),
        jnp.asarray(frame, jnp.uint32), cfg)
    return pt.color.reshape(height, width, 3)


@partial(jax.jit, static_argnames=("cfg", "height", "width", "rebuild_static"))
def _loss_fn_impl(params, target, camera, cfg, height, width, frame,
                  rebuild_static):
    scene = rebuild_static(params)
    img = render_flat(scene, camera, cfg, height, width, frame)
    return jnp.mean((img - target) ** 2)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any


def make_train_step(rebuild: Callable, cfg: RenderConfig, height: int,
                    width: int, optimizer=None):
    """Single-device train step: (state, target, camera, frame) -> (state, loss)."""
    optimizer = optimizer or optax.adam(1e-2)

    def loss_fn(params, target, camera, frame):
        scene = rebuild(params)
        img = render_flat(scene, camera, cfg, height, width, frame)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(state: TrainState, target, camera, frame):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, target, camera, frame)
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state), loss

    def init(params) -> TrainState:
        return TrainState(params, optimizer.init(params))

    return init, step


def make_sharded_train_step(rebuild: Callable, cfg: RenderConfig, height: int,
                            width: int, mesh: Mesh, optimizer=None):
    """Mesh-parallel train step: image rows sharded over the 'tiles' axis,
    scene/params replicated, per-tile gradients psum'd inside shard_map."""
    optimizer = optimizer or optax.adam(1e-2)
    n_dev = mesh.devices.size
    assert height % n_dev == 0, "pad height to a multiple of the mesh size"
    rows = height // n_dev

    def tile_loss(params, target_t, row0, eye, cam_to_world, tan_half_fov, frame):
        scene = rebuild(params)
        yy, xx = jnp.meshgrid(jnp.arange(rows), jnp.arange(width), indexing="ij")
        yy = yy + row0
        # per-tile primary rays from global pixel coords
        xs = (2.0 * (xx.astype(jnp.float32) + 0.5) / width - 1.0) * tan_half_fov
        ys = -(2.0 * (yy.astype(jnp.float32) + 0.5) / height - 1.0) * tan_half_fov
        d_cam = jnp.stack([xs, ys, -jnp.ones_like(xs)], axis=-1)
        d = jnp.einsum("ij,hwj->hwi", cam_to_world, d_cam,
                       precision=jax.lax.Precision.HIGHEST)
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        n = rows * width
        pt = trace_paths(scene, jnp.broadcast_to(eye, (n, 3)), d.reshape(n, 3),
                         xx.reshape(n), (height - 1 - yy).reshape(n),
                         frame, cfg)
        img = pt.color.reshape(rows, width, 3)
        # mean over the *global* image = sum of per-tile sums / (H*W*3)
        return jnp.sum((img - target_t) ** 2) / (height * width * 3)

    def tile_step(params, opt_state, target_t, eye, cam_to_world, tan_half_fov, frame):
        row0 = jax.lax.axis_index("tiles") * rows
        loss, grads = jax.value_and_grad(tile_loss)(
            params, target_t, row0, eye, cam_to_world, tan_half_fov, frame)
        # gradient all-reduce (NCCL over NVLink); loss too (it is a global mean)
        grads = jax.lax.psum(grads, "tiles")
        loss = jax.lax.psum(loss, "tiles")
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    @jax.jit
    def step(state: TrainState, target, camera: Camera, frame):
        params, opt_state, loss = jax.shard_map(
            tile_step, mesh=mesh,
            in_specs=(P(), P(), P("tiles"), P(), P(), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(state.params, state.opt_state, target, camera.eye,
          camera.cam_to_world, camera.tan_half_fov,
          jnp.asarray(frame, jnp.uint32))
        return TrainState(params, opt_state), loss

    def init(params) -> TrainState:
        return TrainState(params, optimizer.init(params))

    return init, step
