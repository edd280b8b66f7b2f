"""Ray-tile data parallelism over a jax.sharding.Mesh.

The reference is single-GPU OpenGL with no distribution layer (SURVEY.md
§2.5); the scaling axis here is the image. The image is sharded by
rows across the 'tiles' mesh axis with the scene replicated — collectives
go over NCCL on NVLink; the only cross-device traffic is the implicit
all-gather when the caller assembles the full frame, and psum of parameter
gradients in training (tpuray.train.optimize).

Every per-ray computation keys its RNG off *global* pixel coordinates, so a
sharded render is bit-identical to the single-device one.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpuray.integrator.path_tracer import trace_paths
from tpuray.scene.config import RenderConfig
from tpuray.scene.types import Camera, Scene


def make_mesh(n_devices: int | None = None, axis: str = "tiles") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_rows(height: int, n: int) -> int:
    return (height + n - 1) // n * n


def shard_image_rows(mesh: Mesh, height: int, width: int):
    """NamedSharding for an (H, W, ...) image sharded by rows."""
    return NamedSharding(mesh, P("tiles"))


def render_tiled(scene: Scene, camera: Camera, cfg: RenderConfig,
                 mesh: Mesh, height: int, width: int,
                 frame: int | jax.Array = 0):
    """Path-trace a frame with rows sharded across the mesh.

    Returns (color, emission, albedo) as (H, W, 3) arrays laid out with the
    row sharding (a later jnp op or device_get assembles them).
    """
    n_dev = mesh.devices.size
    hp = pad_rows(height, n_dev)

    dirs = camera.ray_directions(height, width)
    if hp != height:
        dirs = jnp.pad(dirs, ((0, hp - height), (0, 0), (0, 0)))
    yy, xx = jnp.meshgrid(jnp.arange(hp), jnp.arange(width), indexing="ij")
    px = xx.astype(jnp.int32)
    py = (height - 1 - yy).astype(jnp.int32)  # global GL-style coords

    spec_img = NamedSharding(mesh, P("tiles"))
    replicated = NamedSharding(mesh, P())

    dirs = jax.device_put(dirs, spec_img)
    px = jax.device_put(px, spec_img)
    py = jax.device_put(py, spec_img)
    scene_r = jax.device_put(scene, replicated)

    @partial(jax.jit, static_argnames=("cfg",))
    def run(scene, dirs, px, py, eye, frame, cfg):
        def tile_fn(dirs_t, px_t, py_t, scene, eye, frame):
            rows = dirs_t.shape[0]
            n = rows * width
            d = dirs_t.reshape(n, 3)
            o = jnp.broadcast_to(eye, (n, 3))
            pt = trace_paths(scene, o, d, px_t.reshape(n), py_t.reshape(n),
                             frame, cfg)
            return (pt.color.reshape(rows, width, 3),
                    pt.emission.reshape(rows, width, 3),
                    pt.albedo.reshape(rows, width, 3))

        return jax.shard_map(
            tile_fn, mesh=mesh,
            in_specs=(P("tiles"), P("tiles"), P("tiles"), P(), P(), P()),
            out_specs=(P("tiles"), P("tiles"), P("tiles")),
            check_vma=False,  # while_loop carries start unvarying
        )(dirs, px, py, scene, eye, frame)

    color, emission, albedo = run(scene_r, dirs, px, py, camera.eye,
                                  jnp.asarray(frame, jnp.uint32), cfg)
    return color[:height], emission[:height], albedo[:height]
