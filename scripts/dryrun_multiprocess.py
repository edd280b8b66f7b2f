"""Multi-PROCESS dryrun: N OS processes, loopback coordinator, CPU backend.

Validates the jax.distributed entry path (tpuray.dist.multihost) that a real
multi-host deployment would use: every process initializes the
distributed runtime, builds ONE global mesh over all processes' devices,
and runs the mesh-parallel differentiable train step (rows sharded across
processes, gradient psum over what would be the network) — asserting the loss is
finite and bit-identical on every process.

Usage: python scripts/dryrun_multiprocess.py [n_processes]
(The single-container analogue of `srun python train.py` on a cluster.)
"""
from __future__ import annotations

import os
import subprocess
import sys
import pathlib


def worker(n_proc: int, pid: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)

    from tpuray.dist import multihost
    is_multi = multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_proc, process_id=pid)
    assert is_multi == (n_proc > 1)
    assert jax.process_count() == n_proc, jax.process_count()
    assert jax.device_count() == n_proc

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpuray.scene.procedural import make_test_scene
    from tpuray.scene.camera import OrbitCamera
    from tpuray.scene.config import RenderConfig
    from tpuray.train.optimize import make_sharded_train_step, split_trainable

    h = 8 * n_proc
    w = 16
    scene = make_test_scene(subdiv=1, env_width=32)
    cfg = RenderConfig(width=w, height=h, max_tracing_depth=1,
                       num_atrous_iterations=2)
    cam = OrbitCamera(width=w, height=h).snapshot()
    mesh = multihost.global_mesh()

    params, rebuild = split_trainable(scene)
    init, step = make_sharded_train_step(rebuild, cfg, h, w, mesh)
    # multi-controller rule: replicated inputs are passed as host-local
    # numpy (identical on every process); sharded inputs are global Arrays
    # assembled from per-process shards
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = to_np(init(params))
    cam = to_np(cam)

    target = jax.make_array_from_callback(
        (h, w, 3), NamedSharding(mesh, P("tiles")),
        lambda idx: np.full((h // n_proc, w, 3), 0.25, np.float32))

    state, loss = step(state, target, cam, 0)
    loss_val = float(jax.device_get(loss))
    assert np.isfinite(loss_val), loss_val

    lo, hi = multihost.process_rows(h)
    assert 0 <= lo < hi <= h
    print(f"proc {pid}/{n_proc}: loss={loss_val:.9f} rows=[{lo},{hi})",
          flush=True)


def main() -> None:
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), int(sys.argv[i + 3]))
        return

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    port = 12421
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1]) + (
        os.pathsep + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", __file__, "--worker", str(n), str(p),
             str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(n)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    ok = all(p.returncode == 0 for p in procs)
    losses = set()
    for o in outs:
        for line in o.splitlines():
            if line.startswith("proc "):
                losses.add(line.split("loss=")[1].split()[0])
                print(line)
    if not ok:
        for o in outs:
            print(o[-3000:])
        raise SystemExit("worker failed")
    assert len(losses) == 1, f"loss differs across processes: {losses}"
    print(f"dryrun_multiprocess({n}): ok, identical loss on all processes")


if __name__ == "__main__":
    main()
