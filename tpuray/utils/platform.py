"""Platform decision and compile-cache set-up.

`platform()` is the one place the program asks where it runs: it decides
the traversal path (integrator/path_tracer.trace).
"""
from __future__ import annotations

import os
import pathlib

import jax

_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def platform() -> str:
    """"gpu" or "cpu": the platform of the default device, which a
    `jax.default_device(...)` context overrides. Any other platform raises:
    the program has kernels for NVIDIA GPUs only."""
    dev = jax.config.jax_default_device
    if dev is None:
        name = jax.default_backend()
    else:
        name = dev if isinstance(dev, str) else dev.platform
    if name in ("gpu", "cuda"):
        return "gpu"
    if name == "cpu":
        return "cpu"
    raise RuntimeError(
        f"unsupported JAX platform {name!r}: tpuray runs on an NVIDIA GPU "
        "or on the CPU")


def compile_cache_dir() -> str:
    """$JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.
    Where JAX_COMPILATION_CACHE_DIR is set JAX already reads it, so only the
    fallback path is set here."""
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
