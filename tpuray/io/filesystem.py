"""Asset-root resolution.

Equivalent of the reference's FileSystem helper
(lib/filesystem.h:8-49), which resolves asset paths against a
CMake-configured root or the LOGL_ROOT_PATH env var. Here:

  resolve("models/clock.obj")

checks, in order:
  1. absolute paths / paths that already exist relative to CWD — returned
     as-is;
  2. the TPURAY_ASSET_ROOT environment variable (the LOGL_ROOT_PATH
     analogue);
  3. roots registered programmatically via add_root() (highest priority
     last);
  4. the checkout's assets/ directory.

Raises FileNotFoundError listing every root tried, instead of the
reference's hard exit(-1) (obj_loader.h:17).
"""
from __future__ import annotations

import os
from pathlib import Path

_ENV_VAR = "TPURAY_ASSET_ROOT"

# lowest-priority fallback: the assets shipped with the checkout
_DEFAULT_ROOTS = [str(Path(__file__).resolve().parents[2] / "assets")]

_extra_roots: list[str] = []


def add_root(root: str | os.PathLike) -> None:
    """Register an additional asset root (searched before the defaults,
    after TPURAY_ASSET_ROOT; most recently added wins)."""
    r = str(root)
    if r in _extra_roots:
        _extra_roots.remove(r)
    _extra_roots.insert(0, r)


def roots() -> list[str]:
    """Search order (first match wins)."""
    out = []
    env = os.environ.get(_ENV_VAR)
    if env:
        out.extend(env.split(os.pathsep))
    out.extend(_extra_roots)
    out.extend(_DEFAULT_ROOTS)
    return out


def resolve(rel_path: str | os.PathLike) -> str:
    """Resolve an asset path against the configured roots (see module doc)."""
    p = Path(rel_path)
    if p.is_absolute() or p.exists():
        return str(p)
    tried = []
    for root in roots():
        cand = Path(root) / p
        if cand.exists():
            return str(cand)
        tried.append(str(cand))
    raise FileNotFoundError(
        f"asset {rel_path!r} not found; tried: {', '.join(tried)} "
        f"(set ${_ENV_VAR} or tpuray.io.filesystem.add_root())")
