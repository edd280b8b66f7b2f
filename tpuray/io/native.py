"""ctypes bindings to the native host library (tpuray/native/tpuray_native.cpp).

The shared object is built on first import with g++ (no pybind11 in this
environment); every entry point has a pure-numpy fallback in
tpuray.io.fallback, selected automatically if the toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libtpuray_native.so"
_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build_so() -> bool:
    """Compile into a private file, then rename it into place, so processes
    that build at once never load a half-written library."""
    tmp = _SO_PATH.with_name(f"{_SO_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-s", f"OUT={tmp.name}"],
            cwd=_NATIVE_DIR, check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not _SO_PATH.exists() and not _build_so():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_SO_PATH))
        except OSError:
            _lib_failed = True
            return None
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        c_u8_p = ctypes.POINTER(ctypes.c_uint8)

        lib.tr_obj_parse.restype = ctypes.c_void_p
        lib.tr_obj_parse.argtypes = [ctypes.c_char_p]
        lib.tr_obj_counts.argtypes = [ctypes.c_void_p, c_int_p, c_int_p, c_int_p]
        lib.tr_obj_fill.argtypes = [ctypes.c_void_p, c_float_p, c_float_p, c_int_p, c_int_p]
        lib.tr_obj_free.argtypes = [ctypes.c_void_p]

        lib.tr_hdr_read.restype = ctypes.c_void_p
        lib.tr_hdr_read.argtypes = [ctypes.c_char_p]
        lib.tr_hdr_counts.argtypes = [ctypes.c_void_p, c_int_p, c_int_p]
        lib.tr_hdr_fill.argtypes = [ctypes.c_void_p, c_float_p]
        lib.tr_hdr_free.argtypes = [ctypes.c_void_p]
        lib.tr_hdr_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, c_float_p]

        lib.tr_bmp_read.restype = ctypes.c_void_p
        lib.tr_bmp_read.argtypes = [ctypes.c_char_p]
        lib.tr_bmp_counts.argtypes = [ctypes.c_void_p, c_int_p, c_int_p]
        lib.tr_bmp_fill.argtypes = [ctypes.c_void_p, c_u8_p]
        lib.tr_bmp_free.argtypes = [ctypes.c_void_p]

        lib.tr_bvh_build.restype = ctypes.c_void_p
        lib.tr_bvh_build.argtypes = [c_float_p, ctypes.c_int, ctypes.c_int]
        lib.tr_bvh_counts.argtypes = [ctypes.c_void_p, c_int_p, c_int_p]
        lib.tr_bvh_fill.argtypes = [ctypes.c_void_p, c_float_p, c_float_p, c_int_p, c_int_p, c_int_p, c_int_p]
        lib.tr_bvh_free.argtypes = [ctypes.c_void_p]

        lib.tr_env_cache.restype = ctypes.c_int
        lib.tr_env_cache.argtypes = [c_float_p, ctypes.c_int, ctypes.c_int, c_float_p]
        _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def parse_obj_native(path: str):
    """-> (positions (nv,3) f32, texcoords (nt,2) f32, face_v (nf,3) i32,
    face_vt (nf,3) i32 with -1 = no uv), or None if native lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_obj_parse(str(path).encode())
    if not h:
        raise FileNotFoundError(f"cannot parse obj: {path}")
    try:
        nv, nt, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.tr_obj_counts(h, ctypes.byref(nv), ctypes.byref(nt), ctypes.byref(nf))
        pos = np.empty((nv.value, 3), np.float32)
        uv = np.empty((max(nt.value, 1), 2), np.float32)
        fv = np.empty((nf.value, 3), np.int32)
        fvt = np.empty((nf.value, 3), np.int32)
        lib.tr_obj_fill(h, _fp(pos), _fp(uv), _ip(fv), _ip(fvt))
        return pos, uv[: nt.value], fv, fvt
    finally:
        lib.tr_obj_free(h)


def read_hdr_native(path: str):
    """-> (h, w, 3) float32 linear RGB, or None if native lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_hdr_read(str(path).encode())
    if not h:
        raise IOError(f"cannot read hdr: {path}")
    try:
        w, ht = ctypes.c_int(), ctypes.c_int()
        lib.tr_hdr_counts(h, ctypes.byref(w), ctypes.byref(ht))
        rgb = np.empty((ht.value, w.value, 3), np.float32)
        lib.tr_hdr_fill(h, _fp(rgb))
        return rgb
    finally:
        lib.tr_hdr_free(h)


def write_hdr_native(path: str, rgb: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    rgb = np.ascontiguousarray(rgb, np.float32)
    r = lib.tr_hdr_write(str(path).encode(), rgb.shape[1], rgb.shape[0], _fp(rgb))
    return r == 0


def read_bmp_native(path: str):
    """-> (h, w, 4) uint8 RGBA top-down, or None if native lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.tr_bmp_read(str(path).encode())
    if not h:
        raise IOError(f"cannot read bmp: {path}")
    try:
        w, ht = ctypes.c_int(), ctypes.c_int()
        lib.tr_bmp_counts(h, ctypes.byref(w), ctypes.byref(ht))
        rgba = np.empty((ht.value, w.value, 4), np.uint8)
        lib.tr_bmp_fill(h, rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return rgba
    finally:
        lib.tr_bmp_free(h)


def build_bvh_native(tri_verts: np.ndarray, leaf_size: int = 8):
    """tri_verts: (T, 3, 3) or (T, 9) float32 vertex positions.

    -> dict(aabb_min, aabb_max, first_tri, tri_count, skip, perm) or None.
    """
    lib = get_lib()
    if lib is None:
        return None
    v = np.ascontiguousarray(tri_verts.reshape(-1, 9), np.float32)
    t = v.shape[0]
    h = lib.tr_bvh_build(_fp(v), t, int(leaf_size))
    if not h:
        raise RuntimeError("bvh build failed")
    try:
        n_nodes, n_tris = ctypes.c_int(), ctypes.c_int()
        lib.tr_bvh_counts(h, ctypes.byref(n_nodes), ctypes.byref(n_tris))
        n = n_nodes.value
        amin = np.empty((n, 3), np.float32)
        amax = np.empty((n, 3), np.float32)
        first = np.empty((n,), np.int32)
        count = np.empty((n,), np.int32)
        skip = np.empty((n,), np.int32)
        perm = np.empty((t,), np.int32)
        lib.tr_bvh_fill(h, _fp(amin), _fp(amax), _ip(first), _ip(count), _ip(skip), _ip(perm))
        return dict(aabb_min=amin, aabb_max=amax, first_tri=first,
                    tri_count=count, skip=skip, perm=perm)
    finally:
        lib.tr_bvh_free(h)


def env_cache_native(rgb: np.ndarray):
    """-> (h, w, 3) float32 cache (sample_x, sample_y, pdf), or None."""
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.float32)
    ht, w = rgb.shape[:2]
    cache = np.empty((ht, w, 3), np.float32)
    r = lib.tr_env_cache(_fp(rgb), w, ht, _fp(cache))
    if r != 0:
        raise ValueError("env cache build failed (zero-luminance envmap?)")
    return cache
