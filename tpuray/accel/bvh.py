"""BVH construction front-end.

Builds a sweep-SAH threaded BVH (DFS preorder + skip links) with the native
C++ builder (tpuray/native/tpuray_native.cpp) or the numpy oracle. See
tpuray.scene.types.BVHSoA for the traversal contract. Re-design of
Utils/BVH.h:42-173 (which emits child-pointer nodes for a stack traversal).
"""
from __future__ import annotations

import numpy as np

from tpuray.io import fallback, native

# the GPU traversal kernel packs a leaf's triangle count into 5 bits of its
# node record (kernels/trace_triton.py); both builders keep every leaf at
# or below leaf_size, so the limit is enforced here, on concrete input
MAX_LEAF_SIZE = 31


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 8, force_py: bool = False) -> dict:
    """tri_verts: (T, 3, 3) float32; 1 <= leaf_size <= MAX_LEAF_SIZE.

    Returns dict(aabb_min, aabb_max, first_tri, tri_count, skip, perm) as
    numpy arrays. `perm` maps new (leaf-order) index -> original triangle
    index; callers must reorder their triangle SoA with it.
    """
    if not 1 <= leaf_size <= MAX_LEAF_SIZE:
        raise ValueError(
            f"leaf_size {leaf_size} is outside [1, {MAX_LEAF_SIZE}]")
    tri_verts = np.ascontiguousarray(tri_verts, np.float32)
    out = None if force_py else native.build_bvh_native(tri_verts, leaf_size)
    if out is None:
        out = fallback.build_bvh_py(tri_verts, leaf_size)
    return out


def validate_bvh(bvh: dict, tri_verts: np.ndarray, leaf_size: int) -> None:
    """Structural invariants (used by tests and scene building)."""
    n = len(bvh["first_tri"])
    t = len(bvh["perm"])
    skip = bvh["skip"]
    count = bvh["tri_count"]
    first = bvh["first_tri"]
    assert skip[0] == n, "root skip must be the terminator"
    assert sorted(bvh["perm"].tolist()) == list(range(t)), "perm must be a permutation"
    covered = np.zeros(t, bool)
    for i in range(n):
        assert i < skip[i] <= n, f"skip[{i}]={skip[i]} out of range"
        if count[i] > 0:
            assert count[i] <= leaf_size
            covered[first[i]: first[i] + count[i]] = True
    assert covered.all(), "leaves must cover every triangle"
    # AABBs contain their triangles (in permuted order)
    v = tri_verts.reshape(-1, 3, 3)[bvh["perm"]]
    for i in range(n):
        if count[i] > 0:
            tv = v[first[i]: first[i] + count[i]]
            assert (tv.min(axis=(0, 1)) >= bvh["aabb_min"][i] - 1e-5).all()
            assert (tv.max(axis=(0, 1)) <= bvh["aabb_max"][i] + 1e-5).all()
