"""Counter-free GPU-style RNG, re-implemented in uint32 jnp.

Semantics match the reference sampler suite (path_tracing.frag:433-515):
 - per-pixel Wang-hash stream seeded by (pixel coords, frame counter)
 - Sobol (dims 0..7, 32-bit direction numbers) with Gray-code index,
   shared by all pixels of a frame (it depends only on frame+bounce)
 - Cranley-Patterson rotation decorrelating the Sobol point per pixel.

All hashing is done with explicit uint32 arrays, which XLA lowers to plain
integer ops. The stream is functional: each draw returns (value, next_state).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

Array = jax.Array

_U32 = jnp.uint32
_INV_U32 = np.float32(1.0 / 4294967296.0)  # rand() = hash / 2^32


def pixel_seed(px: Array, py: Array, frame: Array | int) -> Array:
    """Initial Wang-hash stream state for each pixel.

    Matches `seed` init (path_tracing.frag:433-436):
      (px*1973 + py*9277 + frame*26699) | 1
    px/py are integer pixel coordinates (the GLSL computes them from NDC).
    """
    px = px.astype(_U32)
    py = py.astype(_U32)
    f = jnp.asarray(frame, _U32)
    s = px * _U32(1973) + py * _U32(9277) + f * _U32(26699)
    return s | _U32(1)


def wang_hash(seed: Array) -> tuple[Array, Array]:
    """One Wang-hash step (path_tracing.frag:438-445). Returns (bits, next_seed)."""
    seed = seed.astype(_U32)
    seed = (seed ^ _U32(61)) ^ (seed >> _U32(16))
    seed = seed * _U32(9)
    seed = seed ^ (seed >> _U32(4))
    seed = seed * _U32(0x27D4EB2D)
    seed = seed ^ (seed >> _U32(15))
    return seed, seed


def rand(seed: Array) -> tuple[Array, Array]:
    """Uniform [0,1) float from the stream; returns (u, next_seed)."""
    bits, seed = wang_hash(seed)
    return bits.astype(jnp.float32) * _INV_U32, seed


def rand_sync_seed(width: int, height: int) -> np.uint32:
    """Frame-synchronized stream seed (path_tracing.frag:451-455).

    The reference zeroes the pixel coordinates so every fragment shares one
    stream: seed = (0.5*width)*1973 + (0.5*height)*9277 + 114514*26699, |1.
    Carried in the reference as dead code; exposed here for parity."""
    s = (np.uint32(width // 2) * np.uint32(1973)
         + np.uint32(height // 2) * np.uint32(9277)
         + np.uint32(114514) * np.uint32(26699))
    return np.uint32(s | np.uint32(1))


def rand_sync(width: int, height: int) -> float:
    """One draw from the synchronized stream (path_tracing.frag:457-458)."""
    bits, _ = wang_hash(jnp.asarray(rand_sync_seed(width, height), _U32))
    return float(bits.astype(jnp.float32) * _INV_U32)


def _radical_inverse(i: np.ndarray, base: int) -> np.ndarray:
    inv = np.zeros(i.shape, np.float64)
    f = 1.0 / base
    i = i.copy()
    while np.any(i > 0):
        inv += f * (i % base)
        i //= base
        f /= base
    return inv


def halton_2_3(n: int = 8) -> np.ndarray:
    """(n, 2) Halton base-(2,3) points.

    The reference embeds a constant table (Halton_2_3,
    path_tracing.frag:38-47 — unused) whose rows are Halton(i) for
    i = 8..1 descending; `halton_2_3(8)[::-1]` reproduces it exactly.
    Generated from the radical-inverse recurrence, not transcribed."""
    i = np.arange(1, n + 1)
    return np.stack([_radical_inverse(i, 2),
                     _radical_inverse(i, 3)], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# Sobol direction numbers, dims 1..8 (path_tracing.frag:463-472). These are
# the standard Joe-Kuo direction numbers; first dim is the van der Corput
# radical inverse. Regenerated here from the recurrences rather than copied.
# ---------------------------------------------------------------------------

# (s, a, m_i) per dimension from the Joe-Kuo D(6) table (public domain):
_JOE_KUO = [
    None,                      # dim 0: van der Corput
    (1, 0, [1]),               # dim 1
    (2, 1, [1, 3]),            # dim 2
    (3, 1, [1, 3, 1]),         # dim 3
    (3, 2, [1, 1, 1]),         # dim 4
    (4, 1, [1, 1, 3, 3]),      # dim 5
    (4, 4, [1, 3, 5, 13]),     # dim 6
    (5, 2, [1, 1, 5, 5, 17]),  # dim 7
]


def _sobol_matrices(n_dims: int = 8, n_bits: int = 32) -> np.ndarray:
    """Generate direction numbers V[d, j] (as uint32, MSB-aligned)."""
    V = np.zeros((n_dims, n_bits), dtype=np.uint64)
    # dim 0: V[j] = 2^(31-j)
    for j in range(n_bits):
        V[0, j] = np.uint64(1) << np.uint64(31 - j)
    for d in range(1, n_dims):
        s, a, m = _JOE_KUO[d]
        v = np.zeros(n_bits, dtype=np.uint64)
        for j in range(s):
            v[j] = np.uint64(m[j]) << np.uint64(31 - j)
        for j in range(s, n_bits):
            v[j] = v[j - s] ^ (v[j - s] >> np.uint64(s))
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    v[j] ^= v[j - k]
        V[d] = v
    return V.astype(np.uint32)


SOBOL_V = _sobol_matrices()  # (8, 32) uint32


def gray_code(i: Array | int) -> Array:
    i = jnp.asarray(i, _U32)
    return i ^ (i >> _U32(1))


def sobol(dim: int, index: Array | int) -> Array:
    """Scalar Sobol sample: dimension `dim` (static int 0..7), integer index.

    Matches path_tracing.frag:480-488 (XOR of direction numbers over set bits).
    """
    index = jnp.asarray(index, _U32)
    result = jnp.zeros_like(index)
    for j in range(32):  # static unroll; direction numbers are compile-time consts
        bit = (index >> _U32(j)) & _U32(1)
        result = result ^ jnp.where(bit == _U32(1), _U32(int(SOBOL_V[dim, j])), _U32(0))
    return result.astype(jnp.float32) * np.float32(1.0 / 0xFFFFFFFF)


def sobol_vec2(frame: Array | int, bounce: int) -> Array:
    """The per-(frame,bounce) 2D Sobol point (path_tracing.frag:491-495).

    Shared by every pixel; Cranley-Patterson rotation individualizes it.
    """
    idx = gray_code(frame)
    u = sobol(2 * bounce, idx)
    v = sobol(2 * bounce + 1, idx)
    return jnp.stack([u, v])


def cranley_patterson_offsets(px: Array, py: Array) -> tuple[Array, Array]:
    """Per-pixel CPR offsets (path_tracing.frag:497-515): a fixed
    2-draw Wang stream seeded by (px*1973 + py*9277 + 59*26699) | 1.
    (59 == 114514/1919 integer division in the reference.)
    """
    s = (px.astype(_U32) * _U32(1973)
         + py.astype(_U32) * _U32(9277)
         + _U32(59) * _U32(26699)) | _U32(1)
    u, s = rand(s)
    v, _ = rand(s)
    return u, v


def cranley_patterson_rotate(p: Array, off_u: Array, off_v: Array) -> tuple[Array, Array]:
    """Rotate a 2D low-discrepancy point by per-pixel offsets, wrapping to [0,1)."""
    x = p[0] + off_u
    y = p[1] + off_v
    x = jnp.where(x > 1.0, x - 1.0, x)
    x = jnp.where(x < 0.0, x + 1.0, x)
    y = jnp.where(y > 1.0, y - 1.0, y)
    y = jnp.where(y < 0.0, y + 1.0, y)
    return x, y
