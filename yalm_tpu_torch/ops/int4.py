"""Packed int4 weights: planar nibbles and per-group scales (the port's copy
of `int4_group`, `int4_supported`, `pack_int4` and `unpack_int4` from
`yalm_tpu/ops/pallas/gemv.py`, numpy only, so the bytes are the same).

Two int4 values pack per byte PLANAR WITHIN EACH GROUP of `group` unpacked
columns: byte t of a group holds column t in its low nibble and column
t + group/2 in its high nibble, offset 8 (0..15 = -8..7). Scales are
group-major, (..., G, N), and multiply each group's f32 partial product:

    y[n] = sum_g s[g, n] * sum_{k in g} x[k] * (q[n, k] - 8)
"""

from __future__ import annotations

import numpy as np


def int4_group(K: int) -> int:
    """Group width: 512 unpacked columns when K allows it, 256 otherwise.
    K must be a multiple of 256."""
    return 512 if K % 512 == 0 else 256


def int4_supported(N: int, K: int) -> bool:
    """The JAX package's tiling rule for its int4 kernels (kept for parity;
    the port's kernels need only K % 256 == 0)."""
    return K % 256 == 0 and (N % 128 == 0 or N <= 512)


def pack_int4(w, group: int = 0):
    """Quantize float weights (..., N, K) to planar-packed int4.

    Returns (packed uint8 (..., N, K//2), scales f32 (..., G, N)) with
    G = K // group. Symmetric per (row, group): s = max|w| / 7,
    q = clip(round(w / s), -8, 7) stored offset 8."""
    w = np.asarray(w, np.float32)
    K = w.shape[-1]
    group = group or int4_group(K)
    G, H = K // group, group // 2
    wg = w.reshape(*w.shape[:-1], G, group)
    s = np.abs(wg).max(axis=-1) / 7.0                    # (..., N, G)
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(wg / s[..., None]), -8, 7).astype(np.int8) + 8
    lo, hi = q[..., :H], q[..., H:]                      # (..., N, G, H)
    packed = (lo | (hi << 4)).astype(np.uint8)
    packed = packed.reshape(*w.shape[:-1], K // 2)
    scales = np.moveaxis(s, -1, -2).copy()               # (..., G, N)
    return packed, np.ascontiguousarray(scales, dtype=np.float32)


def unpack_int4(packed, scales, group: int = 0):
    """Dequantize back to f32 (..., N, K)."""
    packed = np.asarray(packed)
    K = packed.shape[-1] * 2
    group = group or int4_group(K)
    G, H = K // group, group // 2
    p = packed.reshape(*packed.shape[:-1], G, H)
    lo = (p & 0xF).astype(np.float32) - 8.0
    hi = (p >> 4).astype(np.float32) - 8.0
    q = np.concatenate([lo, hi], axis=-1)                # (..., N, G, group)
    s = np.moveaxis(np.asarray(scales, np.float32), -1, -2)  # (..., N, G)
    return (q * s[..., None]).reshape(*packed.shape[:-1], K)
