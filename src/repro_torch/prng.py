"""Threefry-2x32 counter-based PRNG with the semantics of ``jax.random``
(jax 0.9, ``jax_threefry_partitionable=True``, legacy uint32 keys).

A key is an int64 tensor of shape (..., 2) holding two uint32 words.
Torch has no full uint32 arithmetic, so every word lives in an int64
masked to 32 bits; the products of the rotations stay below 2**61.  The
functions reproduce jax's bits exactly, which is what lets the port's
token streams be compared with the reference's one for one.

Randomness in the port comes only from these explicit keys: nothing
here touches torch's global generator.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = 1.1754943508222875e-38


def fma(a, b, c):
    """a * b + c rounded once, as XLA contracts it (a: float32 tensor; b,
    c: float32 tensors or Python floats holding float32 values).  The
    product of two float32 values is exact in float64, so only the final
    sum rounds (to double, then to float; the double rounding differs
    from a true FMA only on exact ties of the float64 sum)."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts (x1, x2) under key
    (k1, k2); all int64 in [0, 2**32), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device="cuda"):
    """jax.random.PRNGKey with 64-bit types off: the seed is taken as a
    32-bit integer, so the key is (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key, data: int):
    """jax.random.fold_in for one key (2,) or a batch of keys (..., 2)."""
    zero = torch.zeros_like(key[..., 0])
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], zero,
                          zero + (int(data) & MASK))
    return torch.stack([y1, y2], -1)


def _iota(n: int, device):
    """The uint64 iota of jax's iota_2x32_shape, as (high, low) words."""
    c = torch.arange(n, dtype=torch.int64, device=device)
    return c >> 32, c & MASK


def split(key, num: int = 2):
    """jax.random.split: key (..., 2) -> (..., num, 2)."""
    hi, lo = _iota(num, key.device)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack([y1, y2], -1)


def random_bits(key, shape):
    """32 random bits per element: key (..., 2) -> (..., *shape) int64."""
    n = 1
    for s in shape:
        n *= s
    hi, lo = _iota(n, key.device)
    y1, y2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return (y1 ^ y2).reshape(key.shape[:-1] + tuple(shape))


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """jax.random.uniform in float32: the 23 high bits as a mantissa in
    [1, 2), minus one, scaled and clamped at minval."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(fma(f, float(hi - lo), float(lo)), min=float(lo))


def gumbel(key, shape):
    """jax.random.gumbel, mode "low": -log(-log(u)), u in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY_F32, 1.0)))


def categorical(key, logits):
    """jax.random.categorical over the last axis: argmax of Gumbel noise
    plus logits.  key (..., 2) with leading axes matching logits' batch
    axes (one key per row, as under jax.vmap)."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def randint(key, shape, minval: int, maxval: int):
    """jax.random.randint to int32 (two 32-bit draws combined modulo the
    span, uint32 wrap-around included)."""
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = max(int(maxval) - int(minval), 1) & MASK
    m = (2 ** 16) % span
    mult = ((m * m) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    return (off + int(minval)).to(torch.int32)
