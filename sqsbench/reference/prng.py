"""Threefry-2x32 with the semantics of ``jax.random`` (legacy uint32 keys,
partitionable iota counts), in numpy.

The served system draws every random number from per-request keys
derived from the request seed the benchmark hands it.  The reference
derives the same keys and numbers from that seed, so it can judge a
sampled token against the noise that chose it.  A key is a (2,) uint32
array.
"""
from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of counts (x1, x2) under key
    (k1, k2); uint32 arrays, broadcast together."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 = np.asarray(x1, np.uint32) + ks[0]
        x2 = np.asarray(x2, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x1 = x1 + x2
                x2 = _rotl(x2, r) ^ x1
            x1 = x1 + ks[(i + 1) % 3]
            x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) with 64-bit types off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k, data: int) -> np.ndarray:
    y1, y2 = threefry2x32(k[0], k[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([y1, y2], np.uint32)


def split(k, num: int = 2) -> np.ndarray:
    """(num, 2) keys."""
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y1, y2], -1)


def bits(k, n: int) -> np.ndarray:
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return y1 ^ y2


def uniform(k, n: int, lo: float, hi: float) -> np.ndarray:
    """float32 uniforms in [lo, hi): 23 random bits as a mantissa, then
    one rounding of f * (hi - lo) + lo, clamped at lo."""
    f = ((bits(k, n) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(hi32 - lo32)
    out = (f.astype(np.float64) * span + float(lo32)).astype(np.float32)
    return np.maximum(out, lo32)


def gumbel(k, n: int, device) -> torch.Tensor:
    """Gumbel noise -log(-log(u)) in float32 on ``device``."""
    u = torch.from_numpy(uniform(k, n, TINY_F32, 1.0)).to(device)
    return -torch.log(-torch.log(u))


class EdgeKeys:
    """The edge's key chain for one request: one split per draft round,
    then one split per decode step inside it."""

    def __init__(self, seed: int):
        self.k = fold_in(key(seed), 0)

    def round_steps(self, n_steps: int):
        """The keys of the next round's decode steps."""
        nxt, kd = split(self.k)
        self.k = nxt
        steps = []
        for _ in range(n_steps):
            kd, k1 = split(kd)
            steps.append(k1)
        return steps


class CloudKeys:
    """The cloud's key chain for one request: one split per verify."""

    def __init__(self, seed: int):
        self.k = fold_in(fold_in(key(seed), 0), 0x0C10)

    def next_round(self):
        """(key of the accept uniforms, key of the resample noise)."""
        nxt, kv = split(self.k)
        self.k = nxt
        kk = split(kv)
        return kk[0], kk[1]
