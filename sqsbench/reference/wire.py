"""Decoder of the v1 wire format (fixed-width fields, MSB first), written
from its published layout:

    draft   := n:w(L) tokens:n*w(V-1)
               { K:w(V) [idx:w(V-1)]*K cnt:w(ell)*K }*n  beta:32*(n+1)
    verdict := T:w(L) token:w(V-1) beta:32

where w(m) is the bit length of m (at least 1) and a support of all V
entries carries no index list.  The reference reads the served payloads
with it to judge them; it shares no code with the system.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def width(max_value: int) -> int:
    return max(int(max_value).bit_length(), 1)


class _Bits:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.at = 0

    def read(self, w: int, count: int = 1) -> np.ndarray:
        chunk = self.bits[self.at:self.at + w * count]
        if chunk.size != w * count:
            raise ValueError("payload truncated")
        self.at += w * count
        weights = np.uint64(1) << np.arange(w - 1, -1, -1, dtype=np.uint64)
        return (chunk.reshape(count, w).astype(np.uint64) * weights).sum(1)

    def f32(self, count: int) -> np.ndarray:
        return self.read(32, count).astype(np.uint32).view(np.float32)

    def end(self):
        """Only the last byte's padding may follow the last field."""
        if self.bits.size - self.at >= 8:
            raise ValueError("bytes past the payload's last field")


@dataclasses.dataclass
class Draft:
    tokens: List[int]
    supports: List[np.ndarray]     # int64 indices with a count > 0
    counts: List[np.ndarray]       # lattice counts, summing to ell
    betas: np.ndarray              # float32, n + 1 entries


@dataclasses.dataclass
class Verdict:
    n_accept: int
    token: int
    beta: float


def decode_draft(data: bytes, V: int, ell: int, L_max: int) -> Draft:
    r = _Bits(data)
    n = int(r.read(width(L_max))[0])
    if n > L_max:
        raise ValueError("draft count above L_max")
    tw = width(V - 1)
    tokens = [int(t) for t in r.read(tw, n)]
    if any(t >= V for t in tokens):
        raise ValueError("draft token out of the vocabulary")
    supports, counts = [], []
    for _ in range(n):
        k = int(r.read(width(V))[0])
        if k > V:
            raise ValueError("support larger than the vocabulary")
        sup = (np.arange(V, dtype=np.int64) if k == V
               else r.read(tw, k).astype(np.int64))
        cnt = r.read(width(ell), k).astype(np.int64)
        if (sup.size and sup.max() >= V) or np.unique(sup).size != k \
                or cnt.sum() != ell:
            raise ValueError("support or counts malformed")
        supports.append(sup)
        counts.append(cnt)
    betas = r.f32(n + 1)
    r.end()
    return Draft(tokens, supports, counts, betas)


def decode_verdict(data: bytes, V: int, L_max: int) -> Verdict:
    r = _Bits(data)
    n_accept = int(r.read(width(L_max))[0])
    token = int(r.read(width(V - 1))[0])
    beta = float(r.f32(1)[0])
    r.end()
    if n_accept > L_max or token >= V:
        raise ValueError("verdict out of range")
    return Verdict(n_accept, token, beta)
