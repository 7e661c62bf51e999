"""One generator for every traffic file: a closed loop of edge devices,
each holding one generation at a time and sending its next request the
moment the last one ends.

The lengths are a fixed multiset that the file states (``multiset``
evenly spaced prompt lengths over the prompt range, as many output
lengths over the output range, paired by a fixed stride), the same for
every device and every seed.  Each device walks the multiset in one
fixed order that interleaves short and long requests, from its own
starting point.  Every device's first request is admitted in set-up with
a residual output length, spread evenly over 1 to its drawn length
across the fleet, so completions do not come in waves when the window
opens.  The pairs of (starting point, residual rank) are fixed; ``--seed``
only deals them to the devices and draws the token ids and the request
seeds, so the work a window holds does not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    device: int
    prompt: np.ndarray         # int64 token ids
    out_len: int               # tokens to deliver
    seed: int                  # the request's seed for the system's keys


def lengths(lo: int, hi: int, n: int) -> np.ndarray:
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def multiset(traffic: dict) -> List[tuple]:
    """The (prompt length, output length) pairs every device draws from."""
    n = int(traffic["multiset"])
    p = lengths(traffic["prompt_tokens"]["min"],
                traffic["prompt_tokens"]["max"], n)
    o = lengths(traffic["output_tokens"]["min"],
                traffic["output_tokens"]["max"], n)
    stride = _coprime_stride(n)
    return [(int(p[i]), int(o[(i * stride) % n])) for i in range(n)]


def _coprime_stride(n: int) -> int:
    s = max(1, int(round(n * 0.618)))
    while np.gcd(s, n) != 1:
        s += 1
    return s


class Fleet:
    """Each device's request list, drawn from the seed in set-up."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        rng = np.random.default_rng(seed)
        self.n = int(traffic["devices"])
        base = multiset(traffic)
        m = len(base)
        order = spread_order(m)
        stride = _coprime_stride(self.n)
        profile = rng.permutation(self.n)     # the seed deals the profiles
        self.lists: List[List[Request]] = []
        for d in range(self.n):
            reqs = []
            j = int(profile[d])
            start = j * m // self.n
            for i in range(m):
                plen, olen = base[order[(start + i) % m]]
                if i == 0:
                    olen = residual(olen, (j * stride) % self.n, self.n)
                reqs.append(Request(
                    d, rng.integers(0, vocab, size=plen, dtype=np.int64),
                    olen, int(rng.integers(0, 2 ** 31 - 1))))
            self.lists.append(reqs)
        self.next_index = [0] * self.n

    def next(self, device: int) -> Request:
        """The device's next request (its list cycles)."""
        i = self.next_index[device]
        self.next_index[device] += 1
        reqs = self.lists[device]
        return reqs[i % len(reqs)]


def spread_order(m: int) -> List[int]:
    """0..m-1 by the radical inverse in base 2, so that any run of
    consecutive entries covers the range evenly."""
    def inv(i):
        r, f = 0.0, 0.5
        while i:
            r += f * (i & 1)
            i >>= 1
            f /= 2
        return r
    return sorted(range(m), key=inv)


def residual(out_len: int, rank: int, n: int) -> int:
    """The output left of a request already under way when the window
    opens: the rank-th of n points spread evenly over 1..out_len."""
    return max(1, min(out_len, int(np.ceil((rank + 0.5) / n * out_len))))
