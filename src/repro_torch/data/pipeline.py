"""Synthetic LM1B-stand-in data pipeline (DESIGN.md §8).

A seeded Zipf–Markov language: the next token follows a structured bigram
map (a fixed random permutation plus local jitter) with probability
``p_bigram``, otherwise a Zipfian unigram draw.  Small models learn the
unigram + part of the bigram structure; larger models learn more — which
produces the SLM↔LLM mismatch gradient the SD experiments need.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 512
    seq_len: int = 64
    batch: int = 16
    p_bigram: float = 0.65
    zipf_a: float = 1.2
    jitter: int = 4
    seed: int = 1234


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self.unigram = w / w.sum()
        # frequency-sorted ids (like BPE): id 0 most frequent
        self.rng = np.random.default_rng(cfg.seed + 1)

    def _next(self, prev):
        cfg = self.cfg
        n = prev.shape[0]
        use_bigram = self.rng.random(n) < cfg.p_bigram
        jit = self.rng.integers(-cfg.jitter, cfg.jitter + 1, n)
        big = (self.perm[prev] + jit) % cfg.vocab
        uni = self.rng.choice(cfg.vocab, size=n, p=self.unigram)
        return np.where(use_bigram, big, uni).astype(np.int32)

    def sample(self, batch=None, seq_len=None):
        """Returns tokens (B, S+1) int32 — inputs+labels layout."""
        cfg = self.cfg
        B = batch or cfg.batch
        S = (seq_len or cfg.seq_len) + 1
        out = np.empty((B, S), np.int32)
        out[:, 0] = self.rng.choice(cfg.vocab, size=B, p=self.unigram)
        for t in range(1, S):
            out[:, t] = self._next(out[:, t - 1])
        return out

    def batches(self, n_steps: int, batch=None, seq_len=None):
        for _ in range(n_steps):
            yield {"tokens": self.sample(batch, seq_len)}
