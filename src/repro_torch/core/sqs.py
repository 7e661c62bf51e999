"""SQS sparsifiers: K-SQS (fixed top-K) and C-SQS (conformal threshold).

Given the edge SLM distribution q (B, V):
  1. select support X  (top-K rule, eq. (5) regime — or threshold rule,
     eq. (6):  X(β) = {x : q(x) ≥ β});
  2. renormalise onto X → q̃;
  3. lattice-quantise → q̂ (slq.lattice_quantize);
  4. the edge SAMPLES its draft token from q̂ (Quantize-and-Sample).

``sparsify_*`` return (q_hat, mask, dropped_mass, K) — everything the
conformal controller, bit accounting and verifier need.  Mirrors
``repro.core.sqs``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.slq import lattice_quantize, reciprocal


class SQSResult(NamedTuple):
    q_hat: torch.Tensor       # (B, V) quantized sparse distribution
    mask: torch.Tensor        # (B, V) support set X
    dropped: torch.Tensor     # (B,) α_n(X): mass outside the support
    K: torch.Tensor           # (B,) support cardinality


def softmax(x, dim: int = -1):
    """exp(x − max) / Σ exp(x − max), the formula of ``jax.nn.softmax``
    (``torch.softmax`` rounds differently)."""
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def flush_subnormal(x):
    """x with float32 subnormals set to 0, as XLA's CPU code (and the TPU)
    computes them: a tempered probability below 2^-126 is 0 there, and at
    T <= 0.2 such values decide which K-th value the top-K rule sees."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, 0.0, x)


def flushed_softmax(x):
    """``softmax(x)`` over the last axis with the exponentials and the
    probabilities flushed by ``flush_subnormal``: the SQS probabilities of
    both paths (``softmax_temp``, the kernels' twins and the kernels)."""
    e = flush_subnormal(torch.exp(x - x.amax(-1, keepdim=True)))
    return flush_subnormal(e / e.sum(-1, keepdim=True))


def softmax_temp(logits, temperature: float):
    """softmax(logits / T); the division by the constant T is the
    multiplication by its float32 reciprocal that XLA compiles it to, and
    the exponentials and probabilities flush subnormals as XLA's do."""
    t = max(float(np.float32(temperature)), 1e-4)
    return flushed_softmax(logits.float() * reciprocal(t))


def _renormalize(q, mask):
    qm = torch.where(mask, q, 0.0)
    s = qm.sum(-1, keepdim=True)
    return qm / s.clamp_min(1e-30)


def sparsify_topk(q, K: int, ell: int) -> SQSResult:
    """K-SQS: keep the K largest-probability tokens (fixed K): every q
    above the K-th value, and of the ties at it the earliest by index
    (``lax.top_k``'s index set).  The reference keeps the first K of
    q >= kth by index, which where fewer than K probabilities are nonzero
    keeps zeros and drops the whole mass (ROADMAP Queue 3 item 12); on
    every other row the two agree."""
    V = q.shape[-1]
    K = min(K, V)
    kth = torch.topk(q, K, dim=-1).values[..., -1:]     # (B, 1)
    above = q > kth
    tie = q == kth
    room = K - above.sum(-1, keepdim=True)
    mask = above | (tie & (torch.cumsum(tie.to(torch.int32), -1) <= room))
    dropped = torch.where(mask, 0.0, q).sum(-1)
    q_hat, _ = lattice_quantize(_renormalize(q, mask), ell, mask)
    return SQSResult(q_hat, mask, dropped, mask.sum(-1).to(torch.int32))


def sparsify_threshold(q, beta, ell: int) -> SQSResult:
    """C-SQS support rule, eq. (6): X(β) = {x : q(x) ≥ β}.  The argmax
    token is always kept so the support is never empty."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=q.device)
    if beta.dim() == q.dim() - 1:
        beta = beta[..., None]
    mask = q >= beta
    top1 = torch.zeros_like(mask)
    top1.scatter_(-1, q.argmax(-1, keepdim=True), True)
    mask = mask | top1
    dropped = torch.where(mask, 0.0, q).sum(-1)
    q_hat, _ = lattice_quantize(_renormalize(q, mask), ell, mask)
    return SQSResult(q_hat, mask, dropped, mask.sum(-1).to(torch.int32))


def dense_qs(q, ell: int) -> SQSResult:
    """Baseline [22]: quantize the FULL distribution (K = V)."""
    mask = torch.ones_like(q, dtype=torch.bool)
    q_hat, _ = lattice_quantize(q, ell, mask)
    V = q.shape[-1]
    lead = q.shape[:-1]
    return SQSResult(q_hat, mask,
                     torch.zeros(lead, dtype=torch.float32, device=q.device),
                     torch.full(lead, V, dtype=torch.int32, device=q.device))


def no_compression(q) -> SQSResult:
    """Baseline: uncompressed uplink (q̂ = q)."""
    mask = torch.ones_like(q, dtype=torch.bool)
    V = q.shape[-1]
    lead = q.shape[:-1]
    return SQSResult(q.float(), mask,
                     torch.zeros(lead, dtype=torch.float32, device=q.device),
                     torch.full(lead, V, dtype=torch.int32, device=q.device))
