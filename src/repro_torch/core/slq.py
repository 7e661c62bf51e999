"""Sparse Lattice-based Quantization (paper Appendix A.1, Algorithm 2).

Maps a (sparsified, renormalised) probability vector onto the resolution-ℓ
lattice inside the probability simplex:  q̂[i] = b[i]/ℓ with Σ b[i] = ℓ,
b[i] non-negative integers.  Rounding is nearest-integer followed by the
ζ-ranked exact-sum correction of Algorithm 2 lines 8–16, in rank-select
form (mirrors ``repro.core.slq``).

Guarantee used by Theorem 1:  TV(q̃, q̂) ≤ K/(4ℓ).
"""
from __future__ import annotations

import numpy as np
import torch


def ranks(x):
    """rank[i] = position of x[i] in a stable ascending sort (0 =
    smallest; ties: earliest index first).  The sort must be stable:
    torch's default sort is not."""
    order = torch.argsort(x, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def lattice_quantize(q_tilde, ell: int, mask=None):
    """Algorithm 2 (lines 5-17), batched over leading axes.

    q_tilde: (..., V) renormalised sparse distribution (zero off-support).
    mask:    (..., V) bool support set; default = q_tilde > 0.
    Returns (q_hat, b) with q_hat = b/ℓ, Σ b = ℓ exactly, b int32 ≥ 0.
    """
    q = q_tilde.float()
    if mask is None:
        mask = q > 0
    b = torch.floor(ell * q + 0.5)                     # line 6
    b = torch.where(mask, b, 0.0)
    zeta = b - ell * q                                 # line 9 (ζ = b' − ℓq)
    delta = (b.sum(-1) - ell)[..., None]               # ℓ' − ℓ

    # Correction (lines 10-15):
    #   δ > 0: decrement the δ entries with LARGEST ζ (only b>0, on-support)
    #   δ < 0: increment the |δ| entries with SMALLEST ζ (on-support)
    pos = mask & (b > 0)
    zeta_dec = torch.where(pos, zeta, -torch.inf)
    zeta_inc = torch.where(mask, zeta, torch.inf)
    dec = (ranks(-zeta_dec) < delta) & pos
    inc = (ranks(zeta_inc) < -delta) & mask
    b = b - dec.float() + inc.float()
    return b * reciprocal(ell), b.to(torch.int32)


def reciprocal(c: float) -> float:
    """The float32 reciprocal of a constant (as a Python float holding the
    float32 value exactly).  XLA rewrites a division by a compile-time
    constant into a multiplication by this value, and the reference's
    q̂ = b/ℓ is jitted, so the port multiplies too."""
    return float(np.float32(1.0) / np.float32(c))


def slq_distortion_bound(K, ell):
    """Theorem 1's lattice-distortion term K/(4ℓ), float32."""
    return torch.as_tensor(K, dtype=torch.float32) / (4.0 * ell)


def tv_distance(p, q, dim=-1):
    """Total-variation distance 0.5 * sum |p - q| in float32."""
    return 0.5 * (p.float() - q.float()).abs().sum(dim)
