"""Theorem 1 instrumentation: per-token decomposition of the rejection
bound into SLM–LLM discrepancy and SLQ distortion, plus the exact
rejection probability TV(q̂, p) (eq. 14–15).  Mirrors
``repro.core.theory`` on torch tensors."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.slq import tv_distance


class Thm1Terms(NamedTuple):
    mismatch: torch.Tensor     # TV(q, p)              — model discrepancy
    dropped: torch.Tensor      # α_n(X_n)              — sparsification
    lattice: torch.Tensor      # K_n / (4 ℓ_n)         — quantization
    exact_rej: torch.Tensor    # TV(q̂, p)             — true P(reject)


def thm1_terms(q, p, q_hat, dropped, K, ell) -> Thm1Terms:
    """All inputs per-token (leading axes broadcast): q, p, q_hat (..., V);
    dropped, K scalars/(...).  Arrays (numpy or torch) become float32
    tensors."""
    f32 = dict(dtype=torch.float32)
    return Thm1Terms(
        mismatch=tv_distance(torch.as_tensor(q), torch.as_tensor(p)),
        dropped=torch.as_tensor(dropped, **f32),
        lattice=torch.as_tensor(K, **f32) / (4.0 * ell),
        exact_rej=tv_distance(torch.as_tensor(q_hat), torch.as_tensor(p)),
    )


def thm1_bound_total(terms: Thm1Terms):
    """Upper bound Σ (mismatch + dropped + lattice) vs Σ exact, summed in
    float64.  The reference sums in float32, which at full width stops
    reconciling: with K = V = 151936 each position's lattice term is
    ~380, and the float32 total of a round's ~30 positions rounds by
    ~1e-3, past ``DecompTracker.reconcile``'s 1e-4."""
    ub = (terms.mismatch.double() + terms.dropped.double()
          + terms.lattice.double()).sum()
    exact = terms.exact_rej.double().sum()
    return exact, ub
