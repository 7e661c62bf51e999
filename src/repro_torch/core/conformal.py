"""Online conformal threshold control for C-SQS (paper §3).

Update rule, eq. (8):    β_{n+1} = β_n − η · (Σ_{x∉X_n} q_n(x) − α)

Checkpoint / backtracking (Algorithm 1, lines 12–13): after cloud
feedback only the updates belonging to accepted tokens (plus the one
resampled/bonus token) are kept: β at index min(T+1, L) of the drafted
trajectory (``backtrack``), or, the way the engine does it, β_T from the
wire trajectory, returned by the cloud (``backtrack_wire``).  Mirrors
``repro.core.conformal``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.prng import fma


class ConformalConfig(NamedTuple):
    alpha: float = 5e-4        # target average dropped mass
    eta: float = 1e-3          # learning rate
    beta0: float = 1e-3        # initial threshold β₁¹


def update(beta, dropped_mass, alpha: float, eta: float):
    """eq. (8).  beta, dropped_mass: (B,) float32.  The reference's jitted
    update contracts to one fused multiply-add, so the port rounds once
    too: β's float32 bits ride the wire."""
    d = dropped_mass.float() - float(np.float32(alpha))
    return fma(d, float(np.float32(-eta)), beta.float())


def backtrack(beta_traj, n_keep):
    """Device-side backtrack.  beta_traj: (L+1, B) thresholds recorded
    during drafting (row 0 the pre-batch value, row i the value after the
    i-th in-batch update); n_keep: (B,) updates to keep (accepted tokens +
    the resampled/bonus token), clipped to [0, L].  Returns β₁^{t+1}
    (B,)."""
    beta_traj = torch.as_tensor(beta_traj)
    L = beta_traj.shape[0] - 1
    idx = torch.as_tensor(n_keep, device=beta_traj.device).long()
    return beta_traj.gather(0, idx.clamp(0, L)[None, :])[0]


def backtrack_wire(betas, n_accept: int) -> float:
    """Host-side backtrack over a WIRE β trajectory: after T accepted
    drafts the cloud returns β_T (float32-exact, the value the edge
    recorded)."""
    assert 0 <= n_accept < len(betas), (n_accept, len(betas))
    return float(betas[n_accept])


def admit_rows(beta, fresh_mask, beta0: float):
    """Rows where ``fresh_mask`` is True restart at β₀; the others keep
    their in-flight threshold (β is per-request state)."""
    beta = torch.as_tensor(beta, dtype=torch.float32)
    fresh = torch.as_tensor(fresh_mask, dtype=torch.bool, device=beta.device)
    return torch.where(fresh, torch.tensor(beta0, dtype=torch.float32,
                                           device=beta.device), beta)


def thm2_bound(alpha: float, eta: float, beta0: float, T):
    """RHS of Theorem 2: α + (|β₁¹| + 1 + ηα)/(ηT), in float32 (torch's
    ``scalar / tensor`` multiplies by the reciprocal; the reference
    divides)."""
    T = torch.as_tensor(T, dtype=torch.float32)
    num = torch.tensor(abs(beta0) + 1.0 + eta * alpha, dtype=torch.float32)
    return alpha + num / (eta * T)


def beta_envelope(alpha: float, eta: float):
    """Lemma 4: β ∈ [−η(1−α), 1 + ηα] for all n (after burn-in from β₀
    inside the interval)."""
    return (-eta * (1.0 - alpha), 1.0 + eta * alpha)
