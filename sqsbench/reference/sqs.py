"""Plain SQS from the paper: support selection (K-SQS: the K most probable
tokens; C-SQS: every token with q >= beta, the most probable always),
renormalisation onto the support, and resolution-ell lattice quantisation
(Algorithm 2: nearest counts, then the sum corrected to ell by the
rounding residues).  One row at a time, float32."""
from __future__ import annotations

import torch


def lattice(q_tilde: torch.Tensor, ell: int, mask: torch.Tensor) -> torch.Tensor:
    """Integer counts b (V,) with sum ell, b = 0 off the support."""
    b = torch.where(mask, torch.floor(ell * q_tilde + 0.5), 0.0)
    zeta = b - ell * q_tilde
    delta = int(b.sum().item()) - ell
    if delta > 0:
        cand = mask & (b > 0)
        order = torch.argsort(torch.where(cand, -zeta, torch.inf), stable=True)
        b[order[:delta]] -= 1
    elif delta < 0:
        order = torch.argsort(torch.where(mask, zeta, torch.inf), stable=True)
        b[order[:-delta]] += 1
    return b


def select(q: torch.Tensor, method: str, K: int, beta: float):
    """The support mask of one row q (V,)."""
    if method == "ksqs":
        kth = torch.topk(q, min(K, q.numel())).values[-1]
        above, tie = q > kth, q == kth
        room = min(K, q.numel()) - int(above.sum().item())
        return above | (tie & (torch.cumsum(tie.int(), 0) <= room))
    mask = q >= beta
    mask[q.argmax()] = True
    return mask


def sqs(q: torch.Tensor, method: str, K: int, beta: float, ell: int):
    """(counts (V,), dropped mass) of one row."""
    mask = select(q, method, K, beta)
    qm = torch.where(mask, q, 0.0)
    dropped = float((q - qm).sum().item())
    return lattice(qm / qm.sum().clamp_min(1e-30), ell, mask), dropped


def beta_update(beta: float, dropped: float, alpha: float, eta: float) -> float:
    """eq. (8), rounded once to float32."""
    import numpy as np
    d = float(np.float32(np.float32(dropped) - np.float32(alpha)))
    return float(np.float32(d * float(np.float32(-eta)) + beta))
