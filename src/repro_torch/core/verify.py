"""Speculative-decoding verification (cloud side), mirroring
``repro.core.verify`` with per-row keys.

Exact Leviathan-et-al. accept/resample against the *quantized* draft
distribution q̂ — the Quantize-and-Sample guarantee: the edge sampled
each draft token from q̂ and the cloud verifies against the same q̂, so
accepted + resampled tokens are distributed exactly as target samples.
Each row consumes only its own key, so a row's verdicts do not depend on
which other rows share the batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng


class VerifyResult(NamedTuple):
    n_accept: torch.Tensor      # (B,) T^t = accepted draft tokens
    new_token: torch.Tensor     # (B,) resampled (if rejected) or bonus token
    rejected: torch.Tensor      # (B,) bool: was a draft token rejected?
    accept_mask: torch.Tensor   # (B, L) which draft tokens were accepted


def verify(keys, draft_tokens, q_hat, p_dists, live=None) -> VerifyResult:
    """keys: (B, 2) per-row PRNG keys; draft_tokens: (B, L); q_hat:
    (B, L, V) quantized draft dists; p_dists: (B, L+1, V) target dists
    (p_dists[:, L] is the bonus dist); live: (B, L) bool — positions
    within the bit budget L^t."""
    B, L, V = q_hat.shape
    dev = q_hat.device
    if live is None:
        live = torch.ones((B, L), dtype=torch.bool, device=dev)
    kk = prng.split(keys, 2)                             # (B, 2, 2)
    u = prng.uniform(kk[:, 0], (L,), 1e-12, 1.0)         # (B, L)
    tok = draft_tokens.long()[..., None]
    q_tok = torch.gather(q_hat, -1, tok)[..., 0]
    p_tok = torch.gather(p_dists[:, :L], -1, tok)[..., 0]
    ratio = p_tok / torch.clamp(q_tok, min=1e-30)
    ok = (u < torch.clamp(ratio, max=1.0)) & live
    prefix = torch.cumprod(ok.to(torch.int32), -1)       # (B, L)
    n_accept = prefix.sum(-1)
    rejected = n_accept < live.to(torch.int32).sum(-1)

    # distribution at the boundary position T (0-indexed into L+1)
    rows = torch.arange(B, device=dev)
    p_T = p_dists[rows, n_accept]                        # (B, V)
    q_pad = torch.cat([q_hat, torch.zeros((B, 1, V), dtype=q_hat.dtype,
                                          device=dev)], 1)
    q_T = q_pad[rows, n_accept]
    residual = torch.clamp(p_T - q_T, min=0.0)
    rs = residual.sum(-1, keepdim=True)
    residual = torch.where(rs > 1e-30, residual / torch.clamp(rs, min=1e-30),
                           p_T)
    dist = torch.where(rejected[:, None], residual, p_T)
    logp = torch.log(torch.clamp(dist, min=1e-30))
    new_token = prng.categorical(kk[:, 1], logp)
    return VerifyResult(n_accept.to(torch.int32), new_token.to(torch.int32),
                        rejected, prefix.bool())


def acceptance_prob(q_hat, p):
    """Per-position acceptance probability 1 − TV(q̂, p) (eq. 14)."""
    return 1.0 - 0.5 * (q_hat.float() - p.float()).abs().sum(-1)
