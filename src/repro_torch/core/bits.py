"""Uplink bit accounting (paper eqs. (1), (2), (5) + C-SQS overhead), the
packed wire's budget and codec v2's actuals, and the gap-coded subset
estimate (mirrors ``repro.core.bits``).

log2 C(n, k) at vocabulary scale involves lgamma(~1e5) ≈ 1e6, so the
tables are built in float64 with scipy on the host, rounded to float32
and moved to the device once per (table, device); only K varies at run
time.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy.special import gammaln


def _log2_binom_f64(n, k):
    n = np.asarray(n, np.float64)
    k = np.clip(np.asarray(k, np.float64), 0.0, n)
    return (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)) \
        / math.log(2.0)


@functools.lru_cache(maxsize=64)
def _subset_table(V: int):
    """log2 C(V, k) for k = 0..V, float32."""
    return _log2_binom_f64(V, np.arange(V + 1)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _payload_table(V: int, ell: int):
    """log2 C(ℓ + k − 1, k − 1) for k = 0..V, float32."""
    k = np.arange(V + 1, dtype=np.float64)
    t = _log2_binom_f64(ell + k - 1.0, np.maximum(k - 1.0, 0.0))
    t[0] = 0.0
    return t.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(name: str, args: tuple, device: str):
    table = {"subset": _subset_table, "payload": _payload_table}[name](*args)
    return torch.from_numpy(table).to(device)


def log2_binom(n, k) -> float:
    """float32-rounded log2 C(n, k) for host scalars."""
    return float(np.float32(_log2_binom_f64(n, k)))


def _lookup(name, args, K, size):
    table = _on_device(name, args, str(K.device))
    return table[K.to(torch.int64).clamp(0, size)]


def payload_bits(K, ell, V=None):
    """eq. (2): log2 C(ℓ + K − 1, K − 1).  K: a host number, or a tensor
    looked up in the table of size V (300000 when V is not given)."""
    if isinstance(K, (int, float)):
        return log2_binom(ell + K - 1.0, max(K - 1.0, 0.0))
    Vmax = int(V or 300000)
    return _lookup("payload", (Vmax, int(ell)), K, Vmax)


def subset_bits_topk(V: int, K):
    """eq. (5): K-SQS subset description, log2 C(V, K)."""
    if isinstance(K, (int, float)):
        return log2_binom(V, K)
    return _lookup("subset", (int(V),), K, V)


def subset_bits_conformal(V: int, K):
    """C-SQS: ⌈log2 C(V, K)⌉ + ⌈log2 V⌉ (subset + cardinality overhead)."""
    sub = subset_bits_topk(V, K)
    if isinstance(sub, float):
        return float(math.ceil(sub) + math.ceil(math.log2(V)))
    return torch.ceil(sub) + math.ceil(math.log2(V))


def token_bits(V: int, K, ell: int, adaptive: bool):
    """eq. (1): b = b̃(K) + b̂(K, ℓ) for one draft token (float32)."""
    sub = subset_bits_conformal(V, K) if adaptive else subset_bits_topk(V, K)
    pay = payload_bits(K, ell, V=V)
    if isinstance(sub, float) and isinstance(pay, float):
        return float(np.float32(sub) + np.float32(pay))
    return sub + pay


def dense_qs_bits(V: int, ell: int) -> float:
    """Baseline [22]: dense lattice quantization of the full vocabulary."""
    return payload_bits(float(V), ell)


def uncompressed_bits(V: int, bits_per_prob: int = 16) -> float:
    """Baseline: raw fp16 distribution uplink."""
    return float(V * bits_per_prob)


# ----------------------------------------------------------------------
# The packed wire's budget (``core.wire``, codec v1): fixed-width fields,
# so ``len(pack(p)) * 8`` equals these sums up to the final byte's
# padding.  Their overhead over the entropy budgets above (K⌈log2 V⌉
# against log2 C(V, K) for the index list, K⌈log2(ℓ+1)⌉ against
# log2 C(ℓ+K−1, K−1) for the counts) is a checked quantity.
# ----------------------------------------------------------------------
def _width(max_value: int) -> int:
    from repro_torch.core import wire
    return wire.field_width(max_value)


def wire_header_bits(L_max: int) -> int:
    """Draft-count field n ∈ [0, L_max]."""
    return _width(L_max)


def wire_beta_bits(n_drafts: int) -> int:
    """β trajectory β_0..β_n as raw float32 bit patterns."""
    return 32 * (n_drafts + 1)


def wire_token_bits(V: int, K: int, ell: int) -> int:
    """Packed bits for ONE draft position: token id + K field + index
    list (elided for the dense K = V support) + lattice counts."""
    tok, kf, cnt = _width(V - 1), _width(V), _width(ell)
    idx = 0 if K == V else K * tok
    return tok + kf + idx + K * cnt


def wire_raw_token_bits(V: int) -> int:
    """Raw mode ("uncompressed"): token id + V float32 probabilities."""
    return _width(V - 1) + 32 * V


def wire_verdict_bits(V: int, L_max: int) -> int:
    """Packed downlink verdict: T + resampled/bonus token + β_T."""
    return _width(L_max) + _width(V - 1) + 32


# ----------------------------------------------------------------------
# Codec v2's actuals (``core.coding``): the bits the entropy-coded wire
# spends, held against the entropy references above.  ``core.wire`` and
# ``core.coding`` load at first call, so importing this module stays as
# light as before.
# ----------------------------------------------------------------------
def coded_subset_bits(V: int, K: int) -> int:
    """Exact bits the v2 enumerative support coder spends: the rank in
    [0, C(V,K)) occupies (C(V,K) − 1).bit_length() bits."""
    from repro_torch.core import coding
    return coding.subset_rank_width(V, K)


def coded_counts_bits(counts, ell: int) -> int:
    """Exact bits the v2 Golomb-Rice count coder spends on one position
    (the last count is elided — the sum ℓ pins it)."""
    from repro_torch.core import coding
    return coding.rice_counts_bits(tuple(counts), ell)


def coded_verdict_bits(T: int, new_token: int, V: int, L_max: int) -> int:
    """Exact pre-padding bits of one v2 downlink verdict."""
    from repro_torch.core import coding, wire
    fmt = wire.WireFormat(V=V, ell=2, L_max=L_max)
    return coding.coded_verdict_bits(
        fmt, wire.VerdictPayload(n_accept=T, new_token=new_token,
                                 beta_next=0.0))


def draft_message_reference_bits(V: int, ell: int, Ks, L_max: int,
                                 adaptive: bool = True) -> float:
    """Entropy reference for a WHOLE uplink message carrying ``len(Ks)``
    draft positions: eq. (1) per position (the float32 ``token_bits``),
    plus log2 V per draft id, the n field, and the raw-f32 β trajectory
    (side information the codec treats as incompressible).  The
    yardstick the v2 coded payload is measured against."""
    n = len(Ks)
    per_tok = sum(float(token_bits(V, float(K), ell, adaptive))
                  for K in Ks)
    return (per_tok + n * math.log2(V) + 32.0 * (n + 1)
            + math.log2(L_max + 1))


def elias_gamma_bits(x):
    """bits to Elias-γ encode integer x ≥ 1: 2⌊log2 x⌋ + 1."""
    x = torch.clamp(x.float(), min=1.0)
    return 2.0 * torch.floor(torch.log2(x)) + 1.0


def gap_code_subset_bits(mask):
    """Empirical gap-coded subset bits for a support mask (..., V)."""
    V = mask.shape[-1]
    idx = torch.arange(V, dtype=torch.int64, device=mask.device)
    prev = torch.cummax(torch.where(mask, idx, -1), dim=-1).values
    prev = torch.cat([torch.full(prev.shape[:-1] + (1,), -1,
                                 dtype=prev.dtype, device=prev.device),
                      prev[..., :-1]], -1)
    gaps = torch.where(mask, idx - prev, 1)
    return torch.where(mask, elias_gamma_bits(gaps), 0.0).sum(-1)
