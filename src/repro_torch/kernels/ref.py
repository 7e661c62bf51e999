"""Plain PyTorch twins of the Hopper kernels (numerics mirrored op for op
from ``repro.kernels.ref``).

They are the CPU path of the kernel wrappers and the oracle the kernels
are held against on the card.  On the card they run as a chain of stock
PyTorch ops, so their times are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.slq import ranks
from repro_torch.core.sqs import softmax


def softmax_padded(logits_padded, inv_temp: float):
    """q = softmax(logits * inv_temp) over a -inf padded row (padding -> 0),
    the probabilities ``repro.kernels.ops.sqs_topk`` computes before its
    threshold search."""
    x = logits_padded.float() * inv_temp
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(-1, keepdim=True)


def sqs_fused_ref(logits_padded, beta, *, inv_temp: float, ell: int,
                  exact_k: int = 0):
    """Twin of the fused SQS kernel over the whole batch.
    logits_padded: (B, Vp) f32 (-inf padded); beta: (B, 2) f32 [lo, hi].
    Returns (b (B,Vp) i32, mask (B,Vp) i32, stats (B,4) f32)."""
    x = logits_padded.float() * inv_temp
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    s = e.sum(-1, keepdim=True)
    q = e / s

    if exact_k > 0:
        cand = q >= beta[:, 0:1]
        csum = torch.cumsum(cand.to(torch.int32), -1)
        mask = cand & (csum <= exact_k)
    else:
        mask = (q >= beta[:, 0:1]) | (x >= m)
    qm = torch.where(mask, q, 0.0)
    sm = qm.sum(-1, keepdim=True)
    K = mask.to(torch.float32).sum(-1, keepdim=True)
    dropped = 1.0 - sm

    q_tilde = qm / sm
    b = torch.floor(ell * q_tilde + 0.5)
    b = torch.where(mask, b, 0.0)
    sum_b = b.sum(-1, keepdim=True)

    # exact-sum correction, rank-select form (ties earliest-index-first)
    zeta = b - ell * q_tilde
    delta = sum_b - ell
    dec = select_n_ref(zeta, mask & (b > 0), delta)
    inc = select_n_ref(-zeta, mask, -delta)
    b = b - dec.float() + inc.float()

    stats = torch.cat([dropped, K, sum_b, m], -1)
    return b.to(torch.int32), mask.to(torch.int32), stats


def topk_threshold_ref(q_padded, K: int, iters: int = 40):
    """Twin of the top-K bisection: (B, 2) = [lo, hi] with
    count(q >= lo) >= K and count(q >= hi) < K."""
    q = q_padded.float()
    hi = q.amax(-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        take = (q >= mid).sum(-1, keepdim=True) >= K
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    return torch.cat([lo, hi], -1)


def kth_largest_ref(q, K: int):
    """Sort-based K-th largest of each row (an independent oracle for
    the bisection; the tests' only)."""
    return torch.topk(q, K).values[..., -1]


def select_n_ref(v, elig, n):
    """The selection ``repro.kernels.sqs_fused._select_n`` makes, by rank:
    the ``n`` largest eligible entries of each row of v, ties broken
    earliest-index first.  n: (B, 1) >= 0."""
    key = torch.where(elig, -v.float(), torch.inf)
    return (ranks(key) < n) & elig


def gqa_decode_ref(q, k, v, pos, k_scale=None, v_scale=None):
    """Twin of the flash-decode kernel over a contiguous cache (int8 K/V
    dequantized with per-(position, head) scales).  q: (B, nq, hd);
    k/v: (B, S, nkv, hd); pos: (B,).  Returns (B, nq, hd) f32."""
    B, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None]
        vf = vf * v_scale[..., None]
    qg = q.reshape(B, nkv, nq // nkv, hd).float() / float(hd) ** 0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, kf)
    valid = torch.arange(S, device=q.device)[None, :] <= \
        pos.to(torch.int64)[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    o = torch.einsum("bkgs,bskh->bkgh", softmax(s), vf)
    return o.reshape(B, nq, hd)


def paged_gqa_decode_ref(q, k, v, page_table, pos, k_scale=None,
                         v_scale=None):
    """Twin of the paged flash-decode kernel: gather each slot's pages
    into a dense (B, max_pages * page_size, nkv, hd) cache in position
    order, then the dense twin."""
    def gather(pool):
        g = pool[page_table.long()]                # (B, maxp, ps, ...)
        return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                         + g.shape[3:])

    ks = gather(k_scale) if k_scale is not None else None
    vs = gather(v_scale) if v_scale is not None else None
    return gqa_decode_ref(q, gather(k), gather(v), pos, ks, vs)
