"""Plain PyTorch twins of the Hopper kernels (numerics mirrored op for op
from ``repro.kernels.ref``).

They are the CPU path of the kernel wrappers and the oracle the kernels
are held against on the card.  On the card they run as a chain of stock
PyTorch ops, so their times are no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.slq import ranks
from repro_torch.core.sqs import flushed_softmax, softmax


def softmax_padded(logits_padded, inv_temp: float):
    """q = softmax(logits * inv_temp) over a -inf padded row (padding -> 0),
    the probabilities ``repro.kernels.ops.sqs_topk`` computes before its
    threshold search, subnormals flushed as XLA's are."""
    return flushed_softmax(logits_padded.float() * inv_temp)


def sqs_fused_ref(logits_padded, beta, *, inv_temp: float, ell: int,
                  exact_k: int = 0, V=None):
    """Twin of the fused SQS kernel over the whole batch.
    logits_padded: (B, Vp) f32 (-inf padded past the V true tokens; V
    None: every lane is one); beta: (B, 2) f32 [lo, hi].
    Returns (b (B,Vp) i32, mask (B,Vp) i32, stats (B,4) f32).

    C-SQS keeps q >= beta and every maximum of the V true tokens: a
    padded lane has q = 0, which beta <= 0 would keep (the reference's
    Pallas path does, and counts Vp in K where its jnp rule counts V).

    K-SQS (``exact_k``) keeps every q >= hi and the earliest ties in
    [lo, hi) up to exact_k.  The reference keeps the first exact_k of
    q >= lo by index, which can cut a larger q for a tie: where fewer
    than K probabilities are nonzero (lo = 0), it keeps zeros and drops
    the whole mass (ROADMAP Queue 3 item 12)."""
    x = logits_padded.float() * inv_temp
    m = x.amax(-1, keepdim=True)
    q = flushed_softmax(x)

    if exact_k > 0:
        # every q >= hi, then of the ties in [lo, hi) the earliest by index
        # up to exact_k: lax.top_k's index set for the exact bracket
        above = q >= beta[:, 1:2]
        tie = (q >= beta[:, 0:1]) & ~above
        room = exact_k - above.sum(-1, keepdim=True)
        mask = above | (tie & (torch.cumsum(tie.to(torch.int32), -1)
                               <= room))
    else:
        in_vocab = torch.arange(q.shape[-1], device=q.device) < \
            (q.shape[-1] if V is None else V)
        mask = ((q >= beta[:, 0:1]) | (x >= m)) & in_vocab
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


def topk_threshold_ref(q_padded, K: int):
    """Twin of the top-K search: (B, 2) = [lo, hi] with lo the exact K-th
    largest of each row (0 where it underflows) and hi the next float32
    above it, so count(q >= lo) >= K and count(q >= hi) < K.

    The reference's search (``repro.kernels.ref.topk_threshold_ref``, a
    40-step bisection of [0, max q]) cannot go below max q * 2^-40, so
    where the K-th value lies lower its lo stays 0 and the exact-K trim
    keeps the first K tokens by index (ROADMAP Queue 3 item 12); the
    kernel's bracket, and this one, are exact at any temperature."""
    q = q_padded.float()
    if not 1 <= K <= q.shape[-1]:
        raise ValueError(f"K must lie in [1, {q.shape[-1]}], got {K}")
    lo = kth_largest_ref(q, K)[..., None]
    hi = torch.nextafter(lo, torch.full_like(lo, torch.inf))
    return torch.cat([lo, hi], -1)


def kth_largest_ref(q, K: int):
    """Sort-based K-th largest of each row (the top-K search's oracle)."""
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
