"""Dense GQA attention: prefill over the prompt and extend over a
contiguous KV cache (mirrors the dense path of ``repro.models.attention``;
the paged, int8, sliding-window and MLA variants come in later slices).

The extend math ``_extend_core`` contracts bf16 operands with float32
accumulation and keeps float32 scores, as the reference's
``preferred_element_type=float32`` does: the bf16 operands are widened to
float32 before the product (a product of two bf16 values is exact in
float32), so the scores are never rounded to bf16.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sqs import softmax
from repro_torch.models.layers import frozen, rope_apply_by_cfg

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, \
            cfg.n_kv_heads
        self.w_q = frozen(d, nq, hd, dtype=dtype, device=device)
        self.w_k = frozen(d, nkv, hd, dtype=dtype, device=device)
        self.w_v = frozen(d, nkv, hd, dtype=dtype, device=device)
        self.w_o = frozen(nq, hd, d, dtype=dtype, device=device)
        if cfg.qkv_bias:
            self.b_q = frozen(nq, hd, dtype=dtype, device=device, fill=0.0)
            self.b_k = frozen(nkv, hd, dtype=dtype, device=device, fill=0.0)
            self.b_v = frozen(nkv, hd, dtype=dtype, device=device, fill=0.0)
        else:
            self.b_q = self.b_k = self.b_v = None


def _proj(x, w):
    """einsum("bsd,dnh->bsnh") as one matrix product."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(x.shape[:-1] + (n, h))


def _out(o, w):
    """einsum("bsnh,nhd->bsd")."""
    n, h, d = w.shape
    return o.reshape(o.shape[:-2] + (n * h,)) @ w.reshape(n * h, d)


def _inv_sqrt(hd: int, device):
    return torch.tensor(1.0, dtype=torch.float32, device=device) / \
        torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                device=device))


def _qkv(cfg, p: Attention, x, positions):
    q = _proj(x, p.w_q)
    k = _proj(x, p.w_k)
    v = _proj(x, p.w_v)
    if p.b_q is not None:
        q = q + p.b_q
        k = k + p.b_k
        v = v + p.b_v
    return (rope_apply_by_cfg(cfg, q, positions),
            rope_apply_by_cfg(cfg, k, positions), v)


def _pick_chunk(S: int, target: int = 512) -> int:
    if S <= target:
        return S
    c = target
    while S % c:
        c //= 2
    return max(c, 1)


def masked_attention(q, k, v, q_pos, k_pos, causal: bool):
    """q: (B, S, nq, hd), k/v: (B, Sk, nkv, hd), absolute positions
    (B, S) / (B, Sk).  Query-chunked so no (S, S) score tensor is built
    at once.  Returns (B, S, nq, hd)."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    qpk = nq // nkv
    scale = _inv_sqrt(hd, q.device)
    qg = q.reshape(B, S, nkv, qpk, hd)
    kf, vf = k.float(), v.float()
    C = _pick_chunk(S)
    outs = []
    for c0 in range(0, S, C):
        qc = qg[:, c0:c0 + C].float() * scale           # (B, C, nkv, qpk, hd)
        s = torch.einsum("bckgh,bskh->bkgcs", qc, kf)
        if causal:
            qp = q_pos[:, c0:c0 + C]
            rel = qp[:, None, None, :, None] >= k_pos[:, None, None, None, :]
            s = torch.where(rel, s, NEG_INF)
        p = softmax(s)
        outs.append(torch.einsum("bkgcs,bskh->bckgh", p, vf).to(q.dtype))
    return torch.cat(outs, 1).reshape(B, S, nq, hd)


def attn_prefill(cfg: ModelConfig, p: Attention, x, positions):
    """Causal attention over the prompt; returns (out, {"k", "v"})."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = masked_attention(q, k, v, positions, positions, causal=True)
    return _out(o, p.w_o), {"k": k, "v": v}


def _extend_core(cfg: ModelConfig, p: Attention, q, ck, cv, abs_new, dt):
    """L queries against the whole cache ``ck``/``cv`` (B, Sc, nkv, hd),
    causally masked by absolute position."""
    B, L = abs_new.shape
    Sc = ck.shape[1]
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qpk = nq // nkv
    qg = q.reshape(B, L, nkv, qpk, hd)
    qs = (qg.float() * _inv_sqrt(hd, q.device)).to(ck.dtype)
    s = torch.einsum("blkgh,bskh->bkgls", qs.float(), ck.float())
    kpos = torch.arange(Sc, device=ck.device)
    valid = kpos[None, None, None, None, :] <= \
        abs_new[:, None, None, :, None]
    s = torch.where(valid, s, NEG_INF)
    prob = softmax(s)
    o = torch.einsum("bkgls,bskh->blkgh", prob.to(cv.dtype).float(),
                     cv.float())
    return _out(o.reshape(B, L, nq, hd).to(dt), p.w_o)


def attn_extend(cfg: ModelConfig, p: Attention, x, positions, cache, pos):
    """Attend L new tokens (x: (B, L, d)) against the cache and each
    other; ``pos`` (B,) is the absolute index of the first new token.
    Writes the new K/V into ``cache`` IN PLACE (the reference returns an
    updated copy; rows replaying their last step rewrite the same values,
    so nothing a row later reads changes)."""
    q, k, v = _qkv(cfg, p, x, positions)
    B, L = x.shape[:2]
    abs_new = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    bidx = torch.arange(B, device=x.device)[:, None]
    cache["k"][bidx, abs_new] = k.to(cache["k"].dtype)
    cache["v"][bidx, abs_new] = v.to(cache["v"].dtype)
    return _extend_core(cfg, p, q, cache["k"], cache["v"], abs_new,
                        x.dtype), cache
