"""Attention: GQA (full or sliding-window), MLA (DeepSeek-V2) and
cross-attention (encoder-decoder), prefill over the prompt and extend
over a cache (mirrors ``repro.models.attention``).

Positions are (B, S), or (3, B, S) M-RoPE (t, h, w) ids; masks and ring
slots read the temporal stream ``positions[0]``, as the reference does.

KV caches come in two layouts, each in the compute dtype or in int8 with
per-(position, head) f32 scale tables:

  dense   (B, Sc, nkv, hd) per slot; a sliding-window layer's is a ring
          of Sc = min(capacity, W + spare) slots, position p at slot
          p % Sc, keys roped when written;
  paged   a pool of (n_pages + 1, page_size, nkv, hd) pages shared by
          every slot, addressed through a per-slot page table
          (``core.pages.PageAllocator``).  ``attn_extend`` takes the
          paged path when the cache dict carries a ``page_table`` leaf;
          after the gather both layouts run the SAME ``_extend_core``,
          so a request's token stream is bit-identical across layouts.
          Pool row ``n_pages`` is a TRASH page: masked-out batch rows and
          unallocated table entries point there, so their writes never
          land on a live page.

int8 caches are dequantized in bf16 before ``_extend_core``
(``int8 -> bf16`` times ``scale -> bf16``), as the reference does.

An MLA layer caches the latent (B, Sc, kv_lora_rank) and the shared
roped key (B, Sc, rope_head_dim) in the compute dtype (also when
``kv_cache_dtype`` is int8, as the reference does), written in place and
rolled back by position like KV.  Prefill and training expand the latent
to per-head keys and values (``mla_full``); decode and verify attend in
latent space with W_uk absorbed into the query (``mla_extend``).

A ring of exactly W slots (``spare=0``, the reference's) cannot survive
a speculative rollback once it has wrapped: the rejected drafts of a
round overwrite the keys of positions W back, which later queries still
see, and ``_extend_core`` labels each slot by the newest position, so
the overwritten keys pass the window mask as the old ones.  The model
keeps that ring at its default ``spare=0``, bit for bit the reference's.
The engine builds its rings ``spare`` slots longer
(``core.engine.ring_spare``): a key written at most ``spare`` positions
past every query still to read it lands on the slot of a position W or
more behind that query, which the window mask drops, so what a rejected
draft writes is never read as an older key.

The extend math ``_extend_core`` contracts bf16 operands with float32
accumulation and keeps float32 scores, as the reference's
``preferred_element_type=float32`` does.  On the card the cache is read
in place, in its own dtype, by cuBLAS batched products with float32
output, so no float32 copy of it is made (the reference forbids one: 2x
cache bytes of temporaries); on the CPU the operands are widened to
float32 before the product.  A product of two bf16 values is exact in
float32, so the two differ only in the order of the sums.

``attn_full`` is the train path: the whole sequence, causal, no cache;
with gradients on, each query chunk of ``masked_attention`` is
checkpointed (its scores are recomputed in the backward), as the
reference's ``jax.checkpoint(chunk)``.

Cross-attention attends a decoder position to every encoder frame
(non-causal, all positions 0, optionally only the frames in
``enc_valid``).  Its K/V are computed once from the encoder's output
(``cross_kv``) and cached in the compute dtype beside the layer's own KV;
decode and verify read them and never write them.  On the card, outside
autograd, ``cross_attend`` reads the cached K/V in place through
``_cache_bmm`` with float32 scores and output, the probabilities in the
cache's dtype, as ``_extend_core`` does; on the CPU and with gradients
on it runs the reference's widened float32 ``masked_attention``.

On DTensor parameters and caches (the dry run) every attention core
(``masked_attention``, ``_extend_attn``, ``_mla_attn``,
``_cross_in_place``) runs per rank on its own batch rows and heads
(``sharding.local.heads_local``), and the caches are written per rank
(``sharding.local.write_rows``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.slq import reciprocal
from repro_torch.core.sqs import softmax
from repro_torch.models.layers import param, rope_apply_by_cfg
from repro_torch.sharding.local import heads_local, is_dtensor, write_rows

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Geometry of the paged KV pool (one pool per attention layer).

    ``n_pages`` usable pages of ``page_size`` positions; page tables are
    ``max_pages_per_slot`` wide (per-request capacity ceiling).  The
    physical pool has ``n_pages + 1`` rows -- the last is the trash page.
    """
    page_size: int
    n_pages: int
    max_pages_per_slot: int

    @property
    def trash_page(self) -> int:
        return self.n_pages

    @property
    def tokens_per_slot_max(self) -> int:
        return self.max_pages_per_slot * self.page_size


def paged_eligible(cfg: ModelConfig) -> bool:
    """Which attention layers can live in the page pool: standard GQA
    over the full context (sliding-window ring buffers and MLA latent
    caches stay dense)."""
    return cfg.attention == "full" and not cfg.is_mla


def window(cfg: ModelConfig) -> int:
    """The attention window W, 0 for full attention."""
    return cfg.sliding_window if cfg.attention == "sliding" else 0


def cache_capacity(cfg: ModelConfig, seq: int, spare: int = 0) -> int:
    """Positions a GQA cache of ``seq`` positions holds: a sliding
    window's ring is at most W + ``spare`` slots."""
    W = window(cfg)
    return min(seq, W + spare) if W else seq


class Attention(nn.Module):
    """GQA leaves: w_q (d, nq, hd), w_k / w_v (d, nkv, hd), w_o (nq, hd, d)
    and, with ``cfg.qkv_bias``, biases.  The ``cross`` form (a decoder's
    cross-attention, an encoder layer's self-attention) never has a bias,
    as the reference's ``init_attn(cross=True)``."""

    def __init__(self, cfg: ModelConfig, dtype, device, cross: bool = False):
        super().__init__()
        d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, \
            cfg.n_kv_heads
        self.w_q = param(d, nq, hd, dtype=dtype, device=device)
        self.w_k = param(d, nkv, hd, dtype=dtype, device=device)
        self.w_v = param(d, nkv, hd, dtype=dtype, device=device)
        self.w_o = param(nq, hd, d, dtype=dtype, device=device)
        if cfg.qkv_bias and not cross:
            self.b_q = param(nq, hd, dtype=dtype, device=device, fill=0.0)
            self.b_k = param(nkv, hd, dtype=dtype, device=device, fill=0.0)
            self.b_v = param(nkv, hd, dtype=dtype, device=device, fill=0.0)
        else:
            self.b_q = self.b_k = self.b_v = None


class MLA(nn.Module):
    """Multi-head latent attention's leaves, under the reference's names:
    the query (d, nq, hd + rhd), the latent and shared rope-key
    down-projections, the latent's key and value up-projections and the
    output (nq, v_hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd, nq = cfg.d_model, cfg.head_dim, cfg.n_heads
        rhd, rank, vhd = cfg.rope_head_dim, cfg.kv_lora_rank, cfg.v_hd
        self.w_q = param(d, nq, hd + rhd, dtype=dtype, device=device)
        self.w_dkv = param(d, rank, dtype=dtype, device=device)
        self.w_krope = param(d, rhd, dtype=dtype, device=device)
        self.w_uk = param(rank, nq, hd, dtype=dtype, device=device)
        self.w_uv = param(rank, nq, vhd, dtype=dtype, device=device)
        self.w_o = param(nq, vhd, d, dtype=dtype, device=device)


def _proj(x, w):
    """einsum("bsd,dnh->bsnh") as one matrix product, the weight cast to
    the activations' dtype."""
    d, n, h = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * h)).reshape(
        x.shape[:-1] + (n, h))


def _out(o, w):
    """einsum("bsnh,nhd->bsd")."""
    n, h, d = w.shape
    return o.reshape(o.shape[:-2] + (n * h,)) @ \
        w.to(o.dtype).reshape(n * h, d)


def _inv_sqrt(hd: int, device):
    return torch.tensor(1.0, dtype=torch.float32, device=device) / \
        torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                device=device))


def _qkv(cfg, p: Attention, x, positions):
    q = _proj(x, p.w_q)
    k = _proj(x, p.w_k)
    v = _proj(x, p.w_v)
    if p.b_q is not None:
        q = q + p.b_q.to(x.dtype)
        k = k + p.b_k.to(x.dtype)
        v = v + p.b_v.to(x.dtype)
    return (rope_apply_by_cfg(cfg, q, positions),
            rope_apply_by_cfg(cfg, k, positions), v)


def pos2d(positions):
    """The (B, S) positions of masks and ring slots: the temporal stream
    of (3, B, S) M-RoPE ids."""
    return positions if positions.ndim == 2 else positions[0]


def _pick_chunk(S: int, target: int = 512) -> int:
    if S <= target:
        return S
    c = target
    while S % c:
        c //= 2
    return max(c, 1)


def _attend_chunk(qc, qp, kf, vf, k_pos, scale, causal: bool, window: int,
                  k_valid):
    """One query chunk qc (B, C, nkv, qpk, hd) at positions qp (B, C)
    against the whole float32 K/V: causal, within ``window`` positions
    back (0: unbounded), and only keys where ``k_valid`` (B, Sk)."""
    s = torch.einsum("bckgh,bskh->bkgcs", qc.float() * scale, kf)
    mask = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool, device=s.device)
    if causal:
        mask = mask & (qp[:, None, None, :, None]
                       >= k_pos[:, None, None, None, :])
    if window:
        mask = mask & ((qp[:, None, None, :, None]
                        - k_pos[:, None, None, None, :]) < window)
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, None, :]
    p = softmax(torch.where(mask, s, NEG_INF))
    return torch.einsum("bkgcs,bskh->bckgh", p, vf).to(qc.dtype)


def masked_attention(q, k, v, q_pos, k_pos, causal: bool, window: int = 0,
                     k_valid=None):
    """q: (B, S, nq, hd), k: (B, Sk, nkv, hd), v: (B, Sk, nkv, hdv),
    absolute positions (B, S) / (B, Sk).  Query-chunked so no (S, S)
    score tensor is built at once; with gradients on, each chunk is
    checkpointed.  Returns (B, S, nq, hdv)."""
    if is_dtensor(q) or is_dtensor(k):
        return heads_local(
            lambda q, k, v, qp, kp, kv, _: masked_attention(
                q, k, v, qp, kp, causal, window, kv),
            q, (k, v), (q_pos, k_pos, k_valid))
    B, S, nq, hd = q.shape
    nkv, hdv = v.shape[2], v.shape[3]
    qpk = nq // nkv
    scale = _inv_sqrt(hd, q.device)
    qg = q.reshape(B, S, nkv, qpk, hd)
    kf, vf = k.float(), v.float()
    C = _pick_chunk(S)
    outs = []
    for c0 in range(0, S, C):
        args = (qg[:, c0:c0 + C], q_pos[:, c0:c0 + C], kf, vf, k_pos, scale,
                causal, window, k_valid)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_chunk, *args,
                                   use_reentrant=False))
        else:
            outs.append(_attend_chunk(*args))
    return torch.cat(outs, 1).reshape(B, S, nq, hdv)


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------
def _int8(cfg: ModelConfig) -> bool:
    return cfg.kv_cache_dtype == "int8"


def make_kv_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device,
                  spare: int = 0):
    """One layer's dense cache, zero-filled: a sliding-window layer's ring
    holds min(seq, W + spare) slots; an MLA layer's latent and rope key
    stay in the compute dtype (and at ``seq`` positions), as the
    reference's."""
    if cfg.is_mla:
        return {"latent": torch.zeros((batch, seq, cfg.kv_lora_rank),
                                      dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, seq, cfg.rope_head_dim),
                                      dtype=dtype, device=device)}
    shp = (batch, cache_capacity(cfg, seq, spare), cfg.n_kv_heads,
           cfg.head_dim)
    if _int8(cfg):
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shp[:3], device=device),
                "v_scale": torch.zeros(shp[:3], device=device)}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def _quantize_heads(x):
    """x: (B, L, nkv, hd) -> (int8, scale (B, L, nkv)).  The reference
    runs this under jit, where XLA turns the division by 127 into a
    multiplication by its float32 reciprocal."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) * reciprocal(127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(c8, cs):
    """int8 cache -> bf16, as the reference's ``ck8.astype(bf16) *
    cks.astype(bf16)``."""
    return c8.to(torch.bfloat16) * cs[..., None].to(torch.bfloat16)


def make_paged_kv_cache(cfg: ModelConfig, batch: int, spec: PagedSpec,
                        dtype, device):
    """Page pool + per-slot page table for one attention layer.  Every
    table entry starts at the trash page (nothing allocated); the engine
    overwrites tables from the host-side ``PageAllocator``."""
    assert paged_eligible(cfg), (cfg.name, cfg.attention, cfg.kv_lora_rank)
    shp = (spec.n_pages + 1, spec.page_size, cfg.n_kv_heads, cfg.head_dim)
    pt = torch.full((batch, spec.max_pages_per_slot), spec.trash_page,
                    dtype=torch.int64, device=device)
    if _int8(cfg):
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shp[:3], device=device),
                "v_scale": torch.zeros(shp[:3], device=device),
                "page_table": pt}
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device),
            "page_table": pt}


def sanitize_page_table(table, n_pages: int, device):
    """Host table -> device table: FREE (-1) entries become the trash
    page, so unallocated logical pages read garbage (masked) and write
    harmlessly instead of wrapping to a live page."""
    t = torch.as_tensor(table, dtype=torch.int64)
    return torch.where(t >= 0, t, n_pages).to(device)


def page_gather(pool, pt):
    """pool: (P, ps, ...); pt: (B, maxp) -> (B, maxp*ps, ...) -- a slot's
    cache in position order (trash-page rows are masked by position
    downstream)."""
    g = pool[pt]                               # (B, maxp, ps, ...)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def page_scatter(pool, vals, pt, positions):
    """Write ``vals`` (B, L, ...) at absolute ``positions`` (B, L)
    through page table ``pt`` (B, maxp), IN PLACE.  Slots own disjoint
    pages, so live rows never collide; rows whose table points at the
    trash page write there."""
    ps = pool.shape[1]
    pg = torch.gather(pt, 1, positions // ps)               # (B, L)
    pool[pg, positions % ps] = vals.to(pool.dtype)


def prefill_into_pages(paged, dense_kv, pt_row, length: int):
    """Write a batch-1 prefill cache's first ``length`` positions through
    one slot's page table row, IN PLACE (one layer: pools (P, ps, ...),
    prefill leaves (1, S, ...))."""
    ps = paged["k"].shape[1]
    idx = torch.arange(length, device=pt_row.device)
    pg, off = pt_row[idx // ps], idx % ps
    for name, vals in dense_kv.items():
        if name in paged:
            paged[name][pg, off] = vals[0, :length].to(paged[name].dtype)


# ----------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------
def attn_full(cfg: ModelConfig, p: Attention, x, positions):
    """Train path: the full sequence, causal (and windowed), no cache
    returned."""
    q, k, v = _qkv(cfg, p, x, positions)
    positions = pos2d(positions)
    o = masked_attention(q, k, v, positions, positions, causal=True,
                         window=window(cfg))
    return _out(o, p.w_o)


def attn_prefill(cfg: ModelConfig, p: Attention, x, positions,
                 spare: int = 0):
    """Causal (and windowed) attention over the prompt; returns (out, cache
    leaves): {"k", "v"}, or int8 {"k", "v", "k_scale", "v_scale"}.  With
    a window W the cache is a ring of R = W + ``spare`` slots: a prompt
    longer than R leaves its last R roped keys, position p at slot p % R;
    a shorter one keeps every key at slot p."""
    q, k, v = _qkv(cfg, p, x, positions)
    W = window(cfg)
    positions = pos2d(positions)
    o = masked_attention(q, k, v, positions, positions, causal=True,
                         window=W)
    R = W + spare
    if W and x.shape[1] > R:
        slots = positions[:, -R:] % R
        ring_k, ring_v = torch.zeros_like(k[:, -R:]), torch.zeros_like(
            v[:, -R:])
        k = write_rows(ring_k, slots, k[:, -R:])
        v = write_rows(ring_v, slots, v[:, -R:])
    if _int8(cfg):
        k8, ks = _quantize_heads(k)
        v8, vs = _quantize_heads(v)
        return _out(o, p.w_o), {"k": k8, "v": v8, "k_scale": ks,
                                "v_scale": vs}
    return _out(o, p.w_o), {"k": k, "v": v}


def _cache_bmm(a, c, transpose: bool):
    """Per (row, KV head) products with the cache c (B, Sc, nkv, hd) read
    in place: a (B, nkv, R, hd) @ c^T -> (B, nkv, R, Sc) when
    ``transpose``, else a (B, nkv, R, Sc) @ c -> (B, nkv, R, hd); float32
    out.  One cuBLAS batched product per entry of the shorter of the row
    and head axes, batched over the other: each (row, head) slice of the
    cache is a strided matrix, so nothing is copied, and bf16 operands
    sum into float32 (``out_dtype``)."""
    kw = {} if c.dtype == torch.float32 else {"out_dtype": torch.float32}
    B, nkv = a.shape[:2]
    if B <= nkv:
        parts = []
        for b in range(B):
            cb = c[b].transpose(0, 1)                     # (nkv, Sc, hd)
            parts.append(torch.bmm(a[b], cb.transpose(1, 2) if transpose
                                   else cb, **kw))
        return torch.stack(parts, 0)
    parts = []
    for h in range(nkv):
        ch = c[:, :, h]                                   # (B, Sc, hd)
        parts.append(torch.bmm(a[:, h], ch.transpose(1, 2) if transpose
                               else ch, **kw))
    return torch.stack(parts, 1)


def _extend_core(cfg: ModelConfig, p: Attention, q, ck, cv, abs_new, W: int,
                 dt):
    """L queries against the whole (gathered) cache ``ck``/``cv``
    (B, Sc, nkv, hd), causally masked by absolute position.  With a window
    W the cache is a ring: each slot is labelled with the latest position
    the newest query's ring puts there, and keys more than W back or never
    written are masked too.  Both cache layouts run this one function,
    which is what makes paged and dense serving bit-identical.  On
    DTensors each rank attends with its own heads and rows
    (``sharding.local.heads_local``), and a sequence-sharded cache with
    its own block of it."""
    if is_dtensor(q) or is_dtensor(ck):
        o = heads_local(
            lambda q, ck, cv, a, cp: _extend_attn(q, ck, cv, a, W, cp),
            q, (ck, cv), (abs_new,), context_parallel=True)
    else:
        o = _extend_attn(q, ck, cv, abs_new, W)
    return _out(o.to(dt), p.w_o)


def _extend_attn(q, ck, cv, abs_new, W: int, cp=None):
    """``_extend_core``'s attention: q (B, L, nq, hd) -> float32 (B, L,
    nq, hd).  ``cp`` (``ContextShards``): this rank holds slots
    [offset, offset + Sc) of a cache of ``cp.total``; the softmax's max and
    sum and the context are reduced over the ranks that share it."""
    B, L = abs_new.shape
    Sc = ck.shape[1]
    nq, nkv, hd = q.shape[2], ck.shape[2], q.shape[3]
    qpk = nq // nkv
    qg = q.reshape(B, L, nkv, qpk, hd)
    qs = (qg.float() * _inv_sqrt(hd, q.device)).to(ck.dtype)
    if ck.is_cuda:
        a = qs.permute(0, 2, 3, 1, 4).reshape(B, nkv, qpk * L, hd)
        s = _cache_bmm(a, ck, transpose=True).view(B, nkv, qpk, L, Sc)
    else:
        s = torch.einsum("blkgh,bskh->bkgls", qs.float(), ck.float())
    slot = torch.arange(Sc, device=ck.device)[None, :]        # (1, Sc)
    total = Sc
    if cp is not None:
        slot, total = slot + cp.offset, cp.total
    if W:
        last = abs_new[:, -1:]
        slot_abs = last - (last - slot) % total               # (B, Sc)
    else:
        slot_abs = slot
    qpos = abs_new[:, None, None, :, None]                    # (B,1,1,L,1)
    kpos = slot_abs[:, None, None, None, :]                   # (·,1,1,1,Sc)
    valid = kpos <= qpos
    if W:
        valid = valid & (kpos > qpos - W) & (kpos >= 0)
    s = torch.where(valid, s, NEG_INF)
    if cp is None:
        prob = softmax(s).to(cv.dtype)
    else:
        e = torch.exp(s - cp.reduce(s.amax(-1, keepdim=True), "max"))
        prob = (e / cp.reduce(e.sum(-1, keepdim=True), "sum")).to(cv.dtype)
    if cv.is_cuda:
        o = _cache_bmm(prob.reshape(B, nkv, qpk * L, Sc), cv,
                       transpose=False)
        o = o.view(B, nkv, qpk, L, hd).permute(0, 3, 1, 2, 4)
    else:
        o = torch.einsum("bkgls,bskh->blkgh", prob.float(), cv.float())
    if cp is not None:
        o = cp.reduce(o.contiguous(), "sum")
    return o.reshape(B, L, nq, hd)


def attn_extend(cfg: ModelConfig, p: Attention, x, positions, cache, pos):
    """Attend L new tokens (x: (B, L, d)) against the cache and each
    other; ``pos`` (B,) is the absolute index of the first new token.
    Writes the new K/V into ``cache`` IN PLACE (the reference returns an
    updated copy; rows replaying their last step rewrite the same values,
    so nothing a row later reads changes); a sliding-window layer writes
    position p at ring slot p % Sc.  A cache dict carrying a
    ``page_table`` leaf takes the paged path."""
    if "page_table" in cache:
        return _attn_extend_paged(cfg, p, x, positions, cache, pos)
    q, k, v = _qkv(cfg, p, x, positions)
    L = x.shape[1]
    W = window(cfg)
    abs_new = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    slot = abs_new % cache["k"].shape[1] if W else abs_new
    if "k_scale" in cache:
        k8, ks = _quantize_heads(k)
        v8, vs = _quantize_heads(v)
        for name, vals in (("k", k8), ("v", v8), ("k_scale", ks),
                           ("v_scale", vs)):
            write_rows(cache[name], slot, vals)
        ck = _dequantize(cache["k"], cache["k_scale"])
        cv = _dequantize(cache["v"], cache["v_scale"])
    else:
        write_rows(cache["k"], slot, k)
        write_rows(cache["v"], slot, v)
        ck, cv = cache["k"], cache["v"]
    return _extend_core(cfg, p, q, ck, cv, abs_new, W, x.dtype), cache


def _attn_extend_paged(cfg: ModelConfig, p: Attention, x, positions, cache,
                       pos):
    """Paged extend: scatter the L new tokens' K/V into the page pool
    through the slot page tables, gather each slot's pages back into
    position order, then the shared ``_extend_core``.  The engine
    guarantees every ACTIVE row's table covers pos+L tokens; masked rows
    point at the trash page."""
    q, k, v = _qkv(cfg, p, x, positions)
    B, L = x.shape[:2]
    pt = cache["page_table"]                            # (B, maxp) >= 0
    abs_new = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    if "k_scale" in cache:
        k8, ks = _quantize_heads(k)
        v8, vs = _quantize_heads(v)
        for name, vals in (("k", k8), ("v", v8), ("k_scale", ks),
                           ("v_scale", vs)):
            page_scatter(cache[name], vals, pt, abs_new)
        ck = _dequantize(page_gather(cache["k"], pt),
                         page_gather(cache["k_scale"], pt))
        cv = _dequantize(page_gather(cache["v"], pt),
                         page_gather(cache["v_scale"], pt))
    else:
        page_scatter(cache["k"], k, pt, abs_new)
        page_scatter(cache["v"], v, pt, abs_new)
        ck, cv = page_gather(cache["k"], pt), page_gather(cache["v"], pt)
    return _extend_core(cfg, p, q, ck, cv, abs_new, 0, x.dtype), cache


# ----------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ----------------------------------------------------------------------
def _mla_q(cfg, p: MLA, x, positions):
    q = _proj(x, p.w_q)
    return q[..., :cfg.head_dim], rope_apply_by_cfg(
        cfg, q[..., cfg.head_dim:], positions)


def _mla_latent(cfg, p: MLA, x, positions):
    latent = x @ p.w_dkv.to(x.dtype)                          # (B, S, rank)
    k_rope = (x @ p.w_krope.to(x.dtype))[:, :, None, :]       # (B, S, 1, rhd)
    return latent, rope_apply_by_cfg(cfg, k_rope, positions)[:, :, 0]


def mla_full(cfg: ModelConfig, p: MLA, x, positions,
             return_cache: bool = False):
    """Train / prefill: the latent expanded to per-head keys and values,
    the shared rope key broadcast over the heads, causal attention over
    the sequence; with ``return_cache`` also the cache leaves
    {"latent", "k_rope"}."""
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    latent, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = _proj(latent, p.w_uk)
    v = _proj(latent, p.w_uv)
    k_rope_b = k_rope[:, :, None, :].expand(-1, -1, cfg.n_heads, -1)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope_b], -1)
    positions = pos2d(positions)
    out = _out(masked_attention(q, k, v, positions, positions, causal=True),
               p.w_o)
    if return_cache:
        return out, {"latent": latent, "k_rope": k_rope}
    return out


def _latent_bmm(a, c, transpose: bool):
    """a (B, R, n) @ c^T (B, n, Sc) when ``transpose``, else a (B, R, Sc)
    @ c (B, Sc, n), float32 out, against a one-head cache c (B, Sc, n):
    on the card read in place by ``_cache_bmm``, on the CPU widened to
    float32 first (as ``_extend_core``)."""
    if c.is_cuda:
        return _cache_bmm(a[:, None], c[:, :, None], transpose)[:, 0]
    return a.float() @ (c.transpose(1, 2) if transpose else c).float()


def mla_extend(cfg: ModelConfig, p: MLA, x, positions, cache, pos):
    """Absorbed MLA extend (decode L = 1, verify L > 1): W_uk folded into
    the query and W_uv applied after the context, so scores and context
    live in latent space.  Writes the L new latents and rope keys into
    ``cache`` IN PLACE.  The precisions are the reference's: the absorbed
    query in float32 then cast to the cache dtype, both score products
    cache-dtype operands into float32, the context float32 from
    cache-dtype probabilities, W_uv in float32."""
    dt = x.dtype
    L = x.shape[1]
    q_nope, q_rope = _mla_q(cfg, p, x, positions)            # (B, L, nq, ·)
    latent_t, k_rope_t = _mla_latent(cfg, p, x, positions)
    abs_new = pos[:, None] + torch.arange(L, device=x.device)[None, :]
    clat = write_rows(cache["latent"], abs_new, latent_t)
    crope = write_rows(cache["k_rope"], abs_new, k_rope_t)
    scale = _inv_sqrt(cfg.head_dim + cfg.rope_head_dim, x.device)
    q_lat = torch.einsum("blnh,rnh->blnr", q_nope.float(), p.w_uk.float())
    # the absorbed query and the rope query, in the caches' dtype, as one
    # (B, L, nq, rank + rhd) tensor
    qcat = torch.cat([q_lat.to(clat.dtype), q_rope.to(crope.dtype)], -1)
    if is_dtensor(qcat) or is_dtensor(clat):
        ctx = heads_local(
            lambda q, cl, cr, a, _: _mla_attn(q, cl, cr, a, scale),
            qcat, (clat, crope), (abs_new,))
    else:
        ctx = _mla_attn(qcat, clat, crope, abs_new, scale)
    o = torch.einsum("blnr,rnh->blnh", ctx, p.w_uv.float())
    return _out(o.to(dt), p.w_o), cache


def _mla_attn(qcat, clat, crope, abs_new, scale):
    """``mla_extend``'s attention in latent space: qcat (B, L, nq, rank +
    rhd) against the latent (B, Sc, rank) and rope-key (B, Sc, rhd)
    caches -> the float32 context (B, L, nq, rank)."""
    B, L, nq = qcat.shape[:3]
    rank, Sc = clat.shape[2], clat.shape[1]
    s = _latent_bmm(qcat[..., :rank].reshape(B, L * nq, rank), clat,
                    transpose=True)
    s = s + _latent_bmm(qcat[..., rank:].reshape(B, L * nq, -1), crope,
                        transpose=True)
    s = (s * scale).view(B, L, nq, Sc)
    valid = torch.arange(Sc, device=clat.device)[None, None, None, :] <= \
        abs_new[:, :, None, None]                             # (B, L, 1, Sc)
    prob = softmax(torch.where(valid, s, NEG_INF)).to(clat.dtype)
    ctx = _latent_bmm(prob.reshape(B, L * nq, Sc), clat, transpose=False)
    return ctx.view(B, L, nq, rank)


# ----------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ----------------------------------------------------------------------
def cross_kv(cfg: ModelConfig, p: Attention, enc_out):
    """One decoder layer's cross K/V from the encoder's output (B, S_enc,
    d): {"k", "v"} (B, S_enc, nkv, hd), unroped."""
    return {"k": _proj(enc_out, p.w_k), "v": _proj(enc_out, p.w_v)}


def _cross_in_place(q, k, v, enc_valid):
    """q (B, S, nq, hd) against every frame of the cached k / v (B, S_enc,
    nkv, hd), read in place: float32 scores scaled after the product, the
    probabilities in the cache's dtype, float32 output."""
    B, S, nq, hd = q.shape
    nkv = k.shape[2]
    qpk = nq // nkv
    a = q.reshape(B, S, nkv, qpk, hd).permute(0, 2, 3, 1, 4).reshape(
        B, nkv, qpk * S, hd).to(k.dtype)
    s = _cache_bmm(a, k, transpose=True) * _inv_sqrt(hd, q.device)
    if enc_valid is not None:
        s = torch.where(enc_valid[:, None, None, :], s, NEG_INF)
    o = _cache_bmm(softmax(s).to(v.dtype), v, transpose=False)
    return o.view(B, nkv, qpk, S, hd).permute(0, 3, 1, 2, 4).reshape(
        B, S, nq, hd).to(q.dtype)


def cross_attend(cfg: ModelConfig, p: Attention, x, kv, enc_valid=None):
    """x (B, S, d) attends to the cross K/V ``kv`` of every encoder frame
    (or of those where ``enc_valid`` (B, S_enc)); returns (B, S, d)."""
    q = _proj(x, p.w_q)
    k, v = kv["k"], kv["v"]
    if k.is_cuda and not torch.is_grad_enabled():
        if is_dtensor(q) or is_dtensor(k):
            o = heads_local(lambda q, k, v, ev, _: _cross_in_place(q, k, v, ev),
                            q, (k, v), (enc_valid,))
        else:
            o = _cross_in_place(q, k, v, enc_valid)
    else:
        B, S = x.shape[:2]
        qpos = torch.zeros((B, S), dtype=torch.int64, device=x.device)
        kpos = torch.zeros((B, k.shape[1]), dtype=torch.int64,
                           device=x.device)
        o = masked_attention(q, k, v, qpos, kpos, causal=False,
                             k_valid=enc_valid)
    return _out(o, p.w_o)
