"""Top-level model API (mirrors ``repro.models.model``):

    Transformer(cfg, dtype, device="cuda",
                trainable=False)                   -> module (uninitialised;
                                                     see repro_torch.bridge)
    param_count(model)                             -> int
    train_loss(model, batch, remat=True)           -> (loss, metrics)
    forward_logits(model, tokens, positions=None,
                   enc_embeds=None)                -> logits (B, S, V)
    prefill(model, tokens, cache_len, positions=None,
            enc_embeds=None, spare=0)              -> (last_logits, cache)
    extend_step(model, tokens, cache, pos,
                collect_traj=False)                -> (logits (B,L,V), cache,
                                                     traj)
    decode_step(model, token, cache, pos)          -> (logits (B,V), cache)
    init_cache(model, batch, seq, paged=None,
               enc_seq=0, spare=0)                 -> empty serving cache
    set_page_tables(cache, pt)                     -> cache, tables refreshed
    write_prefill_to_slot(cfg, big, small, slot,
                          ...)                     -> prompt into one slot

The layers are the dense prefix layers, then the body
(``transformer.layer_kinds``).  A cache is a list with one dict per
layer, of the layer's kind.  An attention layer holds dense {"k", "v"}
of (B, Sc, nkv, hd) tensors, plus f32 "k_scale"/"v_scale" (B, Sc, nkv)
when ``cfg.kv_cache_dtype == "int8"``, Sc the capacity
(``attention.cache_capacity``: min(cache_len, W + spare) for a sliding
window, whose cache is a ring; ``spare`` 0 is the reference's ring of W,
the engine passes ``core.engine.ring_spare``); an MLA layer holds
{"latent" (B, cache_len, rank), "k_rope" (B, cache_len, rhd)}; a paged
attention layer holds pools (n_pages + 1, page_size, ...) of the KV
leaves and its slots' "page_table" (B, max_pages).  A stateful layer
(Mamba, mLSTM, sLSTM) holds its recurrent state, (B, ...) leaves of
``ssm.make_state``.
``extend_step`` writes KV into the cache in place, dispatching on
"page_table", and replaces each stateful layer's state with the new
one (a new tensor: state tensors are never written in place); with
L > 1 it is the speculative-decoding verification pass, and with
``collect_traj`` it also returns, keyed by layer index, the state after
every one of the L positions, (B, L, ...) leaves (empty without it), from which
``core.engine.rollback_cache`` restores the state after the last kept
token.  The serve entry points run without gradients; ``train_loss`` and
``forward_logits`` run with whatever grad mode the caller has.

Positions default to 0, 1, ... from the first token (from ``pos`` in
extend); an M-RoPE config takes (3, B, S) (t, h, w) ids, by default
t == h == w, and a caller may pass others (``models.frontend``'s vision
patch grid) to ``prefill``, ``forward_logits`` and ``train_loss``
(``batch["positions"]``); extend and decode always take the default, as
the reference's.  An encoder-decoder model (``cfg.n_encoder_layers``)
encodes ``enc_embeds`` (B, S_enc, d), the frontend stub's frames
(``batch["enc_embeds"]`` in training), once a call; ``prefill`` stores
each decoder layer's cross K/V, (B, S_enc, nkv, hd) in the compute
dtype, in that layer's cache dict under ``transformer.CROSS_LEAVES``,
which extend and decode read and never write.

A model built with ``trainable=True`` holds float32 masters with
gradients on (the reference's parameters), computing in ``dtype``; a
serving model stores its weights in ``dtype`` itself, so no float32 copy
of them exists on a serve path.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec, ssm
from repro_torch.models.layers import (compute_dtype, embed_apply,
                                       lm_head_apply, param, rmsnorm)
from repro_torch.sharding import act_sharding as _act
from repro_torch.sharding.local import (argmax_last, gathered_over_data,
                                       nll_last)
from repro_torch.models.transformer import (CROSS_LEAVES, SEQ_BLOCKS,
                                           apply_train, check_supported,
                                           layer_kinds, make_layers)


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=None, device="cuda",
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype or compute_dtype(cfg)
        store = torch.float32 if trainable else self.dtype
        d = cfg.d_model
        self.embedding = param(cfg.vocab, d, dtype=store, device=device)
        self.lm_head = None if cfg.tie_embeddings else \
            param(d, cfg.vocab, dtype=store, device=device)
        self.layers = make_layers(cfg, store, device)
        self.final_norm = param(d, dtype=torch.float32, device=device,
                                fill=1.0)
        self.encoder = encdec.Encoder(cfg, store, device) \
            if cfg.n_encoder_layers else None
        self.requires_grad_(trainable)

    @property
    def device(self):
        return self.embedding.device

    def head(self, x):
        x = rmsnorm(x, self.final_norm, self.cfg.rms_eps)
        return lm_head_apply(self.embedding, self.lm_head, x).float()


def param_count(model: Transformer) -> int:
    return sum(p.numel() for p in model.parameters())


def _positions(cfg: ModelConfig, batch: int, seq: int, start, device):
    """start, start + 1, ... a row (``start`` an int or (B,)): (B, S), or
    (3, B, S) with t == h == w for M-RoPE."""
    p = torch.arange(seq, dtype=torch.int64, device=device)[None]
    if isinstance(start, int):
        p = (p + start).expand(batch, seq)
    else:
        p = p + start.to(torch.int64)[:, None]
    return p[None].expand((3,) + p.shape) if cfg.rope_type == "mrope" else p


def _encode(model: Transformer, enc_embeds):
    """The encoder's output for ``enc_embeds`` (B, S_enc, d), cast to the
    compute dtype; None for a decoder-only model."""
    if model.encoder is None:
        return None
    if enc_embeds is None:
        raise ValueError(f"{model.cfg.name} is an encoder-decoder model: "
                         "pass enc_embeds (B, S_enc, d_model)")
    return encdec.encode(model.encoder, enc_embeds.to(model.dtype))


def _stack(model: Transformer, tokens, positions, enc_embeds, **kw):
    """The train-mode stack over ``tokens`` (B, S) at ``positions`` (the
    default when None): returns (x, aux)."""
    B, S = tokens.shape
    if positions is None:
        positions = _positions(model.cfg, B, S, 0, tokens.device)
    x = embed_apply(model.embedding, tokens, model.dtype)
    return apply_train(model.layers, x, positions,
                       enc_out=_encode(model, enc_embeds),
                       n_prefix=model.cfg.n_prefix_layers, **kw)


def train_loss(model: Transformer, batch, remat: bool = True):
    """batch: {"tokens": (B, S+1) int[, "positions": (B, S) or (3, B, S)
    M-RoPE ids, "enc_embeds": (B, S_enc, d) for an encoder-decoder model,
    "loss_mask": (B, S)]}.  Returns (loss, {"ce", "aux", "accuracy"}): the
    masked mean next-token cross entropy over float32 logits plus the
    summed MoE aux loss; MoE layers drop tokens past capacity, as the
    reference trains."""
    tokens = batch["tokens"]
    labels = tokens[:, 1:].long()
    x, aux = _stack(model, tokens[:, :-1], batch.get("positions"),
                    batch.get("enc_embeds"), remat=remat)
    if _act.AXES is not None:
        x = _act.constrain(x, _act.AXES.dp, None, None)
    with gathered_over_data(model, ("lm_head", "final_norm")):
        logits = model.head(x)
    if _act.AXES is not None:
        # logits (B, S, V): batch over data, vocab over model, so the
        # float32 logits stay sharded through the cross entropy
        logits = _act.constrain(logits, _act.AXES.dp, None,
                                _act.AXES.model)
    nll = nll_last(logits, labels)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    # argmax ties go to the first index, in torch as in jnp
    acc = ((argmax_last(logits) == labels) * mask).sum() / denom
    return ce + aux, {"ce": ce, "aux": aux, "accuracy": acc}


def forward_logits(model: Transformer, tokens, positions=None,
                   enc_embeds=None):
    """Teacher-forced float32 logits (B, S, V), the oracle of the serve
    path: MoE layers run dropless, as inference routes."""
    x, _ = _stack(model, tokens, positions, enc_embeds, remat=False,
                  dropless=True)
    return model.head(x)


@torch.no_grad()
def prefill(model: Transformer, tokens, cache_len: Optional[int] = None,
            positions=None, enc_embeds=None, spare: int = 0):
    """Run the prompt (B, S) and build the decode cache: attention caches
    padded with zeros out to ``attention.cache_capacity(cfg, cache_len,
    spare)`` positions (a sliding window's ring of that many slots, full
    already when the prompt is longer), stateful layers' state after the
    prompt, and an encoder-decoder model's cross K/V of ``enc_embeds`` in
    every body layer's dict.  Returns (last_logits (B, V), cache)."""
    B, S = tokens.shape
    cfg = model.cfg
    cap = attn_mod.cache_capacity(cfg, cache_len or S, spare)
    if positions is None:
        positions = _positions(cfg, B, S, 0, tokens.device)
    enc_out = _encode(model, enc_embeds)
    x = embed_apply(model.embedding, tokens, model.dtype)
    cache = []
    for i, blk in enumerate(model.layers):
        kv = None
        if enc_out is not None and i >= cfg.n_prefix_layers:
            kv = attn_mod.cross_kv(cfg, blk.cross, enc_out)
        x, c = blk.prefill(x, positions, kv, spare)
        if not blk.stateful:
            grown = {}
            for name, t in c.items():
                if t.shape[1] < cap:
                    full = torch.zeros((B, cap) + t.shape[2:],
                                       dtype=t.dtype, device=t.device)
                    full[:, :t.shape[1]] = t
                    t = full
                grown[name] = t
            c = grown
        if kv is not None:
            c.update(zip(CROSS_LEAVES, (kv["k"], kv["v"])))
        cache.append(c)
    return model.head(x[:, -1:])[:, 0], cache


@torch.no_grad()
def extend_step(model: Transformer, tokens, cache, pos,
                collect_traj: bool = False):
    """tokens: (B, L) new tokens; pos: (B,) absolute index of tokens[:, 0].
    Returns (logits (B, L, V) float32, cache, traj), the cache's KV
    written in place and its stateful layers' states replaced; traj is
    {layer index: {leaf: (B, L, ...)}}, the state after every position,
    with ``collect_traj`` and {} without."""
    B, L = tokens.shape
    positions = _positions(model.cfg, B, L, pos, tokens.device)
    x = embed_apply(model.embedding, tokens, model.dtype)
    traj = {}
    for i, (blk, c) in enumerate(zip(model.layers, cache)):
        x, state, tj = blk.extend(x, positions, c, pos, collect_traj)
        if blk.stateful:
            cache[i] = state
            if collect_traj:
                traj[i] = tj
    return model.head(x), cache, traj


def init_cache(model: Transformer, batch: int, seq: int,
               paged: Optional[attn_mod.PagedSpec] = None,
               enc_seq: int = 0, spare: int = 0):
    """Empty serving cache: dense KV for attention layers (a sliding
    window's ring of min(seq, W + ``spare``) slots), zero states for
    stateful ones.  ``paged``: every eligible body attention layer (full
    GQA, ``attention.paged_eligible``) gets a shared page pool + per-slot
    page table instead of dense (B, seq, ...) KV; prefix layers, MLA and
    sliding-window layers stay dense, as the reference's.  An
    encoder-decoder model's body layers also get zero cross K/V of
    ``enc_seq`` frames."""
    cfg, dev = model.cfg, model.device
    cache = []
    for i, blk in enumerate(model.layers):
        if blk.stateful:
            cache.append(ssm.make_state(cfg, blk.block_type, batch,
                                        model.dtype, dev))
        elif paged is not None and i >= cfg.n_prefix_layers and \
                attn_mod.paged_eligible(cfg):
            cache.append(attn_mod.make_paged_kv_cache(cfg, batch, paged,
                                                      model.dtype, dev))
        else:
            cache.append(attn_mod.make_kv_cache(cfg, batch, seq,
                                                model.dtype, dev, spare))
        if model.encoder is not None and i >= cfg.n_prefix_layers:
            for name in CROSS_LEAVES:
                cache[-1][name] = torch.zeros(
                    (batch, enc_seq, cfg.n_kv_heads, cfg.head_dim),
                    dtype=model.dtype, device=dev)
    return cache


def set_page_tables(cache, pt):
    """Point every paged layer at the sanitized device table ``pt``
    (B, maxp).  The engine calls this after each host-side allocator
    change (admit / growth / rollback shrink / release)."""
    for c in cache:
        if "page_table" in c:
            c["page_table"] = pt
    return cache


@torch.no_grad()
def write_prefill_to_slot(cfg: ModelConfig, big, small, slot: int,
                          pt_row=None, length: int = 0):
    """Scatter a batch-1 prefill cache ``small`` into the multi-slot
    cache ``big``, by each layer's kind: a dense attention layer (KV or
    MLA latent) into batch row ``slot`` IN PLACE (the whole row, as the
    reference's dynamic_update_slice), a paged layer the prompt's first
    ``length`` positions through ``pt_row``, and a stateful layer's state
    into row ``slot`` of new tensors (state tensors are never written in
    place).  An encoder-decoder layer's cross K/V go into row ``slot`` in
    place, whatever the layout of its own KV."""
    for (block, _), b, s in zip(layer_kinds(cfg), big, small):
        for name in CROSS_LEAVES:
            if name in s:
                b[name][slot] = s[name][0].to(b[name].dtype)
        s = {name: t for name, t in s.items() if name not in CROSS_LEAVES}
        if "page_table" in b:
            attn_mod.prefill_into_pages(b, s, pt_row, length)
        elif block not in SEQ_BLOCKS:
            for name, t in s.items():
                b[name][slot] = t[0].to(b[name].dtype)
        else:
            for name, t in s.items():
                new = b[name].clone()
                new[slot] = t[0].to(new.dtype)
                b[name] = new
    return big


def decode_step(model: Transformer, token, cache, pos):
    """token: (B,).  Returns (logits (B, V), cache)."""
    logits, cache, _ = extend_step(model, token[:, None], cache, pos)
    return logits[:, 0], cache
