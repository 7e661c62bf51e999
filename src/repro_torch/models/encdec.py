"""Encoder stack of the encoder-decoder models (SeamlessM4T's backbone;
mirrors ``repro.models.encdec``).

The encoder takes precomputed frame embeddings from the stubbed audio
frontend (``models.frontend``) and runs bidirectional attention, every
position at 0.  The decoder's cross-attention lives in
``transformer.Block``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.local import settled
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, param, rmsnorm


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.norm1 = param(d, dtype=torch.float32, device=device, fill=1.0)
        self.attn = attn.Attention(cfg, dtype, device, cross=True)
        self.norm2 = param(d, dtype=torch.float32, device=device, fill=1.0)
        self.mlp = MLP(d, cfg.d_ff, dtype, device)


class Encoder(nn.Module):
    """``cfg.n_encoder_layers`` layers of norm1, bias-free attention,
    norm2 and a SwiGLU MLP (the reference stacks them by ``jax.vmap``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(EncoderLayer(cfg, dtype, device)
                                    for _ in range(cfg.n_encoder_layers))


def encode(enc: Encoder, embeds, valid=None):
    """embeds: (B, S_enc, d) from the frontend stub, in the compute dtype;
    ``valid`` (B, S_enc) masks padded frames out of every key set.
    Returns the encoder's output (B, S_enc, d)."""
    cfg = enc.cfg
    B, S, _ = embeds.shape
    pos = torch.zeros((B, S), dtype=torch.int64, device=embeds.device)
    x = embeds
    for lyr in enc.layers:
        h = rmsnorm(x, lyr.norm1, cfg.rms_eps)
        a = lyr.attn
        q, k, v = (attn._proj(h, w) for w in (a.w_q, a.w_k, a.w_v))
        o = attn.masked_attention(q, k, v, pos, pos, causal=False,
                                  k_valid=valid)
        x = x + settled(attn._out(o, a.w_o))
        x = x + settled(lyr.mlp(rmsnorm(x, lyr.norm2, cfg.rms_eps)))
    return x
