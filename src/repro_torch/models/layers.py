"""Shared layer primitives: RMSNorm, RoPE, SwiGLU MLP, embedding and LM
head (mirrors ``repro.models.layers``; M-RoPE comes with its family).

A serving model stores its weights in the config's compute dtype (bf16
for the full-size configs, float32 for the smoke variants); a model built
for training holds float32 masters with gradients on, as the reference's
parameters are.  Every use casts a weight to the compute dtype, as the
reference's ``w.astype(dt)`` does; where the dtypes already match (a
serving model, a float32 variant) the cast returns the weight itself.
Norm weights, which the reference reads as float32, stay float32.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig


def compute_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param(*shape, dtype, device, fill=None):
    """A parameter created without a gradient (a model built for training
    turns gradients on for all of them), uninitialised unless ``fill`` is
    given."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------
def rmsnorm(x, w, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.float()).to(dt)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device):
    half = head_dim // 2
    e = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), e)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (B, S, hd/2)
    ang = ang[..., None, :]                                  # (B, S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope_apply_by_cfg(cfg: ModelConfig, x, positions):
    if cfg.rope_type == "none":
        return x
    if cfg.rope_type != "rope":
        raise NotImplementedError(f"rope_type {cfg.rope_type!r} is not "
                                  "ported yet")
    return apply_rope(x, positions, cfg.rope_theta)


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device):
        super().__init__()
        self.w_gate = param(d_model, d_ff, dtype=dtype, device=device)
        self.w_up = param(d_model, d_ff, dtype=dtype, device=device)
        self.w_down = param(d_ff, d_model, dtype=dtype, device=device)

    def forward(self, x):
        dt = x.dtype
        g = x @ self.w_gate.to(dt)
        u = x @ self.w_up.to(dt)
        return (torch.nn.functional.silu(g.float()).to(dt) * u) @ \
            self.w_down.to(dt)


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------
def embed_apply(embedding, tokens, dtype):
    return embedding[tokens].to(dtype)


def lm_head_apply(embedding, lm_head, x):
    """Tied heads (lm_head None) project onto the embedding matrix."""
    if lm_head is None:
        return x @ embedding.to(x.dtype).T
    return x @ lm_head.to(x.dtype)
