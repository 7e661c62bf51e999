"""Shared layer primitives: RMSNorm, RoPE and M-RoPE, SwiGLU MLP,
embedding and LM head (mirrors ``repro.models.layers``).

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
from repro_torch.sharding.local import embedding_rows, is_dtensor


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


def _rotate(x, ang):
    """Rotate the two halves of x (..., S, H, hd) by the float32 angles
    ang (..., S, hd/2), shared over the heads."""
    ang = ang[..., None, :]                                  # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, sections, theta: float):
    """Multimodal RoPE (Qwen2-VL).  positions3: (3, B, S), the (t, h, w)
    ids; ``sections`` partitions the hd/2 frequencies among the three
    id streams, in order (frequency i reads stream ``repeat(arange(3),
    sections)[i]``)."""
    hd = x.shape[-1]
    half = hd // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_freqs(hd, theta, x.device)                  # (half,)
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)  # (half,)
    pos = positions3.float()[sec_id].movedim(0, -1)          # (B, S, half)
    return _rotate(x, pos * freqs)


def rope_apply_by_cfg(cfg: ModelConfig, x, positions):
    """positions: (B, S) for rope; (3, B, S) for mrope, where text-only
    (B, S) positions stand for t == h == w."""
    if cfg.rope_type == "none":
        return x
    if cfg.rope_type == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand((3,) + positions.shape)
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
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
        return mlp_apply(x, self.w_gate, self.w_up, self.w_down)


def mlp_apply(x, w_gate, w_up, w_down):
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    return (torch.nn.functional.silu(g.float()).to(dt) * u) @ w_down.to(dt)


# ----------------------------------------------------------------------
# Embedding / LM head
# ----------------------------------------------------------------------
def embed_apply(embedding, tokens, dtype):
    """On a DTensor table each rank looks up its block of the vocabulary
    (``sharding.local.embedding_rows``)."""
    if is_dtensor(embedding):
        return embedding_rows(embedding, tokens, dtype)
    return embedding[tokens].to(dtype)


def lm_head_apply(embedding, lm_head, x):
    """Tied heads (lm_head None) project onto the embedding matrix."""
    if lm_head is None:
        return x @ embedding.to(x.dtype).T
    return x @ lm_head.to(x.dtype)
