"""The attention + SwiGLU (or MoE) block and the layer stack (mirrors
``repro.models.transformer`` for GQA attention configs with a dense or a
mixture-of-experts channel mixer).  The reference scans
period-stacked parameters with ``jax.lax.scan``; the port keeps one
module per layer in an ``nn.ModuleList`` and loops in Python; in training
(``apply_train``) each layer is checkpointed, as the reference checkpoints
each scanned period."""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, param, rmsnorm
from repro_torch.models.moe import MoE


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        # norm weights stay float32: the reference reads them as float32
        self.norm1 = param(d, dtype=torch.float32, device=device, fill=1.0)
        self.attn = attn.Attention(cfg, dtype, device)
        self.norm2 = param(d, dtype=torch.float32, device=device, fill=1.0)
        if cfg.ffn_pattern == ("moe",):
            self.mlp, self.moe = None, MoE(cfg, dtype, device)
        else:
            self.mlp, self.moe = MLP(d, cfg.d_ff, dtype, device), None

    def train_forward(self, x, positions, dropless: bool = False):
        """The train-mode block over the full sequence: returns (x, aux
        loss).  The MoE mixer drops tokens past capacity unless
        ``dropless`` (the teacher-forced oracle never drops)."""
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        x = x + attn.attn_full(self.cfg, self.attn, h, positions)
        h = rmsnorm(x, self.norm2, self.cfg.rms_eps)
        if self.moe is None:
            return x + self.mlp(h), torch.zeros((), device=x.device)
        B, S, D = h.shape
        y, aux = self.moe.tokens(h.reshape(B * S, D), dropless)
        return x + y.reshape(B, S, D), aux

    def prefill(self, x, positions):
        """Returns (x, {"k", "v"}) for the prompt."""
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        a, kv = attn.attn_prefill(self.cfg, self.attn, h, positions)
        return self._ffn(x + a), kv

    def extend(self, x, positions, cache, pos):
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        a, _ = attn.attn_extend(self.cfg, self.attn, h, positions, cache,
                                pos)
        return self._ffn(x + a)

    def _ffn(self, x):
        ffn = self.mlp if self.moe is None else self.moe
        return x + ffn(rmsnorm(x, self.norm2, self.cfg.rms_eps))


def apply_train(layers, x, positions, remat: bool = True,
                dropless: bool = False):
    """The layer stack in train mode: returns (x, summed aux loss).  With
    ``remat`` each layer is checkpointed (its activations recomputed in
    the backward), as the reference's ``jax.checkpoint(period_fn)``."""
    aux = torch.zeros((), device=x.device)
    for blk in layers:
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(blk.train_forward, x, positions, dropless,
                              use_reentrant=False)
        else:
            x, a = blk.train_forward(x, positions, dropless)
        aux = aux + a
    return x, aux


def check_supported(cfg: ModelConfig):
    """The port runs GQA attention stacks with an MLP or a MoE channel
    mixer so far, with a KV cache in the compute dtype or in int8."""
    ok = (cfg.block_pattern == ("attn",)
          and cfg.ffn_pattern in (("mlp",), ("moe",))
          and cfg.n_prefix_layers == 0 and cfg.n_encoder_layers == 0
          and not cfg.is_mla and cfg.attention == "full"
          and cfg.kv_cache_dtype in ("compute", "int8")
          and cfg.frontend == "none")
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: only GQA attention + MLP/MoE configs are ported "
            "so far")
