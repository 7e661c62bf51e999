"""Block composition and the layer stack (mirrors
``repro.models.transformer``).  The first ``cfg.n_prefix_layers`` layers
are dense blocks ``("attn", "mlp")`` (DeepSeek-V2's first layer); body
layer i >= n_prefix is the block ``(cfg.block_pattern[j % P],
cfg.ffn_pattern[j % P])`` of the period P, j = i - n_prefix: a sequence
mixer (GQA or MLA attention, Mamba, mLSTM or sLSTM) and a channel mixer
(SwiGLU MLP, mixture of experts, or none: xLSTM's blocks carry their own
projections and have no second norm).  The reference scans
period-stacked parameters with ``jax.lax.scan``; the port keeps one
module per layer in an ``nn.ModuleList`` and loops in Python; in training
(``apply_train``) each layer is checkpointed, as the reference
checkpoints each scanned period.

An attention layer's cache is its KV (or MLA latent) cache, written in
place by ``extend``; a stateful layer's cache is its recurrent state, which
``prefill`` and ``extend`` return as new tensors (with ``collect_traj``,
also the state after every position, for speculative-decoding
rollback).

An encoder-decoder model's blocks carry cross-attention (``norm_x`` and a
bias-free ``cross`` attention), applied after the sequence mixer and
before the channel mixer: in training from the encoder's output, in
prefill from the layer's cross K/V, in extend from the K/V cached beside
the layer's own KV (``CROSS_LEAVES``), which extend only reads."""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import MLP, param, rmsnorm
from repro_torch.models.moe import MoE
from repro_torch.sharding import act_sharding
from repro_torch.sharding.local import (gathered_over_data, is_dtensor,
                                       settled)

SEQ_BLOCKS = tuple(ssm.MIXERS)
# an encoder-decoder layer's cached cross K/V, beside its own KV leaves
CROSS_LEAVES = ("cross_k", "cross_v")


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, block_type: str, ffn_type: str,
                 dtype, device):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.block_type, self.ffn_type = block_type, ffn_type
        self.stateful = block_type in SEQ_BLOCKS
        # norm weights stay float32: the reference reads them as float32
        self.norm1 = param(d, dtype=torch.float32, device=device, fill=1.0)
        if block_type == "attn":
            mixer = attn.MLA if cfg.is_mla else attn.Attention
        else:
            mixer = ssm.MIXERS[block_type]
        # under the reference's name: attn | mamba | mlstm | slstm
        self.add_module(block_type, mixer(cfg, dtype, device))
        self.norm2 = None if ffn_type == "none" else \
            param(d, dtype=torch.float32, device=device, fill=1.0)
        self.mlp = MLP(d, cfg.d_ff, dtype, device) if ffn_type == "mlp" \
            else None
        self.moe = MoE(cfg, dtype, device) if ffn_type == "moe" else None
        if cfg.n_encoder_layers:
            self.norm_x = param(d, dtype=torch.float32, device=device,
                                fill=1.0)
            self.cross = attn.Attention(cfg, dtype, device, cross=True)
        else:
            self.norm_x = self.cross = None

    @property
    def mixer(self):
        return getattr(self, self.block_type)

    def train_forward(self, x, positions, dropless: bool = False,
                      enc_out=None):
        """The train-mode block over the full sequence: returns (x, aux
        loss).  The MoE mixer drops tokens past capacity unless
        ``dropless`` (the teacher-forced oracle never drops); a decoder
        block attends to ``enc_out``, the encoder's output."""
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        if self.stateful:
            a = ssm.train_seq(self.cfg, self.block_type, self.mixer, h)
        elif self.cfg.is_mla:
            a = attn.mla_full(self.cfg, self.attn, h, positions)
        else:
            a = attn.attn_full(self.cfg, self.attn, h, positions)
        x = x + settled(a)
        if enc_out is not None:
            x = self._cross(x, attn.cross_kv(self.cfg, self.cross, enc_out))
        if self.moe is None:
            return self._ffn(x), torch.zeros((), device=x.device)
        y, aux = self.moe.mix(rmsnorm(x, self.norm2, self.cfg.rms_eps),
                              dropless)
        return x + settled(y), aux

    def prefill(self, x, positions, cross_kv=None, spare: int = 0):
        """Returns (x, cache leaves): the prompt's {"k", "v"} (a sliding
        window's ring of W + ``spare`` slots; MLA: {"latent",
        "k_rope"}), or the recurrent state after the prompt.  A decoder
        block attends to ``cross_kv``, its cross K/V."""
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        if self.stateful:
            a, c, _ = ssm.seq(self.cfg, self.block_type, self.mixer, h)
        elif self.cfg.is_mla:
            a, c = attn.mla_full(self.cfg, self.attn, h, positions,
                                 return_cache=True)
        else:
            a, c = attn.attn_prefill(self.cfg, self.attn, h, positions,
                                     spare)
        x = x + settled(a)
        if cross_kv is not None:
            x = self._cross(x, cross_kv)
        return self._ffn(x), c

    def extend(self, x, positions, cache, pos, collect_traj: bool = False):
        """Returns (x, new state, trajectory): the state and trajectory of
        a stateful layer (the trajectory only with ``collect_traj``), None
        for attention, whose KV cache is written in place and rolls back
        by position."""
        h = rmsnorm(x, self.norm1, self.cfg.rms_eps)
        state = traj = None
        if self.stateful:
            a, state, traj = ssm.seq(self.cfg, self.block_type, self.mixer,
                                     h, cache, collect_traj)
        elif self.cfg.is_mla:
            a, _ = attn.mla_extend(self.cfg, self.attn, h, positions, cache,
                                   pos)
        else:
            a, _ = attn.attn_extend(self.cfg, self.attn, h, positions, cache,
                                    pos)
        x = x + settled(a)
        if self.cross is not None and "cross_k" in cache:
            x = self._cross(x, {"k": cache["cross_k"],
                                "v": cache["cross_v"]})
        return self._ffn(x), state, traj

    def _cross(self, x, kv):
        hx = rmsnorm(x, self.norm_x, self.cfg.rms_eps)
        return x + settled(attn.cross_attend(self.cfg, self.cross, hx, kv))

    def _ffn(self, x):
        if self.norm2 is None:
            return x
        ffn = self.mlp if self.moe is None else self.moe
        return x + settled(ffn(rmsnorm(x, self.norm2, self.cfg.rms_eps)))


def layer_kinds(cfg: ModelConfig):
    """(block type, ffn type) of every layer: the dense prefix, then the
    body's period pattern from its own layer 0."""
    P, n = cfg.period, cfg.n_prefix_layers
    return [("attn", "mlp")] * n + [
        (cfg.block_pattern[(i - n) % P], cfg.ffn_pattern[(i - n) % P])
        for i in range(n, cfg.n_layers)]


def make_layers(cfg: ModelConfig, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg, b, f, dtype, device)
                         for b, f in layer_kinds(cfg))


def apply_train(layers, x, positions, remat: bool = True,
                dropless: bool = False, enc_out=None, n_prefix: int = 0):
    """The layer stack in train mode: returns (x, summed aux loss).  With
    ``remat`` each layer is checkpointed (its activations recomputed in
    the backward), as the reference's ``jax.checkpoint(period_fn)``.  The
    body's layers (after the ``n_prefix`` prefix layers) attend to
    ``enc_out``, as the reference's body scan does."""
    aux = torch.zeros((), device=x.device)
    for i, blk in enumerate(layers):
        eo = enc_out if i >= n_prefix else None
        x = act_sharding.residual_constraint(x)
        fwd = blk.train_forward
        if is_dtensor(blk.norm1):
            # FSDP gathers a layer's weights at use, again in the recompute
            fwd = functools.partial(_gathered_forward, blk)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(fwd, x, positions, dropless, eo,
                              use_reentrant=False)
        else:
            x, a = fwd(x, positions, dropless, eo)
        aux = aux + a
    return x, aux


def _gathered_forward(blk, *args):
    with gathered_over_data(blk):
        return blk.train_forward(*args)


def check_supported(cfg: ModelConfig):
    """The port runs GQA (full or sliding-window) and MLA attention,
    Mamba, mLSTM and sLSTM blocks with an MLP, a MoE or no channel mixer,
    after dense prefix layers, with a KV cache in the compute dtype or in
    int8, and an encoder before a GQA decoder, behind the audio or vision
    frontend stubs.  MLA attends over the full context: the reference's
    MLA ignores a window in its math but sizes the cache by it, so the
    port refuses the combination.  An encoder before MLA or stateful
    decoder layers is refused too (no config has one; a stateful layer's
    rollback replaces its cache, cross K/V included)."""
    ok = (set(cfg.block_pattern) <= {"attn", *SEQ_BLOCKS}
          and set(cfg.ffn_pattern) <= {"mlp", "moe", "none"}
          and cfg.attention in ("full", "sliding")
          and not (cfg.is_mla and cfg.attention == "sliding")
          and not (cfg.n_encoder_layers and (
              cfg.is_mla or set(cfg.block_pattern) != {"attn"}))
          and cfg.kv_cache_dtype in ("compute", "int8")
          and cfg.frontend in ("none", "audio", "vision"))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: only GQA (full or sliding) / MLA attention, "
            "Mamba, mLSTM and sLSTM blocks with an MLP, MoE or no channel "
            "mixer, and an encoder before GQA decoder layers, are ported")
