"""Public wrappers around the Hopper kernels (mirrors ``repro.kernels.ops``).

The SQS wrappers pad the vocabulary to a multiple of 128 with -inf
logits and adapt the kernel outputs to ``core.sqs.SQSResult``, so the
engine swaps the ``core.sqs`` path and the fused path with one flag.
The decode-attention wrappers take the reference's signatures and return
f32; no model path calls them, as in the reference (the model's
attention runs ``models.attention._extend_core`` in both cache layouts).
On a CUDA tensor the Hopper kernels run; on a CPU tensor their plain
twins.
"""
from __future__ import annotations

import torch

from repro_torch.core.slq import reciprocal
from repro_torch.core.sqs import SQSResult
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import sqs_fused as k


def pad_logits(logits):
    B, V = logits.shape
    Vp = k.pad_vocab(V)
    lp = logits.float()
    if Vp != V:
        lp = torch.nn.functional.pad(lp, (0, Vp - V), value=-torch.inf)
    return lp.contiguous(), V


def _result(b, mask, stats, V: int, ell: int) -> SQSResult:
    return SQSResult(b[:, :V].float() * reciprocal(ell), mask[:, :V].bool(),
                     stats[:, 0], stats[:, 1].to(torch.int32))


def sqs_threshold(logits, beta, temperature: float = 1.0,
                  ell: int = 100) -> SQSResult:
    """C-SQS edge step, fused:  softmax(T) → support {q ≥ β} of the V
    true tokens (K <= V at any β, as ``core.sqs.sparsify_threshold``) →
    dropped mass → lattice counts with Σb = ℓ exact.  logits: (B, V);
    beta: (B,)."""
    lp, V = pad_logits(logits)
    beta2 = torch.stack([beta, beta], -1).float().contiguous()
    b, mask, stats = k.sqs_fused(lp, beta2,
                                 inv_temp=1.0 / max(temperature, 1e-4),
                                 ell=ell, V=V)
    return _result(b, mask, stats, V, ell)


def sqs_topk(logits, K: int, temperature: float = 1.0,
             ell: int = 100) -> SQSResult:
    """K-SQS edge step: the exact top-K threshold (softmax fused in) +
    fused quantizer, keeping the K largest probabilities (ties at the K-th
    by index) at any temperature."""
    lp, V = pad_logits(logits)
    it = 1.0 / max(temperature, 1e-4)
    tau = k.topk_threshold(lp, K, inv_temp=it)
    b, mask, stats = k.sqs_fused(lp, tau, inv_temp=it, ell=ell, exact_k=K)
    return _result(b, mask, stats, V, ell)


def gqa_decode(q, k, v, pos, k_scale=None, v_scale=None):
    """Flash-decode GQA attention over a contiguous cache (optional int8
    KV with per-(position, head) scales); positions > pos are masked.
    q: (B, nq, hd); k/v: (B, S, nkv, hd).  Returns (B, nq, hd) f32."""
    return da.flash_gqa_decode(q, k, v, pos.to(torch.int32), k_scale,
                               v_scale)


def paged_gqa_decode(q, k, v, page_table, pos, k_scale=None, v_scale=None):
    """Paged flash-decode GQA attention: K/V in a shared page pool
    (P, page_size, nkv, hd) addressed through ``page_table``
    (B, max_pages), every entry a valid pool row (map host FREE entries
    to the trash page first).  Returns (B, nq, hd) f32."""
    return da.paged_flash_gqa_decode(q, k, v, page_table.to(torch.int32),
                                     pos.to(torch.int32), k_scale, v_scale)
