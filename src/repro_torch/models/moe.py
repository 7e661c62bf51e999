"""Mixture-of-Experts channel mixer, the dropless inference path (mirrors
``repro.models.moe._moe_tokens`` with ``dropless=True``, which is how the
reference's prefill, extend and decode call it).

Per token: router softmax in float32, top-k (gate, expert), gates
renormalised with a 1e-9 floor; each (token, expert) assignment gets its
position in that expert from a one-hot cumulative sum over the flattened
token·k axis, and the tokens are scattered into an (E, T+1, D) buffer.
Capacity is T, so no assignment ever overflows: the k experts of one
token are distinct, and one expert receives at most T assignments (row T
is the reference's overflow bin and stays empty).  Batched SwiGLU expert
products over the buffer, a gather back weighted by the gates, and the
shared experts run densely on every token.

The capacity (dropping) path, the dispatch groups and the sharded
dispatch of the reference belong to training and meshes, which the port
does not run yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, frozen


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.top_k = cfg.moe_top_k
        # the reference reads the router as float32 at every dtype
        self.router = frozen(d, E, dtype=torch.float32, device=device)
        self.w_gate = frozen(E, d, f, dtype=dtype, device=device)
        self.w_up = frozen(E, d, f, dtype=dtype, device=device)
        self.w_down = frozen(E, f, d, dtype=dtype, device=device)
        self.shared = (MLP(d, cfg.n_shared_experts * f, dtype, device)
                       if cfg.n_shared_experts else None)

    def route(self, xf):
        """xf: (T, D) -> (gate (T, k) float32, expert index (T, k)).
        ``jax.lax.top_k`` orders ties by the lower index; a stable
        descending sort does the same (``torch.topk`` promises no order)."""
        probs = torch.softmax(xf.float() @ self.router, dim=-1)
        gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, eidx = gate[:, :self.top_k], eidx[:, :self.top_k]
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return gate, eidx

    def forward(self, x):
        """x: (B, S, D) -> (B, S, D)."""
        B, S, D = x.shape
        return self.tokens(x.reshape(B * S, D)).reshape(B, S, D)

    def tokens(self, xf):
        dt = xf.dtype
        T, D = xf.shape
        k, E = self.top_k, self.w_gate.shape[0]
        gate, eidx = self.route(xf)
        flat_e = eidx.reshape(-1)                               # (T*k,)
        onehot = F.one_hot(flat_e, E)                           # (T*k, E)
        before = onehot.cumsum(0) - onehot     # assignments ahead of this
        slot = before.gather(1, flat_e[:, None])[:, 0]
        buf = torch.zeros((E, T + 1, D), dtype=dt, device=xf.device)
        # every (expert, slot) pair is distinct: a plain scatter
        buf[flat_e, slot] = xf.repeat_interleave(k, dim=0)
        g = torch.bmm(buf, self.w_gate)
        u = torch.bmm(buf, self.w_up)
        h = F.silu(g.float()).to(dt) * u
        out = torch.bmm(h, self.w_down)[flat_e, slot]           # (T*k, D)
        y = (out * gate.reshape(-1, 1).to(dt)).reshape(T, k, D).sum(1)
        if self.shared is not None:
            y = y + self.shared(xf)
        return y
