"""Mixture-of-Experts channel mixer (mirrors ``repro.models.moe.
_moe_tokens``): the dropless path the reference's prefill, extend and
decode call, and the capacity (dropping) path of training with the
Switch load-balance aux loss.

Per token: router softmax in float32, top-k (gate, expert), gates
renormalised with a 1e-9 floor; each (token, expert) assignment gets its
position in that expert from a one-hot cumulative sum over the flattened
token·k axis, and the tokens are scattered into an (E, C+1, D) buffer.
Dropless, capacity C is T, so no assignment ever overflows: the k
experts of one token are distinct, and one expert receives at most T
assignments.  In training C is ``capacity(cfg, T)``; assignments past it
go to row C, the overflow bin, which several dropped tokens share (a
scatter-add), and their gate is masked to 0.  Batched SwiGLU expert
products over the buffer, a gather back weighted by the gates, and the
shared experts run densely on every token.

The dispatch groups and the sharded dispatch of the reference belong to
meshes, which the port does not run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, param


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)          # round up to 8


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
        self.cfg = cfg
        self.top_k = cfg.moe_top_k
        # the reference reads the router as float32 at every dtype
        self.router = param(d, E, dtype=torch.float32, device=device)
        self.w_gate = param(E, d, f, dtype=dtype, device=device)
        self.w_up = param(E, d, f, dtype=dtype, device=device)
        self.w_down = param(E, f, d, dtype=dtype, device=device)
        self.shared = (MLP(d, cfg.n_shared_experts * f, dtype, device)
                       if cfg.n_shared_experts else None)

    def route(self, xf):
        """xf: (T, D) -> (gate (T, k) float32, expert index (T, k), router
        probabilities (T, E)).  ``jax.lax.top_k`` orders ties by the lower
        index; a stable descending sort does the same (``torch.topk``
        promises no order)."""
        probs = torch.softmax(xf.float() @ self.router, dim=-1)
        gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, eidx = gate[:, :self.top_k], eidx[:, :self.top_k]
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        return gate, eidx, probs

    def forward(self, x):
        """x: (B, S, D) -> (B, S, D), dropless (the serve path)."""
        B, S, D = x.shape
        return self.tokens(x.reshape(B * S, D))[0].reshape(B, S, D)

    def tokens(self, xf, dropless: bool = True):
        """xf: (T, D) -> (y (T, D), aux loss)."""
        dt = xf.dtype
        T, D = xf.shape
        k, E = self.top_k, self.w_gate.shape[0]
        C = T if dropless else capacity(self.cfg, T)
        gate, eidx, probs = self.route(xf)
        # Switch load balance: each token's first expert against the mean
        # router probability
        frac_tokens = F.one_hot(eidx[:, 0], E).float().mean(0)
        aux = E * (frac_tokens * probs.mean(0)).sum() * \
            self.cfg.router_aux_coef
        flat_e = eidx.reshape(-1)                               # (T*k,)
        onehot = F.one_hot(flat_e, E)                           # (T*k, E)
        before = onehot.cumsum(0) - onehot     # assignments ahead of this
        pos = before.gather(1, flat_e[:, None])[:, 0]
        keep = pos < C
        slot = torch.where(keep, pos, C)              # C: the overflow bin
        buf = torch.zeros((E, C + 1, D), dtype=dt, device=xf.device)
        # dropped assignments collide in the overflow bin: a scatter-add
        buf.index_put_((flat_e, slot), xf.repeat_interleave(k, dim=0),
                       accumulate=True)
        g = torch.bmm(buf, self.w_gate.to(dt))
        u = torch.bmm(buf, self.w_up.to(dt))
        h = F.silu(g.float()).to(dt) * u
        out = torch.bmm(h, self.w_down.to(dt))[flat_e, slot]    # (T*k, D)
        out = out * (gate.reshape(-1, 1).to(dt) * keep[:, None].to(dt))
        y = out.reshape(T, k, D).sum(1)
        if self.shared is not None:
            y = y + self.shared(xf)
        return y, aux
