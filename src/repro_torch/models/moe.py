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

On DTensor weights (the dry run, ``sharding.partition.distribute``) the
dispatch runs per rank on local shards through ``local_map``, with the
placements of the reference's ``_moe_shard_map``: expert-sharded weights
over ``model`` when the experts divide it (a rank masks the assignments
of other ranks' experts, as ``expert_offset_axis`` does, and unlike the
reference counts only its own toward its experts' positions, so the
dropless capacity T holds: ROADMAP Queue 3 item 8), FFN-sharded when
they do not (qwen2-moe's 60).  Each rank's y is a partial sum over
``model`` (its experts, or its FFN slice, plus its slice of the shared
experts), summed by one all-reduce where the residual adds it.  With
dispatch groups (``GROUPS`` > 1, set by the dry run, a mesh set in
``sharding.act_sharding`` and rows dividing the data-parallel degree)
each data shard dispatches its own tokens at local capacity and the aux
loss is averaged over ``model`` and the data axes; otherwise the token
stream is gathered over the data axes first (the all-gather the
reference leaves to GSPMD) and every rank dispatches all of it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, mlp_apply, param
from repro_torch.sharding import act_sharding
from repro_torch.sharding.local import (as_dtensor, contiguous_grad,
                                       is_dtensor)


# dispatch groups: the data-parallel degree when the dry run asks for
# them (position-in-expert bookkeeping and the (E, C, D) buffers stay
# local to each data shard); 1 = one group
GROUPS = 1


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
        """(gate, expert index, router probabilities) of xf (T, D)."""
        return _route(xf, self.router, self.top_k)

    def forward(self, x):
        """x: (B, S, D) -> (B, S, D), dropless (the serve path)."""
        return self.mix(x)[0]

    def mix(self, x, dropless: bool = True):
        """x: (B, S, D) -> (y (B, S, D), aux loss)."""
        if is_dtensor(x) or is_dtensor(self.w_gate):
            return self._mix_sharded(x, dropless)
        B, S, D = x.shape
        y, aux = self.tokens(x.reshape(B * S, D), dropless)
        return y.reshape(B, S, D), aux

    def tokens(self, xf, dropless: bool = True):
        """xf: (T, D) -> (y (T, D), aux loss)."""
        shared = None if self.shared is None else \
            (self.shared.w_gate, self.shared.w_up, self.shared.w_down)
        return _dispatch(self.cfg, xf, self.router, self.w_gate, self.w_up,
                         self.w_down, shared, dropless)

    def _mix_sharded(self, x, dropless: bool):
        """``mix`` on DTensors, per rank through ``local_map`` (see the
        module docstring)."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = self.w_gate.device_mesh
        mi = list(mesh.mesh_dim_names).index("model")
        M = mesh.size(mi)
        dp = [i for i in range(mesh.ndim) if i != mi]
        D = 1
        for i in dp:
            D *= mesh.size(i)
        E = self.cfg.n_experts
        e_sh = E % M == 0
        groups = act_sharding.MESH is not None and GROUPS > 1 and \
            x.shape[0] % D == 0

        def pl(model, data=Replicate()):
            return [model if i == mi else data for i in range(mesh.ndim)]

        x_pl = pl(Replicate(), Shard(0) if groups else Replicate())
        w_in = pl(Shard(0) if e_sh else Shard(2))
        w_out = pl(Shard(0) if e_sh else Shard(1))
        args = [x, self.router, self.w_gate, self.w_up, self.w_down]
        in_pl = [x_pl, pl(Replicate()), w_in, w_in, w_out]
        if self.shared is not None:
            args += [self.shared.w_gate, self.shared.w_up,
                     self.shared.w_down]
            in_pl += [pl(Shard(1)), pl(Shard(1)), pl(Shard(0))]
        n_share = (M * D) if groups else M
        cfg = self.cfg

        def local(xl, router, wg, wu, wd, *shared):
            lo = mesh.get_local_rank(mi) * wg.shape[0] if e_sh else None
            xl = contiguous_grad(xl)
            B, S, D = xl.shape
            y, aux = _dispatch(cfg, xl.reshape(B * S, D), router, wg, wu, wd,
                               tuple(shared) or None, dropless, lo)
            # each rank's share of the mean over model (and data) ranks
            return y.reshape(B, S, D), aux / n_share

        aux_pl = pl(Partial(), Partial() if groups else Replicate())
        # gradients: the tokens' over ``model`` and the router's are
        # partial sums (each rank's experts or FFN slice); with groups the
        # weights' are partial over the data axes (each shard's tokens)
        data_grad = Partial() if groups else Replicate()
        grad_pl = [pl(Partial(), x_pl[dp[0]]), pl(Partial(), data_grad)] + \
            [[p if i == mi else data_grad for i, p in enumerate(w)]
             for w in in_pl[2:]]
        args = [as_dtensor(a, mesh) for a in args]
        return local_map(local, out_placements=(pl(Partial(), x_pl[dp[0]]),
                                                aux_pl),
                         in_placements=tuple(in_pl),
                         in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                         redistribute_inputs=True)(*args)


def _dispatch(cfg: ModelConfig, xf, router, w_gate, w_up, w_down, shared,
              dropless: bool = True, expert_lo=None):
    """One dispatch group's tokens xf (T, D) through the experts held
    here: y (T, D), aux loss.  ``expert_lo``: the first of the local
    experts (w_gate's E_loc rows) when the experts are sharded; the
    assignments of other experts are masked out (their rank's partial
    sum carries them).  ``shared``: the shared experts' (w_gate, w_up,
    w_down) or None."""
    dt = xf.dtype
    T, D = xf.shape
    k, E = cfg.moe_top_k, cfg.n_experts
    C = T if dropless else capacity(cfg, T)
    gate, eidx, probs = _route(xf, router, k)
    # Switch load balance: each token's first expert against the mean
    # router probability
    frac_tokens = F.one_hot(eidx[:, 0], E).float().mean(0)
    aux = E * (frac_tokens * probs.mean(0)).sum() * cfg.router_aux_coef
    flat_e = eidx.reshape(-1)                                   # (T*k,)
    src = xf.repeat_interleave(k, dim=0)
    local_ok = None
    if expert_lo is not None:
        E_loc = w_gate.shape[0]
        local_ok = (flat_e >= expert_lo) & (flat_e < expert_lo + E_loc)
        flat_e = torch.clamp(flat_e - expert_lo, 0, E_loc - 1)
        E = E_loc
        src = src * local_ok[:, None].to(dt)
    onehot = F.one_hot(flat_e, E)                               # (T*k, E)
    if local_ok is not None:
        # only this rank's assignments take places in its experts (the
        # reference counts the others too, clipped onto its edge experts,
        # which overflows a dropless capacity of T)
        onehot = onehot * local_ok[:, None].to(onehot.dtype)
    before = onehot.cumsum(0) - onehot         # assignments ahead of this
    pos = before.gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    if local_ok is not None:
        keep = keep & local_ok
    slot = torch.where(keep, pos, C)                  # C: the overflow bin
    buf = torch.zeros((E, C + 1, D), dtype=dt, device=xf.device)
    # dropped assignments collide in the overflow bin: a scatter-add
    buf.index_put_((flat_e, slot), src, accumulate=True)
    g = torch.bmm(buf, w_gate.to(dt))
    u = torch.bmm(buf, w_up.to(dt))
    h = F.silu(g.float()).to(dt) * u
    out = torch.bmm(h, w_down.to(dt))[flat_e, slot]             # (T*k, D)
    out = out * (gate.reshape(-1, 1).to(dt) * keep[:, None].to(dt))
    y = out.reshape(T, k, D).sum(1)
    if shared is not None:
        y = y + mlp_apply(xf, *shared)
    return y, aux


def _route(xf, router, top_k: int):
    """xf: (T, D) -> (gate (T, k) float32, expert index (T, k), router
    probabilities (T, E)).  ``jax.lax.top_k`` orders ties by the lower
    index; a stable descending sort does the same (``torch.topk``
    promises no order)."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :top_k], eidx[:, :top_k]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return gate, eidx, probs
