"""Hand-rolled AdamW + warmup-cosine schedule (mirrors
``repro.train.optimizer``).

Parameters are the model's float32 masters, a list in
``bridge.leaves`` order, updated in place.  Every constant is float32: a
0-d float32 tensor, or a scalar that the kernel rounds to float32, as
the reference's weakly typed Python scalars are, so no float64
arithmetic takes part.  Decoupled weight decay applies where the
reference's leaf is a matrix or more (``decay``): its body leaves are
stacked over layers, so the per-layer norms and biases are decayed too,
and only ``final_norm`` is not.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.sharding.local import local_of, replicated


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1


def _f32(x, device):
    """A float32 constant made on ``device`` (a fill, not a host copy, so
    a step never waits for the card)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac *
    lr``; float32 (0-d) like ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = step / _f32(max(cfg.warmup_steps, 1), dev)
    prog = torch.clamp((step - _f32(cfg.warmup_steps, dev))
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                              dev), 0.0, 1.0)
    cos = _f32(cfg.min_lr_frac, dev) + \
        _f32((1 - cfg.min_lr_frac) * 0.5, dev) * \
        (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev) * prog))
    return _f32(cfg.lr, dev) * torch.where(step < cfg.warmup_steps, warm,
                                           cos)


def init_state(params):
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": torch.zeros((), dtype=torch.int32,
                                device=params[0].device)}


def global_norm(tensors):
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.stack(norms).square().sum())


# leaves updated by one set of fused multi-tensor operations: bounds the
# temporaries (two moments' worth) to a group's size
GROUP = 32


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, decay):
    """One AdamW step with global-norm clipping; the parameters and the
    moments are updated in place.  ``decay[i]``: whether the reference's
    leaf of ``params[i]`` has two or more dimensions.  Returns (params,
    state, metrics)."""
    dev = params[0].device
    step = state["step"] + 1
    gn = replicated(global_norm(grads))
    scale = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev)
                          / torch.maximum(gn, _f32(1e-9, dev)))
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    c1 = _f32(1.0, dev) - torch.pow(_f32(cfg.b1, dev), stepf)
    c2 = _f32(1.0, dev) - torch.pow(_f32(cfg.b2, dev), stepf)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    # on DTensors every tensor of the update is laid out as its parameter
    # and the scalars are replicated, so each rank updates its own shards:
    # the multi-tensor ops run on the local tensors, in place
    params_l, m_l, v_l, grads_l = ([local_of(t) for t in x] for x in (
        params, state["m"], state["v"], grads))
    scale_l, lr_l, c1_l, c2_l = (local_of(t) for t in (scale, lr, c1, c2))
    # per element: m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g^2 as
    # scaled adds, delta = (m / c1) / (sqrt(v / c2) + eps) (+ wd p), then
    # p - lr delta; one multi-tensor kernel an operation over a group
    for i in range(0, len(params), GROUP):
        p, m, v = (x[i:i + GROUP] for x in (params_l, m_l, v_l))
        g = torch._foreach_mul([x.float() for x in grads_l[i:i + GROUP]],
                               scale_l)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - cfg.b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - cfg.b2)
        den = torch._foreach_div(v, c2_l)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(m, c1_l)
        torch._foreach_div_(delta, den)
        dec = [j for j in range(len(p)) if decay[i + j]]
        if dec:
            torch._foreach_add_([delta[j] for j in dec], [p[j] for j in dec],
                                alpha=cfg.weight_decay)
        torch._foreach_mul_(delta, lr_l)
        torch._foreach_sub_(p, delta)
    state["step"] = step
    return params, state, {"grad_norm": gn, "lr": lr}
