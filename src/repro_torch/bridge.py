"""Model state for the port: from the reference's parameters, or drawn
fresh.

``from_jax`` takes the numpy'd parameter tree of
``repro.models.init_params`` (``jax.tree.map(np.asarray, params)``) and
fills a ``Transformer`` with it: body leaves are period-stacked
``(N, ...)`` and are unstacked one layer each.  It receives numpy arrays
only and imports nothing of the JAX package.

``init_params`` draws the distributions of ``repro.models.layers.
dense_init`` from an explicit ``torch.Generator`` (normal x 1/sqrt(fan_in)
for matrices, ones for norms, zeros for biases) — used at full width,
where no JAX runs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer


def _named(model: Transformer):
    """(parameter, jax path) pairs; a path ends in a layer index for body
    leaves."""
    out = [(model.embedding, ("embed", "embedding")),
           (model.final_norm, ("final_norm",))]
    if model.lm_head is not None:
        out.append((model.lm_head, ("embed", "lm_head")))
    for i, blk in enumerate(model.layers):
        a = blk.attn
        leaves = {"norm1": blk.norm1, "norm2": blk.norm2,
                  "attn/w_q": a.w_q, "attn/w_k": a.w_k, "attn/w_v": a.w_v,
                  "attn/w_o": a.w_o, "mlp/w_gate": blk.mlp.w_gate,
                  "mlp/w_up": blk.mlp.w_up, "mlp/w_down": blk.mlp.w_down}
        if a.b_q is not None:
            leaves.update({"attn/b_q": a.b_q, "attn/b_k": a.b_k,
                           "attn/b_v": a.b_v})
        for path, prm in leaves.items():
            out.append((prm, ("body", "p0", *path.split("/"), i)))
    return out


@torch.no_grad()
def from_jax(params, cfg: ModelConfig, device="cuda", dtype=None):
    """Build the port's model from the reference's numpy'd parameters."""
    device = resolve_device(device)
    model = Transformer(cfg, dtype=dtype, device=device)
    for prm, path in _named(model):
        node = params
        for key in path[:-1] if isinstance(path[-1], int) else path:
            node = node[key]
        arr = np.asarray(node)
        if isinstance(path[-1], int):
            arr = arr[path[-1]]
        if arr.shape != tuple(prm.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: {arr.shape} vs "
                             f"{tuple(prm.shape)}")
        prm.copy_(torch.from_numpy(np.array(arr)))
    return model


def _fan_in(path) -> int:
    name, shape = path
    if name == "w_o":
        return shape[0] * shape[1]
    return shape[0]


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=None):
    """Random weights with the reference's init distributions, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    model = Transformer(cfg, dtype=dtype, device=device)
    for prm, path in _named(model):
        name = path[-2] if isinstance(path[-1], int) else path[-1]
        if name in ("norm1", "norm2", "final_norm"):
            prm.fill_(1.0)
        elif name.startswith("b_"):
            prm.zero_()
        else:
            std = 1.0 / math.sqrt(_fan_in((name, prm.shape)))
            w = torch.randn(prm.shape, generator=generator, device=device,
                            dtype=torch.float32)
            prm.copy_(w * std)
    return model
