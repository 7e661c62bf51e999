"""Model state for the port: from the reference's parameters, or drawn
fresh, and back.

``from_jax`` takes the numpy'd parameter tree of
``repro.models.init_params`` (``jax.tree.map(np.asarray, params)``, or
a checkpoint's ``train.checkpoint.load``) and fills a ``Transformer``
with it: the dense prefix layers' leaves are unstacked, prefix layer i
under ``prefix/l{i}``; body leaves are period-stacked, body layer j (layer
n_prefix + j) at index j // P of the leaves of period position ``p{j % P}``
(P the config's period, 1 for a homogeneous stack), and are unstacked one
layer each; an encoder's leaves are stacked over its layers
(``encoder/...``, the reference's ``jax.vmap``), encoder layer i at index
i.  ``to_jax_tree`` is its inverse: the reference's nested
numpy tree in float32, body leaves stacked again.  Neither imports
anything of the JAX package.

``init_params`` draws the distributions of ``repro.models.layers.
dense_init`` from an explicit ``torch.Generator`` (normal x 1/sqrt(fan_in)
for matrices, ones for norms, zeros for biases, and the reference's
constant SSM leaves) — used at full width, where no JAX runs.  ``seeded_model`` draws them from a generator seeded
on the model's device: two processes given the same (config, seed,
device type) build the same weights, which is how the edge and the cloud
of a socket session agree without parameters crossing the wire.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer


def _mlp_leaves(prefix: str, mlp):
    return {f"{prefix}/{n}": getattr(mlp, n)
            for n in ("w_gate", "w_up", "w_down")}


# each stateful mixer's leaves, under the reference's names
SSM_LEAVES = {
    "mamba": ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
              "A_log", "D", "out_proj"),
    "mlstm": ("up_proj", "w_q", "w_k", "w_v", "w_i", "w_f", "b_i", "b_f",
              "norm_w", "down_proj"),
    "slstm": ("w_in", "b_in", "r", "norm_w", "ffn_up", "ffn_down"),
}


MLA_LEAVES = ("w_q", "w_dkv", "w_krope", "w_uk", "w_uv", "w_o")


def _attn_leaves(prefix: str, a):
    """A GQA attention's projections (its biases are added by the
    caller)."""
    return {f"{prefix}/{n}": getattr(a, n) for n in ("w_q", "w_k", "w_v",
                                                     "w_o")}


def leaves(model: Transformer):
    """(parameter, jax path) pairs in a fixed order.  A prefix layer's
    path is ``prefix/l{i}/...``; a body leaf's ends in a period index:
    body layer j's leaf is row j // P of the reference's
    ``body/p{j % P}/...`` stack; encoder layer i's leaf is row i of
    ``encoder/...``."""
    out = [(model.embedding, ("embed", "embedding")),
           (model.final_norm, ("final_norm",))]
    if model.lm_head is not None:
        out.append((model.lm_head, ("embed", "lm_head")))
    P, n_prefix = model.cfg.period, model.cfg.n_prefix_layers
    for i, blk in enumerate(model.layers):
        leaves = {"norm1": blk.norm1}
        if blk.norm2 is not None:
            leaves["norm2"] = blk.norm2
        if blk.stateful:
            m = blk.mixer
            leaves.update({f"{blk.block_type}/{n}": getattr(m, n)
                           for n in SSM_LEAVES[blk.block_type]})
        elif model.cfg.is_mla:
            leaves.update({f"attn/{n}": getattr(blk.attn, n)
                           for n in MLA_LEAVES})
        else:
            leaves.update(_attn_leaves("attn", blk.attn))
        if blk.mlp is not None:
            leaves.update(_mlp_leaves("mlp", blk.mlp))
        elif blk.moe is not None:
            m = blk.moe
            leaves.update({"moe/router": m.router, "moe/w_gate": m.w_gate,
                           "moe/w_up": m.w_up, "moe/w_down": m.w_down})
            if m.shared is not None:
                leaves.update(_mlp_leaves("moe/shared", m.shared))
        if not blk.stateful and getattr(blk.attn, "b_q", None) is not None:
            a = blk.attn
            leaves.update({"attn/b_q": a.b_q, "attn/b_k": a.b_k,
                           "attn/b_v": a.b_v})
        if blk.cross is not None:
            leaves["norm_x"] = blk.norm_x
            leaves.update(_attn_leaves("cross", blk.cross))
        j = i - n_prefix
        for path, prm in leaves.items():
            if j < 0:
                out.append((prm, ("prefix", f"l{i}", *path.split("/"))))
            else:
                out.append((prm, ("body", f"p{j % P}", *path.split("/"),
                                  j // P)))
    if model.encoder is not None:
        for i, lyr in enumerate(model.encoder.layers):
            enc = {"norm1": lyr.norm1, "norm2": lyr.norm2,
                   **_attn_leaves("attn", lyr.attn),
                   **_mlp_leaves("mlp", lyr.mlp)}
            out += [(prm, ("encoder", *path.split("/"), i))
                    for path, prm in enc.items()]
    return out


@torch.no_grad()
def from_jax(params, cfg: ModelConfig, device="cuda", dtype=None,
             trainable: bool = False):
    """Build the port's model from the reference's numpy'd parameters
    (float32 masters with gradients on when ``trainable``)."""
    device = resolve_device(device)
    model = Transformer(cfg, dtype=dtype, device=device, trainable=trainable)
    for prm, path in leaves(model):
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


def to_jax_tree(model: Transformer, values=None):
    """The reference's nested parameter tree as float32 numpy arrays, body
    leaves stacked (n_periods, ...) under ``body/p{i % P}/...``: of the
    model's parameters, or of ``values``, tensors in ``leaves(model)``
    order (its gradients, or an optimizer moment)."""
    pairs = leaves(model)
    if values is None:
        values = [prm for prm, _ in pairs]
    tree, stacks = {}, {}
    for t, (_, path) in zip(values, pairs):
        arr = t.detach().float().cpu().numpy()
        if isinstance(path[-1], int):
            stacks.setdefault(path[:-1], []).append(arr)
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for path, arrs in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrs)
    return tree


def _leaf_name(path) -> str:
    return path[-2] if isinstance(path[-1], int) else path[-1]


def _fan_in(path, shape) -> int:
    """The ``in_axis_size`` the reference's init passes for one leaf: the
    input axis, which for a routed-expert stack (E, d_in, d_out) is axis
    1, for the attention output (nq, hd, d) the first two together, for
    mLSTM's per-head projections (nh, dh, dh) and sLSTM's recurrent
    weights (4, nh, dh, dh) the head width dh, and for the embedding
    (V, d) the width d.  The MLA leaves need no case of their own: each
    reads its first axis (d for w_q, w_dkv, w_krope; the rank for w_uk
    and w_uv), and w_o is (nq, v_hd, d)."""
    name = _leaf_name(path)
    if name == "embedding":
        return shape[1]
    if name == "w_o":
        return shape[0] * shape[1]
    if "moe" in path and "shared" not in path and name != "router":
        return shape[1]
    if ("mlstm" in path and name in ("w_q", "w_k", "w_v")) or name == "r":
        return shape[-1]
    return shape[0]


def _fill_constant(prm, path) -> bool:
    """Set a leaf the reference initialises to a constant (norms, biases,
    Mamba's A_log / D / dt_bias, the forget-gate biases); False for a
    random leaf."""
    name = _leaf_name(path)
    if name in ("norm1", "norm2", "norm_x", "final_norm", "norm_w", "D"):
        prm.fill_(1.0)
    elif name == "b_f":
        prm.fill_(3.0)
    elif name == "dt_bias":
        prm.fill_(-4.6)                       # softplus ~ 0.01
    elif name == "A_log":
        ds = prm.shape[-1]
        prm.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                         device=prm.device)).expand_as(prm))
    elif name == "b_in":                      # i, f, z, o: f starts at 3
        prm.zero_()
        d = prm.shape[0] // 4
        prm[d:2 * d] = 3.0
    elif name.startswith("b_") or name == "conv_b":
        prm.zero_()
    else:
        return False
    return True


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=None, trainable: bool = False):
    """Random weights with the reference's init distributions, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    model = Transformer(cfg, dtype=dtype, device=device, trainable=trainable)
    for prm, path in leaves(model):
        if not _fill_constant(prm, path):
            std = 1.0 / math.sqrt(_fan_in(path, prm.shape))
            w = torch.randn(prm.shape, generator=generator, device=device,
                            dtype=torch.float32)
            prm.copy_(w * std)
    return model


def seeded_model(cfg: ModelConfig, seed: int, device="cuda", dtype=None,
                 trainable: bool = False):
    """``init_params`` from a fresh ``torch.Generator`` on ``device``
    seeded with ``seed`` (the launch convention: target seed + 1, draft
    seed + 2)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device=device, dtype=dtype,
                       trainable=trainable)
