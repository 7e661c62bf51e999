"""Weights made on the device from the seed, in the dtype they are served
in, by one normal draw per dtype; then handed to both sides: the system's
model takes the same tensors as its parameters, the reference reads
them by name."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn


def served_dtype(cfg: dict):
    return torch.bfloat16 if cfg.get("dtype", "bfloat16") == "bfloat16" \
        else torch.float32


def make(cfg: dict, leaves: List[tuple], seed: int, role: int,
         device) -> Dict[str, torch.Tensor]:
    """name -> tensor for every leaf; ``role`` separates the models of a
    pair drawn from one seed."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + role) % (2 ** 63))
    out = {}
    for kind, dtype in (("w", served_dtype(cfg)), ("f32", torch.float32)):
        group = [lf for lf in leaves if lf[2] == kind]
        total = sum(math.prod(lf[1]) for lf in group)
        if not total:
            continue
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        at = 0
        for name, shape, _, init, std in group:
            n = math.prod(shape)
            t = flat[at:at + n].view(shape)
            at += n
            if init == "normal":
                t.mul_(std)
            elif init == "ones":
                t.fill_(1.0)
            else:
                t.zero_()
            out[name] = t
    return out


def model_config(fields: dict):
    """The system's ModelConfig from a configuration file's fields."""
    from repro_torch.configs.base import ModelConfig
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    return ModelConfig(**kw)


def build(fields: dict, W: Dict[str, torch.Tensor]):
    """The system's model with ``W`` as its parameters (no copy)."""
    from repro_torch.models.model import Transformer
    model = Transformer(model_config(fields), device="meta")
    params = dict(model.named_parameters())
    if set(params) != set(W):
        raise ValueError(f"{fields['name']}: the system's parameters differ "
                         f"from the reference's: "
                         f"{sorted(set(params) ^ set(W))[:6]}")
    for name, p in params.items():
        t = W[name]
        if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
            raise ValueError(f"{name}: system {tuple(p.shape)} {p.dtype}, "
                             f"reference {tuple(t.shape)} {t.dtype}")
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
    return model
