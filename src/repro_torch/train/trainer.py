"""Training step: loss -> gradients -> AdamW, with optional microbatch
gradient accumulation (mirrors ``repro.train.trainer``; the layer stack
checkpoints each layer when ``remat``)."""
from __future__ import annotations

import torch

from repro_torch.bridge import leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.sharding.local import laid_out_as
from repro_torch.train import optimizer as opt_mod


def parameters(model):
    """The model's parameters in ``leaves`` order, the order of the
    optimizer state (``optimizer.init_state(parameters(model))``)."""
    return [prm for prm, _ in leaves(model)]


def decay_mask(model):
    """Per ``leaves(model)`` entry: whether the reference's leaf has two or
    more dimensions (body leaves carry a leading layer axis there)."""
    return [prm.ndim + isinstance(path[-1], int) >= 2
            for prm, path in leaves(model)]


def loss_and_grads(model, batch, microbatches: int = 1, remat: bool = True):
    """The train step up to its update: (loss, metrics, gradients in
    ``parameters(model)`` order, laid out as their parameters), the
    gradients accumulated in float32 over the microbatches and divided by
    their count, the loss and metrics their means (see
    ``make_train_step``)."""
    params = parameters(model)
    B = batch["tokens"].shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not divide into "
                         f"{microbatches} microbatches")
    positions = batch.get("positions")
    if microbatches > 1 and positions is not None and positions.ndim == 3:
        raise ValueError("(3, B, S) M-RoPE positions cannot be split "
                         "into microbatches on axis 0; use "
                         "microbatches=1")
    n = B // microbatches
    losses, metrics = [], []
    for i in range(microbatches):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        loss, mets = model_mod.train_loss(model, mb, remat=remat)
        loss.backward()                 # accumulates into .grad
        losses.append(loss.detach())
        metrics.append({k: v.detach() for k, v in mets.items()})
    # DTensor gradients come back partial over the data axes: summed
    # into the parameters' layout here (a no-op on plain tensors)
    grads = [laid_out_as(prm.grad, prm) for prm in params]
    if microbatches == 1:
        return losses[0], metrics[0], grads
    for g in grads:
        g.div_(microbatches)
    loss = sum(losses, torch.zeros_like(losses[0])) / microbatches
    metrics = {k: torch.stack([m[k] for m in metrics]).mean()
               for k in metrics[0]}
    return loss, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                    microbatches: int = 1, remat: bool = True):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics), the model's float32 masters (``trainable=True``) updated in
    place.  ``batch["tokens"]``: (B, S+1); B must divide by
    ``microbatches``, and every leaf is split on its first axis, so (3, B,
    S) M-RoPE positions are refused with more than one microbatch (their
    batch is axis 1; the reference's split slices them wrongly).
    Gradients accumulate in float32 over the microbatches and are divided
    by their count; the loss and metrics are their means."""

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError(f"train step for {cfg.name}, model is "
                             f"{model.cfg.name}")
        params = parameters(model)
        loss, metrics, grads = loss_and_grads(model, batch, microbatches,
                                              remat)
        _, opt_state, om = opt_mod.apply_updates(opt_cfg, params, grads,
                                                 opt_state,
                                                 decay_mask(model))
        for prm in params:
            prm.grad = None
        return model, opt_state, dict(metrics, loss=loss, **om)

    return train_step
