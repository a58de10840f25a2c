"""Training step: the loss's gradients and an AdamW update, with microbatch
gradient accumulation and an optional int8 gradient compression.

The counterpart of ``repro.train.step``.  Gradients come from
``torch.autograd.grad`` of ``models.model.train_loss`` with respect to every
parameter leaf; the parameters carry ``requires_grad`` only inside a step.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten_like


def compress_grads_int8(grads: dict) -> dict:
    """Per-tensor symmetric int8 quantize and dequantize: the scale is
    max|g| / 127 + 1e-12, each value rounded half to even (``torch.round``,
    as ``jnp.round``) and clipped to ±127.  The training loop sees exactly
    what an int8 transport of the gradients would deliver."""
    def q(g):
        if g.ndim == 0:
            return g
        scale = g.abs().max() / 127.0 + 1e-12
        qg = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return qg.to(g.dtype) * scale

    return tree_map(q, grads)


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, gradients) of ``train_loss`` on one batch; the
    gradients a tree shaped as ``params``."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = M.train_loss(cfg, params, batch)
            grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(params, list(grads)))


def batch_grads(cfg: ModelConfig, params: dict, batch: dict,
                num_microbatches: int = 1) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, gradients) of one batch, its first axis split into
    ``num_microbatches`` microbatches whose gradients are summed in float32
    and scaled by 1 / n; the loss is their mean and the other metrics the
    last microbatch's, as the reference's scan gives."""
    n = num_microbatches
    if n == 1:
        return loss_and_grads(cfg, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    total = torch.zeros((), device=leaves(params)[0].device)
    for i in range(n):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        loss, metrics, grads = loss_and_grads(cfg, params, mb)
        acc = tree_map(torch.add, acc, grads)
        total = total + loss
    scale = 1.0 / n
    return total * scale, metrics, tree_map(lambda g: g * scale, acc)


def make_train_step(cfg: ModelConfig, oc: adamw.OptConfig,
                    num_microbatches: int = 1, compress: bool = False
                    ) -> Callable[[dict, dict, dict], tuple[dict, dict, dict]]:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`batch_grads`, the int8 compression when
    ``compress``, then ``adamw.apply`` (in place).  ``batch`` holds tensors
    on the parameters' device."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = batch_grads(cfg, params, batch,
                                           num_microbatches)
        if compress:
            grads = compress_grads_int8(grads)
        params, opt_state, om = adamw.apply(oc, grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step
