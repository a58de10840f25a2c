"""AdamW, its learning-rate schedules and global-norm clipping.

The counterpart of ``repro.optim.adamw``.  The optimizer state mirrors the
parameter dict (``mu``, ``nu``) beside an int32 step ``count``; every value
is float32, as in the reference.  :func:`apply` updates the parameters and
the state in place, under ``torch.no_grad()``, and returns them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import leaves, tree_map

#: the most elements :func:`apply` updates at once: a leaf is split along
#: its first axis into runs of rows of at most this many (one row where a
#: row is larger), so the update's float32 temporaries are a few of 256 MB
#: and not a few of the largest leaf's size (internvl2-76b's 4.2 GB
#: embedding, whose whole-leaf temporaries ran the card out of memory at
#: one layer beside 47 GB of state).  Every operation is elementwise, so
#: the split changes no bit.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"           # cosine | linear | constant
    min_lr_frac: float = 0.1


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a count of updates), float32: a
    linear warmup, then cosine or linear decay to ``min_lr_frac`` of the
    peak, or constant."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(oc.warmup_steps, 1), 1.0)
    frac = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    if oc.schedule == "cosine":
        decay = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif oc.schedule == "linear":
        decay = 1.0 - (1 - oc.min_lr_frac) * frac
    else:
        decay = torch.ones((), device=step.device)
    return oc.lr * warm * decay


def init(params: dict) -> dict:
    """Zero moments shaped as the parameters (float32) and a count of 0."""
    dev = leaves(params)[0].device
    return {"mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's sum of squares, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def apply(oc: OptConfig, grads: dict, state: dict, params: dict
          ) -> tuple[dict, dict, dict]:
    """One AdamW update with the gradients clipped to ``clip_norm`` in
    global norm; returns (params, state, metrics ``grad_norm``, ``lr``).

    In place: each parameter, ``mu`` and ``nu`` leaf is overwritten (the
    reference returns new trees), :data:`CHUNK` elements at a time;
    ``state["count"]`` is replaced."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(oc.clip_norm / (gnorm + 1e-9), 1.0)
    count = state["count"] + 1
    lr = lr_at(oc, count)
    b1, b2 = oc.betas
    f32 = torch.float32
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=count.device),
                        count.to(f32))
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=count.device),
                        count.to(f32))
    for leaf in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                    leaves(state["nu"])):
        rows = max(1, CHUNK // max(leaf[0][:1].numel(), 1))
        parts = ([x.split(rows) for x in leaf] if leaf[0].ndim
                 else [[x] for x in leaf])
        for p, g, m, n in zip(*parts):
            g = g.to(f32) * scale
            m.mul_(b1).add_(g * (1 - b1))
            n.mul_(b2).add_(g * (1 - b2) * g)
            step = (m / bc1) / (torch.sqrt(n / bc2) + oc.eps)
            pf = p.to(f32)
            p.copy_((pf - lr * (step + oc.weight_decay * pf)).to(p.dtype))
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
