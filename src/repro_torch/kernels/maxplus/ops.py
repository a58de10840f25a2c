"""Batched tropical closure for DAG ranks and critical paths.

The counterpart of the JAX package's ``repro.kernels.maxplus.ops``: the
longest-path closure of a padded dense adjacency by ``ceil(log2 p)``
tropical squarings, each one call of :func:`maxplus.maxplus_matmul`.  The
JAX package ``vmap``s the closure over a batch of graphs; here the batch is
a leading dimension, so one kernel launch covers every lane of a squaring.

The device of the tensors decides the path: tensors on the card launch the
CUDA kernel, tensors on the CPU take the plain version.  The arithmetic is
the JAX package's, operation for operation, so on the CPU the results equal
it bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .maxplus import NEG_INF, maxplus_matmul

__all__ = ["dense_adjacency", "squarings", "closure_input",
           "longest_path_closure", "batched_ranks"]


def dense_adjacency(n: int, edges, pad_to: int = 128) -> np.ndarray:
    """(p, p) float32 matrix: 0.0 on edges, NEG_INF elsewhere (p = padded n)."""
    p = max(pad_to, int(np.ceil(n / pad_to)) * pad_to)
    adj = np.full((p, p), NEG_INF, dtype=np.float32)
    ij = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    adj[ij[:, 0], ij[:, 1]] = 0.0
    return adj


def squarings(p: int) -> int:
    """Tropical squarings the closure of a p-node graph takes: the kernel
    launches of one :func:`longest_path_closure` call."""
    return math.ceil(math.log2(max(p, 2)))


def closure_input(adj: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """The matrix the closure squares first, I_tropical ⊕ W, where
    W[.., i, j] = times[.., i] + adj[.., i, j] is the adjacency
    edge-weighted by the source's duration; float32, adj's shape."""
    p = adj.shape[-1]
    w = times.to(torch.float32)[..., :, None] + adj.to(torch.float32)
    eye = torch.full((p, p), NEG_INF, dtype=torch.float32, device=adj.device)
    eye.fill_diagonal_(0.0)
    return torch.maximum(eye, w)


def longest_path_closure(adj: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Finish times for every task of a dense-adjacency DAG.

    adj: (p, p) or (B, p, p) with 0.0 edges / NEG_INF; times: (p,) or
    (B, p) processing times (padding rows must carry times = 0).
    O(p³ log p) per lane — profitable for batches of graphs of a few
    thousand tasks, not for one huge sparse graph.
    """
    if adj.shape[-1] != adj.shape[-2] or adj.shape[:-1] != times.shape:
        raise ValueError(f"adjacency {tuple(adj.shape)} does not match "
                         f"times {tuple(times.shape)}")
    if adj.device != times.device:
        raise ValueError(f"adj is on {adj.device} and times on {times.device}")
    times = times.to(torch.float32)
    # closure by repeated squaring of (I_tropical ⊕ W)
    c = closure_input(adj, times)
    for _ in range(squarings(adj.shape[-1])):
        c = maxplus_matmul(c, c)
    # longest incoming path weight + own time
    best_in = c.amax(dim=-2)
    return torch.maximum(times, best_in + times)


def batched_ranks(adjs: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Upward ranks for a batch of DAGs: rank = longest path to any sink,
    computed on the reversed graphs.  adjs: (B, p, p) (an ``expand``ed
    single adjacency costs no memory); times: (B, p)."""
    if adjs.dim() != 3:
        raise ValueError(f"adjs must be (B, p, p); got {tuple(adjs.shape)}")
    return longest_path_closure(adjs.transpose(-1, -2), times)
