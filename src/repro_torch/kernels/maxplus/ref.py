"""The plain versions of the tropical (max, +) product and longest paths.

``maxplus_matmul_ref`` is the function the CUDA kernel computes,
``C = max(NEG_INF, max_k A[.., i, k] + B[.., k, j])`` in float32, written
with torch operations: the max over k runs in chunks with a running
``torch.maximum``, so the (m, k, n) broadcast of the JAX package's oracle is
never materialised whole (at p = 4736 it would take 425 GB).  Each pair
costs one float32 add and the max is exact, so the chunking changes no bit.
The NEG_INF floor is the initial value of the TPU kernel's output tile; it
differs from a bare max only where every sum of a row and column lies below
NEG_INF.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30

#: elements of one (.., m, chunk, n) broadcast: 64 Mi float32 = 256 MiB
CHUNK_ELEMENTS = 1 << 26


def maxplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: (.., m, k); b: (.., k, n) -> (.., m, n) float32 (inputs cast)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lanes = math.prod(a.shape[:-2])
    chunk = max(1, min(k, CHUNK_ELEMENTS // max(1, lanes * m * n)))
    out = torch.full((*a.shape[:-1], n), NEG_INF, dtype=torch.float32,
                     device=a.device)
    for k0 in range(0, k, chunk):
        s = a[..., :, k0:k0 + chunk, None] + b[..., None, k0:k0 + chunk, :]
        torch.maximum(out, s.amax(dim=-2), out=out)
    return out


def longest_path_ref(adj: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Per-task finish times of a dense-adjacency DAG by n relaxation rounds.

    adj[i, j] = 0.0 if edge i->j else NEG_INF; times: (n,).
    Returns finish[j] = times[j] + max over paths into j.
    """
    times = times.to(torch.float32)
    finish = times
    for _ in range(times.shape[0]):   # n rounds are exact on any DAG
        incoming = (finish[:, None] + adj).amax(dim=0)
        finish = torch.maximum(times, times + incoming)
    return finish
