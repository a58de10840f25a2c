"""Carry the JAX package's parameters over to the port.

``params_from_jax`` takes the parameter pytree of
``repro.models.model.init_params`` with numpy arrays at its leaves (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict.  The two share names and shapes — blocks stacked with a
leading layer dimension, ``wq`` (d, h, hd), ``wo`` (h, hd, d), ``embed``
(padded_vocab, d) — so the conversion is a checked copy.  The MoE router and
the SSM's ``A_log``, ``D`` and ``dt_bias`` (``model.FP32_KEYS``) stay
float32, as the reference initialises them whatever ``param_dtype`` is.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import FP32_KEYS, Params, param_shapes


def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device: torch.device | str = "cpu") -> Params:
    """The port's parameters from a JAX parameter tree of numpy arrays.

    Raises ``ValueError`` when a name is missing or extra, or a shape
    differs from ``param_shapes(cfg)``.
    """
    pdt = getattr(torch, cfg.param_dtype)

    def walk(shapes: dict, node: Mapping, path: str) -> Params:
        if set(node) != set(shapes):
            raise ValueError(f"{path or 'params'}: keys {sorted(node)} != "
                             f"expected {sorted(shapes)}")
        out = {}
        for key, want in shapes.items():
            where = f"{path}/{key}"
            if isinstance(want, dict):
                out[key] = walk(want, node[key], where)
                continue
            arr = np.asarray(node[key], dtype=np.float32)
            if arr.shape != tuple(want):
                raise ValueError(f"{where}: shape {arr.shape} != expected {want}")
            dtype = torch.float32 if key in FP32_KEYS else pdt
            out[key] = torch.tensor(arr, device=device).to(dtype)
        return out

    return walk(param_shapes(cfg), tree, "")
