"""Model assembly for the dense family: init, prefill and decode.

The counterpart of the dense path of ``repro.models.model``.  Parameters are
a nested dict of tensors with the JAX package's names and shapes, the layer
blocks stacked with a leading layer dimension; the stack runs as a Python
loop over layer views.  The decode cache keeps the JAX layout too —
``{"layers": {"k", "v"}: (L, B, max_len, Hkv, Dh), "pos": (B,)}`` — and is
updated in place.  Training (``lm_loss``, ``train_loss``) and the other
model families port in later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict

#: parameter groups that stay in ``param_dtype`` when serving: the norms
#: read their scales in fp32 (``layers.norm_apply``)
NORM_KEYS = ("ln1", "ln2", "final_norm")


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} is not ported yet "
            "(the port serves the dense family)")


def _norm_shapes(cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    d = cfg.d_model
    if cfg.norm == "np_layernorm":       # olmo-1b: non-parametric LN
        return {}
    if cfg.norm == "layernorm":
        return {"scale": lead + (d,), "bias": lead + (d,)}
    return {"scale": lead + (d,)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, as ``repro.models.model.init_params``
    lays them out for a dense config."""
    _require_dense(cfg)
    d, h, hk, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    n = (cfg.num_layers,)
    attn = {"wq": n + (d, h, hd), "wk": n + (d, hk, hd), "wv": n + (d, hk, hd),
            "wo": n + (h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=n + (h, hd), bk=n + (hk, hd), bv=n + (hk, hd))
    mlp = {"w_up": n + (d, cfg.d_ff), "w_down": n + (cfg.d_ff, d),
           "w_gate": n + (d, cfg.d_ff)}
    shapes = {"embed": (cfg.padded_vocab, d),
              "final_norm": _norm_shapes(cfg, ()),
              "blocks": {"ln1": _norm_shapes(cfg, n), "attn": attn,
                         "ln2": _norm_shapes(cfg, n), "mlp": mlp}}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.padded_vocab)
    return shapes


def _fan_in(cfg: ModelConfig, name: str) -> int | None:
    """Fan-in of a dense weight (``dense_init``'s scale), None for others."""
    d = cfg.d_model
    return {"wq": d, "wk": d, "wv": d, "w_up": d, "w_gate": d, "lm_head": d,
            "wo": cfg.num_heads * cfg.resolved_head_dim,
            "w_down": cfg.d_ff}.get(name)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters on the generator's device: the embedding
    N(0, 0.02²), dense weights N(0, 1/fan_in), norm scales 1, biases 0.
    The draws differ from ``jax.random``'s; tests carry JAX parameters over
    with ``convert.params_from_jax`` instead."""
    dev, pdt = generator.device, getattr(torch, cfg.param_dtype)

    def make(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        if name == "scale":
            return torch.ones(shape, dtype=pdt, device=dev)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=pdt, device=dev)
        std = 0.02 if name == "embed" else _fan_in(cfg, name) ** -0.5
        w = torch.randn(shape, generator=generator, device=dev)
        return (w * std).to(pdt)

    def walk(tree: dict) -> Params:
        return {k: walk(v) if isinstance(v, dict) else make(k, v)
                for k, v in tree.items()}

    return walk(param_shapes(cfg))


def serving_params(cfg: ModelConfig, params: Params) -> Params:
    """The parameters with every matrix, bias and the embedding cast once to
    ``cfg.dtype``; the norm scales stay as they are.

    The JAX package casts each weight to the compute dtype at every use, so
    casting once up front gives identical results and spares every decode
    step a read and conversion of the fp32 weights."""
    cdt = L.compute_dtype(cfg)

    def cast(tree: dict) -> Params:
        return {k: (v if k in NORM_KEYS else
                    cast(v) if isinstance(v, dict) else v.to(cdt))
                for k, v in tree.items()}

    return cast(params)


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked blocks."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of the final hidden states, padded vocab rows at -1e30."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    logits = (x @ head.to(x.dtype)).float()
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.where(torch.arange(cfg.padded_vocab, device=x.device)
                            < cfg.vocab_size, 0.0, -1e30)
        logits = logits + vmask
    return logits


# ------------------------------------------------------------------ serving
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> Params:
    """Decode cache, stacked over layers."""
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cdt = L.compute_dtype(cfg)
    return {"layers": {"k": torch.zeros(shape, dtype=cdt, device=device),
                       "v": torch.zeros(shape, dtype=cdt, device=device)},
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Params) -> tuple[torch.Tensor, Params]:
    """Process the full prompt, fill the cache, return last-position logits.

    tokens: (B, S) integer ids -> ((B, padded_vocab) fp32 logits, cache).
    """
    _require_dense(cfg)
    cdt = L.compute_dtype(cfg)
    x = params["embed"][tokens.long()].to(cdt)
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        y, (k, v) = L.attn_apply(cfg, lp["attn"],
                                 L.norm_apply(cfg, lp["ln1"], x), positions,
                                 causal=True, return_kv=True)
        x = x + y
        ck[i, :, :s] = k
        cv[i, :, :s] = v
        x = x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["ln2"], x))
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = torch.full((b,), s, dtype=torch.long, device=x.device)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One token for every sequence. tokens: (B, 1) -> (logits, cache)."""
    _require_dense(cfg)
    cdt = L.compute_dtype(cfg)
    x = params["embed"][tokens.long()].to(cdt)
    pos = cache["pos"]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        h, _ = L.attn_decode(cfg, lp["attn"], L.norm_apply(cfg, lp["ln1"], x),
                             ck[i], cv[i], pos)
        x = x + h
        x = x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["ln2"], x))
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache
