"""Model assembly for the dense and MoE families: init, the training loss,
prefill and decode.

The counterpart of the dense and MoE paths of ``repro.models.model``.
Parameters are a nested dict of tensors with the JAX package's names and
shapes, the layer blocks stacked with a leading layer dimension; the stack
runs as a Python loop over layer views, each layer under the config's remat
policy (``cfg.remat``) when it trains.  The decode cache keeps the JAX
layout too — ``{"layers": {"k", "v"}: (L, B, max_len, Hkv, Dh), "pos":
(B,)}`` — and is updated in place.  Both families serve and train; the
MoE layer trains through the dispatch and combine kernels' backward
(``kernels/moe``).  The other model families port in later slices.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict

#: parameters that stay in ``param_dtype`` when serving: the norms read
#: their scales in fp32 (``layers.norm_apply``) and the MoE router routes
#: in fp32 (``layers.moe_apply``)
KEEP_KEYS = ("ln1", "ln2", "final_norm", "router")

#: the model families each entry point takes
SERVED = ("dense", "moe")
TRAINED = ("dense", "moe")


def _require(cfg: ModelConfig, families: tuple[str, ...], what: str) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{cfg.name}: model family {cfg.family!r} is not ported for "
            f"{what} yet; the port {what}s {', '.join(families)}")


def _norm_shapes(cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    d = cfg.d_model
    if cfg.norm == "np_layernorm":       # olmo-1b: non-parametric LN
        return {}
    if cfg.norm == "layernorm":
        return {"scale": lead + (d,), "bias": lead + (d,)}
    return {"scale": lead + (d,)}


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, as ``repro.models.model.init_params``
    lays them out for a dense or MoE config (every layer an MoE layer)."""
    _require(cfg, SERVED, "serve")
    d, h, hk, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    n = (cfg.num_layers,)
    attn = {"wq": n + (d, h, hd), "wk": n + (d, hk, hd), "wv": n + (d, hk, hd),
            "wo": n + (h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=n + (h, hd), bk=n + (hk, hd), bv=n + (hk, hd))
    blocks = {"ln1": _norm_shapes(cfg, n), "attn": attn,
              "ln2": _norm_shapes(cfg, n)}
    if cfg.family == "moe":
        if cfg.moe_every != 1:
            raise NotImplementedError(f"{cfg.name}: MoE every {cfg.moe_every}"
                                      " layers is the hybrid family's layout")
        e, f = cfg.moe_num_experts, cfg.moe_ff
        moe = {"router": n + (d, e), "w_gate": n + (e, d, f),
               "w_up": n + (e, d, f), "w_down": n + (e, f, d)}
        if cfg.moe_num_shared:
            moe["shared"] = _mlp_shapes(n, d, f * cfg.moe_num_shared)
        blocks["moe"] = moe
    else:
        blocks["mlp"] = _mlp_shapes(n, d, cfg.d_ff)
    shapes = {"embed": (cfg.padded_vocab, d),
              "final_norm": _norm_shapes(cfg, ()), "blocks": blocks}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.padded_vocab)
    return shapes


def _mlp_shapes(lead: tuple[int, ...], d: int, f: int) -> dict:
    return {"w_up": lead + (d, f), "w_down": lead + (f, d),
            "w_gate": lead + (d, f)}


def _fan_in(cfg: ModelConfig, path: tuple[str, ...]) -> int:
    """Fan-in of the weight at ``path`` (``dense_init``'s scale): its input
    width, which for ``w_down`` is the hidden width of its own MLP."""
    d, name = cfg.d_model, path[-1]
    if name == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    if name != "w_down":
        return d
    if "shared" in path:
        return cfg.moe_ff * cfg.moe_num_shared
    return cfg.moe_ff if "moe" in path else cfg.d_ff


def _walk_init(cfg: ModelConfig, generator: torch.Generator, leaf) -> Params:
    """The parameter tree, each leaf drawn in ``param_shapes``' order and
    handed to ``leaf(path, tensor)``: the embedding N(0, 0.02²), dense
    weights N(0, 1/fan_in), norm scales 1, biases 0; the MoE router in
    float32 whatever ``param_dtype`` is, as the reference's."""
    dev, pdt = generator.device, getattr(torch, cfg.param_dtype)

    def make(path: tuple[str, ...], shape: tuple[int, ...]) -> torch.Tensor:
        name = path[-1]
        if name == "scale":
            return torch.ones(shape, dtype=pdt, device=dev)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=pdt, device=dev)
        std = 0.02 if name == "embed" else _fan_in(cfg, path) ** -0.5
        w = torch.randn(shape, generator=generator, device=dev)
        return w.mul_(std).to(torch.float32 if name == "router" else pdt)

    def walk(tree: dict, path: tuple[str, ...]) -> Params:
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else leaf(path + (k,), make(path + (k,), v))
                for k, v in tree.items()}

    return walk(param_shapes(cfg), ())


def init_params(cfg: ModelConfig, generator: torch.Generator) -> Params:
    """Random parameters in ``param_dtype`` on the generator's device
    (:func:`_walk_init`).  The draws differ from ``jax.random``'s; tests
    carry JAX parameters over with ``convert.params_from_jax`` instead."""
    return _walk_init(cfg, generator, lambda path, w: w)


def _serving_leaf(cfg: ModelConfig, path: tuple[str, ...],
                  w: torch.Tensor) -> torch.Tensor:
    if any(k in KEEP_KEYS for k in path):
        return w
    return w.to(L.compute_dtype(cfg))


def serving_params(cfg: ModelConfig, params: Params) -> Params:
    """The parameters with every matrix, bias and the embedding cast once to
    ``cfg.dtype``; the norm scales and the MoE router (:data:`KEEP_KEYS`)
    stay as they are.

    The JAX package casts each weight to the compute dtype at every use, so
    casting once up front gives identical results and spares every decode
    step a read and conversion of the fp32 weights."""

    def cast(tree: dict, path: tuple[str, ...]) -> Params:
        return {k: cast(v, path + (k,)) if isinstance(v, dict)
                else _serving_leaf(cfg, path + (k,), v)
                for k, v in tree.items()}

    return cast(params, ())


def init_serving_params(cfg: ModelConfig, generator: torch.Generator
                        ) -> Params:
    """``serving_params(cfg, init_params(cfg, generator))``, bit for bit,
    drawn and cast leaf by leaf: the fp32 tree is never whole.  Its peak
    is the served tree and one fp32 leaf with its cast (qwen2-moe-a2.7b:
    28.6 GB served, one stacked expert matrix 16.6 GB in fp32, where the
    whole fp32 tree beside its bf16 copy would take 86 GB)."""
    return _walk_init(cfg, generator,
                      functools.partial(_serving_leaf, cfg))


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


# ----------------------------------------------------------------- training
def _apply_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual attention, then the residual MLP or MoE, each behind its
    pre-norm, as the reference's ``_apply_sublayer``; returns (x, the
    layer's aux loss: the MoE's, 0 for an MLP)."""
    x = x + L.attn_apply(cfg, lp["attn"], L.norm_apply(cfg, lp["ln1"], x),
                         positions, causal=True)
    h = L.norm_apply(cfg, lp["ln2"], x)
    if "moe" not in lp:
        return (x + L.mlp_apply(cfg, lp["mlp"], h),
                torch.zeros((), device=x.device))
    out, routed = L.moe_apply(cfg, lp["moe"], h)
    return x + out, L.moe_aux_loss(cfg, routed)


#: the products whose outputs the ``dots`` policy keeps: matrix products
#: with no batch dimension, as ``checkpoint_dots_with_no_batch_dims`` keeps
#: the reference's (attention's batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body):
    """``body`` under the config's remat policy, as ``repro.models.model.
    _remat``: ``none`` keeps every activation, ``full`` keeps the layer's
    input and recomputes the rest in the backward pass, ``dots`` also keeps
    the outputs of the matrix products with no batch dimension.  A MoE
    layer's recompute reruns its route, dispatch and combine, which give
    the same results again."""
    if cfg.remat == "none":
        return body
    if cfg.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _dots_policy)
        return functools.partial(ckpt.checkpoint, body, use_reentrant=False,
                                 context_fn=context)
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r}: expected none, dots or full")


def lm_loss(cfg: ModelConfig, params: Params, h: torch.Tensor,
            targets: torch.Tensor, loss_mask: torch.Tensor,
            s_chunk: int = 512) -> torch.Tensor:
    """Sequence-chunked cross entropy (never materializes (B, S, V) at
    once): fp32 logits of each chunk of ``best_chunk(s, s_chunk)``
    positions, the padded vocabulary rows at -1e30, the mean negative log
    likelihood over the positions ``loss_mask`` keeps."""
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    s = h.shape[1]
    cs = L.best_chunk(s, s_chunk)
    vmask = None
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.where(torch.arange(cfg.padded_vocab, device=h.device)
                            < cfg.vocab_size, 0.0, -1e30)
    tot = cnt = torch.zeros((), device=h.device)
    for c0 in range(0, s, cs):
        logits = (h[:, c0:c0 + cs] @ head.to(h.dtype)).float()
        if vmask is not None:
            logits = logits + vmask
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, targets[:, c0:c0 + cs, None].long())[..., 0]
        mask = loss_mask[:, c0:c0 + cs].float()
        tot = tot + ((lse - gold) * mask).sum()
        cnt = cnt + mask.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def train_loss(cfg: ModelConfig, params: Params, batch: dict
               ) -> tuple[torch.Tensor, dict]:
    """batch: ``tokens``, ``targets`` (B, S) integer ids and ``loss_mask``
    (B, S).  Returns (``lm_loss + router_aux_weight · aux_loss``, metrics)
    with metrics ``lm_loss`` and ``aux_loss``: the MoE layers' aux losses
    summed in layer order (0 only in the dense family, which has no
    router)."""
    _require(cfg, TRAINED, "train")
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(L.compute_dtype(cfg))
    b, s = tokens.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    layer = _remat(cfg, functools.partial(_apply_layer, cfg))
    aux = torch.zeros((), device=x.device)
    for i in range(cfg.num_layers):
        x, a = layer(_layer(params["blocks"], i), x, positions)
        aux = aux + a
    x = L.norm_apply(cfg, params["final_norm"], x)
    loss = lm_loss(cfg, params, x, batch["targets"], batch["loss_mask"])
    return loss + cfg.router_aux_weight * aux, {"lm_loss": loss,
                                                "aux_loss": aux}


# ------------------------------------------------------------------ serving
def _ffn(cfg: ModelConfig, lp: Params, x: torch.Tensor,
         dropped: list | None = None) -> torch.Tensor:
    """The layer's feed-forward behind its pre-norm: the MLP, or the MoE
    without its aux loss, which the reference's serving paths drop; the
    MoE appends its dropped-entry count (on the device) to ``dropped``."""
    h = L.norm_apply(cfg, lp["ln2"], x)
    if "moe" not in lp:
        return L.mlp_apply(cfg, lp["mlp"], h)
    out, (_, r) = L.moe_apply(cfg, lp["moe"], h)
    if dropped is not None:
        dropped.append(r.stats[-1])
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device | str) -> Params:
    """Decode cache, stacked over layers."""
    _require(cfg, SERVED, "serve")
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    cdt = L.compute_dtype(cfg)
    return {"layers": {"k": torch.zeros(shape, dtype=cdt, device=device),
                       "v": torch.zeros(shape, dtype=cdt, device=device)},
            "pos": torch.zeros((batch,), dtype=torch.long, device=device)}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Params, dropped: list | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt, fill the cache, return last-position logits.

    tokens: (B, S) integer ids -> ((B, padded_vocab) fp32 logits, cache).
    Each MoE layer appends its count of dropped entries, a device tensor, to
    ``dropped`` where given.
    """
    _require(cfg, SERVED, "serve")
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
        x = x + _ffn(cfg, lp, x, dropped)
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = torch.full((b,), s, dtype=torch.long, device=x.device)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One token for every sequence. tokens: (B, 1) -> (logits, cache)."""
    _require(cfg, SERVED, "serve")
    cdt = L.compute_dtype(cfg)
    x = params["embed"][tokens.long()].to(cdt)
    pos = cache["pos"]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        lp = _layer(params["blocks"], i)
        h, _ = L.attn_decode(cfg, lp["attn"], L.norm_apply(cfg, lp["ln1"], x),
                             ck[i], cv[i], pos)
        x = x + h
        x = x + _ffn(cfg, lp, x)
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache
