"""Model assembly for every family: init, the training loss, prefill and
decode.

The counterpart of ``repro.models.model``.  Families: dense and vlm (a
decoder-only GQA transformer; vlm prepends precomputed vision patch
embeddings), moe, ssm, hybrid (periods of SSD layers with one attention
layer), and encdec (a Whisper-style encoder over precomputed audio frame
embeddings and a decoder with cross-attention, sinusoidal positions and
gelu MLPs).  Parameters are a nested dict of tensors with the JAX
package's names and shapes, the layer blocks stacked with a leading layer
dimension (the hybrid's blocks ``sub0`` ... ``sub{attn_every-1}``, one a
layer of a period, each stacked over the periods; the encoder's
``enc_blocks`` over ``encoder_layers``); the stack runs as a Python loop
over layer views, each layer under the config's remat policy
(``cfg.remat``) when it trains.  The decode cache keeps the JAX layout too
— ``{"layers": {"k", "v"}: (L, B, max_len, Hkv, Dh), "pos": (B,)}``, an
SSM layer's ``{"state": (L, B, nh, hd, ns), "conv": (L, B, cw-1,
d_inner + 2·ns)}``, the hybrid's per sub-layer over the periods, the
encoder-decoder's ``cross_kv`` ``{"k", "v"}: (L, B, encoder_seq, Hkv,
Dh)`` — and is updated in place.  Every family serves and trains; the MoE
layer trains through the dispatch and combine kernels' backward
(``kernels/moe``), the SSM layer through the SSD scan's (``kernels/ssd``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict

#: parameters that stay as they are when serving: the norms read their
#: scales in fp32 (``layers.norm_apply``, the SSM's gated ``norm``), the MoE
#: router routes in fp32 (``layers.moe_apply``), and the SSM takes
#: ``exp(A_log)``, adds ``dt_bias`` in fp32 and casts ``D`` at its use
KEEP_KEYS = ("ln1", "ln2", "lnx", "final_norm", "enc_norm", "router", "norm",
             "A_log", "D", "dt_bias")
#: parameters the reference initialises in float32 whatever
#: ``param_dtype`` is
FP32_KEYS = ("router", "A_log", "D", "dt_bias")

#: the model families: all of the JAX package's, each served and trained
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

#: the batch key of each stub frontend's precomputed embeddings
FRONTEND_KEYS = {"audio_stub": "audio_embeds", "vision_stub": "vision_embeds"}


def frontend_positions(cfg: ModelConfig) -> int:
    """The positions of the stub frontend's precomputed embeddings: the
    vlm's ``vision_tokens`` patches, the encoder-decoder's ``encoder_seq``
    audio frames, else 0."""
    if cfg.frontend == "vision_stub":
        return cfg.vision_tokens
    return cfg.encoder_seq if cfg.frontend == "audio_stub" else 0


def prefix_len(cfg: ModelConfig) -> int:
    """The positions the stub frontend prepends to the decoder's tokens
    (and the cache must hold beside them): all of its embeddings, except
    in the encoder-decoder, whose encoder reads them instead."""
    return 0 if cfg.family == "encdec" else frontend_positions(cfg)


def _norm_shapes(cfg: ModelConfig, lead: tuple[int, ...]) -> dict:
    d = cfg.d_model
    if cfg.norm == "np_layernorm":       # olmo-1b: non-parametric LN
        return {}
    if cfg.norm == "layernorm":
        return {"scale": lead + (d,), "bias": lead + (d,)}
    return {"scale": lead + (d,)}


def _attn_shapes(cfg: ModelConfig, n: tuple[int, ...]) -> dict:
    d, h, hk, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    attn = {"wq": n + (d, h, hd), "wk": n + (d, hk, hd), "wv": n + (d, hk, hd),
            "wo": n + (h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=n + (h, hd), bk=n + (hk, hd), bv=n + (hk, hd))
    return attn


def _ssm_shapes(cfg: ModelConfig, n: tuple[int, ...]) -> dict:
    d, di, ns, nh = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                     cfg.ssm_num_heads)
    cw = cfg.ssm_conv_width
    return {"w_z": n + (d, di), "w_x": n + (d, di), "w_B": n + (d, ns),
            "w_C": n + (d, ns), "w_dt": n + (d, nh), "conv_x": n + (cw, di),
            "conv_B": n + (cw, ns), "conv_C": n + (cw, ns), "A_log": n + (nh,),
            "D": n + (nh,), "dt_bias": n + (nh,),
            "norm": {"scale": n + (di,)}, "w_out": n + (di, d)}


def _moe_shapes(cfg: ModelConfig, n: tuple[int, ...]) -> dict:
    d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_ff
    moe = {"router": n + (d, e), "w_gate": n + (e, d, f),
           "w_up": n + (e, d, f), "w_down": n + (e, f, d)}
    if cfg.moe_num_shared:
        moe["shared"] = _mlp_shapes(n, d, f * cfg.moe_num_shared)
    return moe


def _layer_shapes(cfg: ModelConfig, i: int, n: tuple[int, ...]) -> dict:
    """Layer ``i``'s tree (the reference's ``_layer_init`` over its
    ``_layer_kinds``): attention or SSM behind ``ln1``, then the MLP or MoE
    behind ``ln2``; the SSM family has no feed-forward."""
    block = {"ln1": _norm_shapes(cfg, n)}
    if cfg.is_attn_layer(i):
        block["attn"] = _attn_shapes(cfg, n)
    else:
        block["ssm"] = _ssm_shapes(cfg, n)
    if cfg.family == "ssm":
        return block
    if cfg.is_moe_layer(i):
        block["ln2"] = _norm_shapes(cfg, n)
        block["moe"] = _moe_shapes(cfg, n)
    elif cfg.d_ff:
        block["ln2"] = _norm_shapes(cfg, n)
        block["mlp"] = _mlp_shapes(n, cfg.d_model, cfg.d_ff)
    return block


def _encdec_shapes(cfg: ModelConfig, n: tuple[int, ...], *,
                   decoder: bool) -> dict:
    """An encoder layer (the reference's ``_enc_layer_init``): self-
    attention behind ``ln1``, the gelu MLP behind ``ln2``; a decoder layer
    (``_dec_layer_init_encdec``) adds the cross-attention ``xattn`` behind
    ``lnx``."""
    block = {"ln1": _norm_shapes(cfg, n), "attn": _attn_shapes(cfg, n)}
    if decoder:
        block.update(lnx=_norm_shapes(cfg, n), xattn=_attn_shapes(cfg, n))
    block.update(ln2=_norm_shapes(cfg, n),
                 mlp=_mlp_shapes(n, cfg.d_model, cfg.d_ff, gelu=True))
    return block


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's shapes, as ``repro.models.model.init_params``
    lays them out: every layer alike, stacked over the layers (a MoE
    config's every layer an MoE layer; the vlm's the dense tree, its vision
    stub holding no parameter), or the hybrid's period of ``attn_every``
    sub-layers ``sub{i}``, each stacked over the periods; the
    encoder-decoder's decoder ``blocks``, ``enc_blocks`` stacked over
    ``encoder_layers`` and ``enc_norm``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")
    if cfg.family == "encdec":
        blocks = _encdec_shapes(cfg, (cfg.num_layers,), decoder=True)
    elif cfg.family == "hybrid":
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole periods of {cfg.attn_every}")
        n = (cfg.num_layers // cfg.attn_every,)
        blocks = {f"sub{i}": _layer_shapes(cfg, i, n)
                  for i in range(cfg.attn_every)}
    else:
        if cfg.family == "moe" and cfg.moe_every != 1:
            raise NotImplementedError(f"{cfg.name}: MoE every {cfg.moe_every}"
                                      " layers is the hybrid family's layout")
        blocks = _layer_shapes(cfg, 0, (cfg.num_layers,))
    shapes = {"embed": (cfg.padded_vocab, cfg.d_model),
              "final_norm": _norm_shapes(cfg, ()), "blocks": blocks}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.padded_vocab)
    if cfg.family == "encdec":
        shapes["enc_blocks"] = _encdec_shapes(cfg, (cfg.encoder_layers,),
                                              decoder=False)
        shapes["enc_norm"] = _norm_shapes(cfg, ())
    return shapes


def _mlp_shapes(lead: tuple[int, ...], d: int, f: int,
                gelu: bool = False) -> dict:
    """SwiGLU's three matrices, or the gelu MLP's two (no ``w_gate``)."""
    mlp = {"w_up": lead + (d, f), "w_down": lead + (f, d)}
    if not gelu:
        mlp["w_gate"] = lead + (d, f)
    return mlp


def _fan_in(cfg: ModelConfig, path: tuple[str, ...]) -> int:
    """Fan-in of the weight at ``path`` (``dense_init``'s scale): its input
    width, which for ``w_down`` is the hidden width of its own MLP, for
    the SSM's conv filters the conv width and for its ``w_out`` d_inner."""
    d, name = cfg.d_model, path[-1]
    if name == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    if name.startswith("conv_"):
        return cfg.ssm_conv_width
    if name == "w_out":
        return cfg.ssm_d_inner
    if name != "w_down":
        return d
    if "shared" in path:
        return cfg.moe_ff * cfg.moe_num_shared
    return cfg.moe_ff if "moe" in path else cfg.d_ff


def _walk_init(cfg: ModelConfig, generator: torch.Generator, leaf) -> Params:
    """The parameter tree, each leaf drawn in ``param_shapes``' order and
    handed to ``leaf(path, tensor)``: the embedding N(0, 0.02²), dense
    weights N(0, 1/fan_in), norm scales 1, biases 0, the SSM's ``A_log``
    and ``dt_bias`` 0 and ``D`` 1; the MoE router and those three
    (:data:`FP32_KEYS`) in float32 whatever ``param_dtype`` is, as the
    reference's."""
    dev, pdt = generator.device, getattr(torch, cfg.param_dtype)
    f32 = torch.float32

    def make(path: tuple[str, ...], shape: tuple[int, ...]) -> torch.Tensor:
        name = path[-1]
        if name == "scale":
            return torch.ones(shape, dtype=pdt, device=dev)
        if name in ("bias", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=pdt, device=dev)
        if name in ("A_log", "dt_bias", "D"):
            fill = torch.ones if name == "D" else torch.zeros
            return fill(shape, dtype=f32, device=dev)
        std = 0.02 if name == "embed" else _fan_in(cfg, path) ** -0.5
        w = torch.randn(shape, generator=generator, device=dev)
        return w.mul_(std).to(f32 if name in FP32_KEYS else pdt)

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


# --------------------------------------------------------------- frontends
@functools.lru_cache(maxsize=8)
def _sinusoidal_table(s: int, d: int) -> np.ndarray:
    pos = np.arange(s)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def _sinusoidal(s: int, d: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The sinusoidal positions (1, s, d) of the encoder and the decoder's
    prefill, as the reference's ``_sinusoidal``: a float64 numpy table,
    cast once to ``dtype``."""
    table = torch.from_numpy(_sinusoidal_table(s, d))
    return table.to(device=device, dtype=dtype)[None]


def _sinusoidal_at(pos: torch.Tensor, d: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """The decode step's sinusoidal term (B, 1, d) at ``pos`` (B,), as the
    reference's ``_sinusoidal_at``: float32 exponents, ``power``, angles,
    ``sin`` and ``cos``, a computation of its own, not the prefill's
    float64 table.  The power is taken in float64 and rounded once: XLA:CPU's
    float32 ``power`` gives that at every exponent of d <= 2048 (an ulp
    apart at 1 and 3 of d = 4096's and 8192's); torch's float32 ``pow`` is
    an ulp off at some of d = 1024's, which position 448 turns into 3e-5."""
    dim = torch.arange(d // 2, device=pos.device)[None, :]
    expo = (2 * dim).float() / d
    ang = pos[:, None].float() / torch.pow(10000.0, expo.double()).float()
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None].to(
        dtype)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           embeds: torch.Tensor | None = None) -> torch.Tensor:
    """The decoder's input, as the reference's ``_embed_inputs``: the token
    embeddings in the compute dtype; after the stub frontend's precomputed
    ``embeds`` (B, T, D) where the family prepends them (the vlm's vision
    patches); the encoder-decoder's plus the sinusoidal positions (its
    audio frames go to the encoder instead)."""
    cdt = L.compute_dtype(cfg)
    tok = params["embed"][tokens.long()].to(cdt)
    if prefix_len(cfg):
        if embeds is None:
            raise ValueError(f"{cfg.name}: the {cfg.frontend} frontend "
                             "needs its precomputed embeddings")
        return torch.cat([embeds.to(cdt), tok], dim=1)
    if cfg.family == "encdec":
        return tok + _sinusoidal(tok.shape[1], cfg.d_model, cdt, tok.device)
    return tok


def _encoder_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attn_apply(cfg, lp["attn"], L.norm_apply(cfg, lp["ln1"], x),
                         positions, causal=False)
    return x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["ln2"], x))


def _run_encoder(cfg: ModelConfig, params: Params,
                 embeds: torch.Tensor | None, dtype: torch.dtype,
                 remat: bool) -> torch.Tensor:
    """The encoder, as the reference's ``_run_encoder``: the audio frames
    (B, T, D), cast to ``dtype``, plus the sinusoidal positions, each
    layer's non-causal self-attention (the chunked path: the flash gate is
    causal only) and gelu MLP behind their pre-norms, under the remat
    policy where ``remat``, then ``enc_norm``."""
    if embeds is None:
        raise ValueError(f"{cfg.name}: the encoder needs the audio frames' "
                         "embeddings")
    embeds = embeds.to(dtype)
    b, t = embeds.shape[:2]
    positions = torch.arange(t, device=embeds.device).expand(b, t)
    x = embeds + _sinusoidal(t, cfg.d_model, embeds.dtype, embeds.device)
    layer = functools.partial(_encoder_layer, cfg)
    if remat:
        layer = _remat(cfg, layer)
    for i in range(cfg.encoder_layers):
        x = layer(_layer(params["enc_blocks"], i), x, positions)
    return L.norm_apply(cfg, params["enc_norm"], x)


def _cross(cfg: ModelConfig, lp: Params, x: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder's residual cross-attention behind ``lnx``."""
    return x + L.cross_attn_apply(cfg, lp["xattn"],
                                  L.norm_apply(cfg, lp["lnx"], x), k, v)


# ----------------------------------------------------------------- training
def _apply_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 positions: torch.Tensor,
                 enc_out: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual attention or SSM, the encoder-decoder's residual
    cross-attention (its k / v computed here from ``enc_out``, inside the
    layer's remat region, as the reference's ``_run_stack_encaware``), then
    the residual MLP or MoE (none in the SSM family), each behind its
    pre-norm, as the reference's ``_apply_sublayer``; returns (x, the
    layer's aux loss: the MoE's, else 0)."""
    h = L.norm_apply(cfg, lp["ln1"], x)
    if "attn" in lp:
        x = x + L.attn_apply(cfg, lp["attn"], h, positions, causal=True)
    else:
        x = x + L.ssm_apply(cfg, lp["ssm"], h)
    if "xattn" in lp:
        x = _cross(cfg, lp, x, *L.cross_kv(cfg, lp["xattn"], enc_out))
    if "moe" in lp:
        out, routed = L.moe_apply(cfg, lp["moe"], L.norm_apply(cfg, lp["ln2"],
                                                               x))
        return x + out, L.moe_aux_loss(cfg, routed)
    if "mlp" in lp:
        x = x + L.mlp_apply(cfg, lp["mlp"], L.norm_apply(cfg, lp["ln2"], x))
    return x, torch.zeros((), device=x.device)


def _apply_period(cfg: ModelConfig, pp: Params, x: torch.Tensor,
                  aux: torch.Tensor, positions: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The hybrid's period: its ``attn_every`` sub-layers in order, each
    one's aux loss added to the running ``aux`` in turn, as the body of the
    reference's ``_run_stack`` carries it."""
    for i in range(cfg.attn_every):
        x, a = _apply_layer(cfg, pp[f"sub{i}"], x, positions)
        aux = aux + a
    return x, aux


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
    layer's recompute reruns its route, dispatch and combine, an SSM
    layer's its scan (whose per-chunk states the backward then takes from
    the recompute), which give the same results again."""
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
    head = head.to(h.dtype)     # one copy, which every chunk's product keeps
    s = h.shape[1]
    cs = L.best_chunk(s, s_chunk)
    vmask = None
    if cfg.padded_vocab != cfg.vocab_size:
        vmask = torch.where(torch.arange(cfg.padded_vocab, device=h.device)
                            < cfg.vocab_size, 0.0, -1e30)
    tot = cnt = torch.zeros((), device=h.device)
    for c0 in range(0, s, cs):
        logits = (h[:, c0:c0 + cs] @ head).float()
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
    (B, S); a stub frontend's precomputed embeddings (B, T, D) under
    ``vision_embeds`` or ``audio_embeds`` (:data:`FRONTEND_KEYS`).  Returns
    (``lm_loss + router_aux_weight · aux_loss``, metrics) with metrics
    ``lm_loss`` and ``aux_loss``: the MoE layers' aux losses summed in
    layer order (0 in a family with no router).  The hybrid runs period by
    period, each period's sub-layers under one remat, its aux losses summed
    sub-layer by sub-layer, as the reference's scan body.  The vlm's vision
    positions carry no loss; the encoder-decoder's encoder runs first, each
    of its layers under the remat policy."""
    front = batch.get(FRONTEND_KEYS.get(cfg.frontend, ""))
    x = _embed(cfg, params, batch["tokens"], front)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, params, front, x.dtype, remat=True)
    aux = torch.zeros((), device=x.device)
    if cfg.family == "hybrid":
        period = _remat(cfg, functools.partial(_apply_period, cfg))
        for per in range(cfg.num_layers // cfg.attn_every):
            pp = {sub: _layer(blk, per)
                  for sub, blk in params["blocks"].items()}
            x, aux = period(pp, x, aux, positions)
    else:
        layer = _remat(cfg, functools.partial(_apply_layer, cfg))
        for i in range(cfg.num_layers):
            x, a = layer(_layer(params["blocks"], i), x, positions, enc_out)
            aux = aux + a
    x = L.norm_apply(cfg, params["final_norm"], x)
    x = x[:, s - batch["targets"].shape[1]:]      # the frontend's: no loss
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
    """Decode cache in the compute dtype, stacked over layers (the
    hybrid's per sub-layer, over the periods): an attention layer's ``k``
    and ``v`` (B, max_len, Hkv, Dh), an SSM layer's ``state`` (B, nh, hd,
    ns) and ``conv`` (B, cw-1, d_inner + 2·ns); ``pos`` (B,); the
    encoder-decoder's ``cross_kv``, ``k`` and ``v`` (L, B, encoder_seq,
    Hkv, Dh).  A vlm prompt takes ``vision_tokens`` positions more."""
    cdt = L.compute_dtype(cfg)

    def layer(i: int, n: int) -> Params:
        if cfg.is_attn_layer(i):
            shape = (n, batch, max_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=cdt, device=device),
                    "v": torch.zeros(shape, dtype=cdt, device=device)}
        return {"state": torch.zeros((n, batch, cfg.ssm_num_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=cdt, device=device),
                "conv": torch.zeros((n, batch, cfg.ssm_conv_width - 1,
                                     cfg.ssm_d_inner + 2 * cfg.ssm_state),
                                    dtype=cdt, device=device)}

    if cfg.family == "hybrid":
        n = cfg.num_layers // cfg.attn_every
        layers = {f"sub{i}": layer(i, n) for i in range(cfg.attn_every)}
    else:
        layers = layer(0, cfg.num_layers)
    cache = {"layers": layers,
             "pos": torch.zeros((batch,), dtype=torch.long, device=device)}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross_kv"] = {
            "k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}
    return cache


def _stack(cfg: ModelConfig, params: Params, cache: Params):
    """Each layer's parameters, cache and cross-attention k / v (None but
    in the encoder-decoder) in order, views into the stacked trees: the
    hybrid's sub-layers of each period in turn."""
    if cfg.family != "hybrid":
        cross = cache.get("cross_kv")
        for i in range(cfg.num_layers):
            yield (_layer(params["blocks"], i), _layer(cache["layers"], i),
                   None if cross is None else _layer(cross, i))
        return
    for per in range(cfg.num_layers // cfg.attn_every):
        for i in range(cfg.attn_every):
            sub = f"sub{i}"
            yield (_layer(params["blocks"][sub], per),
                   _layer(cache["layers"][sub], per), None)


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            cache: Params, dropped: list | None = None, *,
            embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, Params]:
    """Process the full prompt, fill the cache, return last-position logits.

    tokens: (B, S) integer ids -> ((B, padded_vocab) fp32 logits, cache).
    ``embeds``, the stub frontend's precomputed embeddings (B, T, D): the
    vlm's vision patches, prepended (the prompt is then T + S positions,
    RoPE over all of them, and ``pos`` T + S after it), or the
    encoder-decoder's audio frames, which the encoder reads.  Attention
    layers write their K/V into the cache, SSM layers their final state and
    conv tail, the encoder-decoder's layers their cross k / v, computed
    once each for the layer and the cache.  Each MoE layer appends its
    count of dropped entries, a device tensor, to ``dropped`` where given.
    """
    x = _embed(cfg, params, tokens, embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.family == "encdec":
        enc_out = _run_encoder(cfg, params, embeds, x.dtype, remat=False)
    for lp, lc, xc in _stack(cfg, params, cache):
        h = L.norm_apply(cfg, lp["ln1"], x)
        if "attn" in lp:
            y, (k, v) = L.attn_apply(cfg, lp["attn"], h, positions,
                                     causal=True, return_kv=True)
            lc["k"][:, :s] = k
            lc["v"][:, :s] = v
        else:
            y, (state, conv) = L.ssm_apply(cfg, lp["ssm"], h,
                                           return_state=True)
            lc["state"].copy_(state)
            lc["conv"].copy_(conv)
        x = x + y
        if xc is not None:
            k, v = L.cross_kv(cfg, lp["xattn"], enc_out)
            xc["k"].copy_(k)
            xc["v"].copy_(v)
            x = _cross(cfg, lp, x, k, v)
        if "ln2" in lp:
            x = x + _ffn(cfg, lp, x, dropped)
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = torch.full((b,), s, dtype=torch.long, device=x.device)
    return _logits(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """One token for every sequence. tokens: (B, 1) -> (logits, cache).
    Every layer's cache is written in place; nothing goes to the host.  The
    encoder-decoder adds :func:`_sinusoidal_at` of ``pos`` to the token's
    embedding and attends to the cached cross k / v."""
    cdt = L.compute_dtype(cfg)
    x = params["embed"][tokens.long()].to(cdt)
    pos = cache["pos"]
    if cfg.family == "encdec":
        x = x + _sinusoidal_at(pos, cfg.d_model, cdt)
    for lp, lc, xc in _stack(cfg, params, cache):
        h = L.norm_apply(cfg, lp["ln1"], x)
        if "attn" in lp:
            y, _ = L.attn_decode(cfg, lp["attn"], h, lc["k"], lc["v"], pos)
        else:
            y, _ = L.ssm_decode(cfg, lp["ssm"], h, lc["state"], lc["conv"])
        x = x + y
        if xc is not None:
            x = _cross(cfg, lp, x, xc["k"], xc["v"])
        if "ln2" in lp:
            x = x + _ffn(cfg, lp, x)
    x = L.norm_apply(cfg, params["final_norm"], x)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x)[:, 0], cache
