"""The port's encoder-decoder family (whisper-medium) against the JAX
package's, on the CPU.

whisper-medium's smoke config (2 encoder + 2 decoder layers, d 64, 4 heads,
24 audio frames, LayerNorm with bias, sinusoidal positions, gelu MLPs,
tied embeddings), float32, remat off unless said, the JAX parameters of
``init_params(PRNGKey(0))`` carried over with ``params_from_jax``, the data
pipeline's batches and seeded 0.02 · N(0, 1) audio embeddings (as
``tests/test_arch_smoke.py::_batch``).  The reference's results are
computed once a module.

Held, at rtol 1e-4 with an absolute floor of 1e-4 of each array's largest
entry (``tests/test_torch_train.py::_close``) unless said:

* ``param_shapes`` against ``jax.eval_shape(init_params)``, smoke and full;
  ``params_from_jax`` over the nested trees, refusing a missing or extra key;
  ``serving_params`` keeping ``lnx`` and ``enc_norm`` as stored;
* the gelu MLP (tanh form; torch's exact erf fails the same bound), the
  sinusoidal tables of the prefill and the decode step (2e-6 absolute),
  ``cross_kv`` / ``cross_attn_apply`` and the encoder;
* prefill logits, self and cross k / v, then three decode steps;
* ``train_loss``, ``lm_loss`` and every gradient; AdamW twice on the
  reference's gradients; remat none / full / dots bit for bit; 2
  microbatches against 1 within 2e-5; 60 steps lowering the loss;
* ``serve.main`` and ``launch.train.main`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_batch as torch_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train import _close, _jleaves  # noqa: E402

ARCH = "whisper-medium"
MICRO_ATOL = 2e-5
SIN_ATOL = 2e-6


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", remat="none", **kw)


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(x.shape), tree)


def _audio(cfg, b, seed=2):
    rng = np.random.default_rng(seed)
    return 0.02 * rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                      dtype=np.float32)


def _batch(cfg, step=0, seq=16, batch=2):
    b = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch), step)
    b["loss_mask"][:, -3:] = 0.0          # a mask that drops some positions
    b["audio_embeds"] = _audio(cfg, batch, seed=step + 2)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.fixture(scope="module")
def ref():
    """The pair of configs and parameters, and the reference's loss and
    gradients on one batch (computed once)."""
    jcfg, tcfg = _f32(jax_smoke(ARCH)), _f32(get_smoke_config(ARCH))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, jb), has_aux=True)(jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tb=tb, jl=jl, jm=jm,
                jg=jg)


def test_param_shapes_match_the_reference_smoke_and_full():
    """The decoder layers' ``ln1 attn lnx xattn ln2 mlp`` (gelu: no
    ``w_gate``), ``enc_blocks`` over ``encoder_layers``, ``enc_norm``: the
    tree ``init_params`` leaves (it builds ``blocks`` twice), by
    ``jax.eval_shape``."""
    for jcfg, tcfg in ((jax_smoke(ARCH), get_smoke_config(ARCH)),
                       (jax_config(ARCH), get_config(ARCH))):
        want = _shapes(jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
        assert TM.param_shapes(tcfg) == want
        assert "w_gate" not in TM.param_shapes(tcfg)["enc_blocks"]["mlp"]


def test_conversion_and_serving_params_keep_the_nested_trees(ref):
    """``params_from_jax`` carries ``enc_blocks``, ``xattn`` and the gelu
    ``mlp`` over by value and raises on a missing or an extra key;
    ``serving_params`` casts the matrices and keeps every norm (``lnx``,
    ``enc_norm`` among them) as stored."""
    tp, jp, tcfg = ref["tp"], ref["jp"], ref["tcfg"]
    for a, b in zip(leaves(tp), _jleaves(jp)):
        np.testing.assert_array_equal(a.numpy(), b)
    tree = jax.tree.map(np.asarray, jp)
    broken = dict(tree, enc_blocks=dict(tree["enc_blocks"]))
    del broken["enc_blocks"]["mlp"]
    with pytest.raises(ValueError, match="enc_blocks"):
        params_from_jax(tcfg, broken)
    extra = dict(tree, blocks=dict(tree["blocks"]))
    extra["blocks"]["mlp"] = dict(extra["blocks"]["mlp"],
                                  w_gate=extra["blocks"]["mlp"]["w_up"])
    with pytest.raises(ValueError, match="mlp"):
        params_from_jax(tcfg, extra)
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    sp = TM.serving_params(bf, tp)
    assert sp["blocks"]["xattn"]["wq"].dtype == torch.bfloat16
    assert sp["enc_blocks"]["mlp"]["w_up"].dtype == torch.bfloat16
    for tree_ in (sp["blocks"]["lnx"], sp["enc_norm"],
                  sp["enc_blocks"]["ln1"], sp["final_norm"]):
        assert all(t.dtype == torch.float32 for t in leaves(tree_))


def test_gelu_mlp_is_the_references_tanh_form(ref):
    """The gelu MLP against ``repro.models.layers.mlp_apply``; the same MLP
    with torch's default exact gelu misses the bound."""
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    jmlp = jax.tree.map(lambda x: x[0], ref["jp"]["enc_blocks"]["mlp"])
    tmlp = TM._layer(ref["tp"]["enc_blocks"], 0)["mlp"]
    x = np.random.default_rng(3).standard_normal((2, 24, jcfg.d_model),
                                                 dtype=np.float32)
    want = np.asarray(JL.mlp_apply(jcfg, jmlp, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    _close(TL.mlp_apply(tcfg, tmlp, xt), want, "gelu mlp")
    exact = F.gelu(xt @ tmlp["w_up"]) @ tmlp["w_down"]
    with pytest.raises(AssertionError):
        _close(exact, want, "the MLP with exact gelu")


def test_sinusoidal_tables_match_the_references():
    """The prefill's float64 table and the decode step's float32 term, at
    the smoke and the full width over whisper's 448 text positions and
    1500 frames, within 2e-6."""
    for d in (64, 1024):
        want = np.asarray(JM._sinusoidal(1500, d, jnp.float32))
        got = TM._sinusoidal(1500, d, torch.float32, torch.device("cpu"))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SIN_ATOL)
        pos = np.arange(448)
        want = np.asarray(JM._sinusoidal_at(jnp.asarray(pos, jnp.int32), d,
                                            jnp.float32))
        got = TM._sinusoidal_at(torch.as_tensor(pos), d, torch.float32)
        assert got.shape == (448, 1, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SIN_ATOL)


def test_cross_attention_and_the_encoder_match_jax(ref):
    """``cross_kv`` and ``cross_attn_apply`` of layer 0 (Sq 16, and 1 as at
    decode), and the encoder's output, against the reference's."""
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    audio = _audio(jcfg, 2)
    want_enc = JM._run_encoder(jcfg, ref["jp"], jnp.asarray(audio))
    enc = TM._run_encoder(tcfg, ref["tp"], torch.from_numpy(audio),
                          torch.float32, remat=False)
    _close(enc, want_enc, "encoder output")
    jx = jax.tree.map(lambda x: x[0], ref["jp"]["blocks"]["xattn"])
    tx = TM._layer(ref["tp"]["blocks"], 0)["xattn"]
    jk, jv = JL.cross_kv(jcfg, jx, want_enc)
    tk, tv = TL.cross_kv(tcfg, tx, enc)
    _close(tk, jk, "cross k")
    _close(tv, jv, "cross v")
    x = np.random.default_rng(4).standard_normal((2, 16, jcfg.d_model),
                                                 dtype=np.float32)
    for sq in (16, 1):
        want = JL.cross_attn_apply(jcfg, jx, jnp.asarray(x[:, :sq]), jk, jv)
        got = TL.cross_attn_apply(tcfg, tx, torch.from_numpy(x[:, :sq]), tk,
                                  tv)
        _close(got, want, f"cross attention, Sq {sq}")


def _prefills(ref, toks, audio, max_len):
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    b = toks.shape[0]
    jl, jc = JM.prefill(jcfg, ref["jp"], {
        "tokens": jnp.asarray(toks, jnp.int32),
        "audio_embeds": jnp.asarray(audio)}, JM.init_cache(jcfg, b, max_len))
    tl, tc = TM.prefill(tcfg, ref["tp"], torch.as_tensor(toks),
                        TM.init_cache(tcfg, b, max_len, "cpu"),
                        embeds=torch.from_numpy(audio))
    return jl, jc, tl, tc


def test_prefill_logits_and_caches_match_jax(ref):
    """The last position's logits, every layer's self k / v, the cross k /
    v (computed once in the port, twice in the reference) and ``pos``."""
    toks = np.random.default_rng(1).integers(0, 256, (2, 16))
    jl, jc, tl, tc = _prefills(ref, toks, _audio(ref["jcfg"], 2), 24)
    _close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], f"self {key}")
        _close(tc["cross_kv"][key], jc["cross_kv"][key], f"cross {key}")
    assert tc["cross_kv"]["k"].shape == (2, 2, 24, 4, 16)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_three_decode_steps_match_jax(ref):
    """Three greedy-free decode steps after the prefill: each step's logits
    and the caches after the third (the sinusoidal term at ``pos``, the
    cross-attention from the cached k / v)."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 12))
    _, jc, _, tc = _prefills(ref, toks, _audio(ref["jcfg"], 2, seed=5), 16)
    for step in range(3):
        nxt = rng.integers(0, 256, (2, 1))
        jl, jc = JM.decode_step(ref["jcfg"], ref["jp"], jc,
                                jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(ref["tcfg"], ref["tp"], tc,
                                torch.as_tensor(nxt))
        _close(tl, jl, f"decode step {step}")
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], f"self {key}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_train_loss_and_every_gradient_match_jax(ref):
    """The loss, ``lm_loss`` (aux 0) and every gradient leaf, the
    encoder's included, each decoder layer's cross k / v computed from the
    encoder output inside the layer."""
    tl, tm, tg = TS.loss_and_grads(ref["tcfg"], ref["tp"], ref["tb"])
    _close(tl, ref["jl"], "loss")
    _close(tm["lm_loss"], ref["jm"]["lm_loss"], "lm_loss")
    assert float(tm["aux_loss"]) == float(ref["jm"]["aux_loss"]) == 0.0
    jgl, tgl = _jleaves(ref["jg"]), leaves(tg)
    assert len(jgl) == len(tgl) == len(leaves(ref["tp"])) == 31
    for i, (a, b) in enumerate(zip(tgl, jgl)):
        assert a.shape == b.shape, i
        _close(a, b, f"gradient leaf {i}")
    assert not any(p.requires_grad for p in leaves(ref["tp"]))


def test_adamw_twice_on_the_references_gradients(ref):
    """``adamw.apply`` twice on the reference's gradients: the parameters,
    both moments and the metrics, clipping and weight decay on."""
    jp = ref["jp"]
    tp = params_from_jax(ref["tcfg"], jax.tree.map(np.asarray, jp))  # a copy
    oc = JA.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    toc = TA.OptConfig(**dataclasses.asdict(oc))
    jg = ref["jg"]
    tg = params_from_jax(ref["tcfg"], jax.tree.map(np.asarray, jg))
    jo, to = JA.init(jp), TA.init(tp)
    for k in range(2):
        jp, jo, jmet = JA.apply(oc, jg, jo, jp)
        tp, to, tmet = TA.apply(toc, tg, to, tp)
        for name, t, j in (("params", tp, jp), ("mu", to["mu"], jo["mu"]),
                           ("nu", to["nu"], jo["nu"])):
            for i, (a, b) in enumerate(zip(leaves(t), _jleaves(j))):
                _close(a, b, f"{name} leaf {i}, update {k}")
        for key in ("grad_norm", "lr"):
            _close(tmet[key], jmet[key], key)


def test_remat_modes_give_equal_gradients(ref):
    """``none``, ``full`` (each encoder and decoder layer recomputed, the
    cross k / v with it) and ``dots`` give the same loss and gradients bit
    for bit."""
    _, tb = _batch(ref["tcfg"], step=1, seq=12)
    want = None
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(ref["tcfg"], remat=mode)
        loss, _, grads = TS.loss_and_grads(cfg, ref["tp"], tb)
        flat = [loss] + leaves(grads)
        if want is None:
            want = flat
            continue
        for i, (a, b) in enumerate(zip(flat, want)):
            assert torch.equal(a, b), (mode, i)


def test_two_microbatches_match_the_whole_batch(ref):
    """2 microbatches (the audio frames split with the tokens) against one
    batch of 4: the loss and every summed gradient within 2e-5."""
    _, tb = _batch(ref["tcfg"], step=2, batch=4)
    l1, _, g1 = TS.batch_grads(ref["tcfg"], ref["tp"], tb, 1)
    l2, _, g2 = TS.batch_grads(ref["tcfg"], ref["tp"], tb, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=0, atol=MICRO_ATOL)
    for i, (a, b) in enumerate(zip(leaves(g2), leaves(g1))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=MICRO_ATOL, err_msg=f"leaf {i}")


def test_training_reduces_loss():
    """60 steps of the smoke config on the pipeline's batches with seeded
    audio frames (``launch.train.data_config``) lower the loss by more than
    0.5, every loss finite."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    oc = TA.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = TS.make_train_step(cfg, oc)
    data_cfg = LT.data_config(cfg, 16, 4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TA.init(params)
    losses = []
    for step in range(60):
        batch = LT.batch_on(torch_batch(data_cfg, step), torch.device("cpu"))
        assert batch["audio_embeds"].shape == (4, 24, 64)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_serve_and_train_entries_on_the_cpu(capsys):
    """``serve.main --smoke --device cpu`` serves whisper-medium (zero
    audio frames, as the reference's entry), and ``launch.train.main``
    trains it from the pipeline's batches with audio frames, which the
    reference's trainer does not give it.  The audio frames go to the
    encoder, so the decoder's cache holds no prefix."""
    assert TM.prefix_len(get_smoke_config(ARCH)) == 0
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--prompt", "16",
                      "--gen", "4"])
    assert out["tokens"] == 12 and out["logits_finite"]
    assert out["flash_launches"] == 0
    res = LT.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                   "20", "--batch", "4", "--seq", "16", "--log-every", "10"])
    assert len(res["losses"]) == 2 and np.isfinite(res["final_loss"])
    assert "tok/s" in capsys.readouterr().out
