"""The port's vision-language family (internvl2-76b) against the JAX
package's, on the CPU.

internvl2-76b's smoke config (2 layers, d 64, 8 query heads on 1 kv head of
8, RMSNorm, RoPE, SwiGLU, 8 vision tokens), float32, remat off unless said,
the JAX parameters of ``init_params(PRNGKey(0))`` carried over with
``params_from_jax``, the data pipeline's batches and seeded 0.02 · N(0, 1)
vision embeddings prepended to the tokens (as
``tests/test_arch_smoke.py::_batch``).  The reference's results are
computed once a module.

Held, at rtol 1e-4 with an absolute floor of 1e-4 of each array's largest
entry (``tests/test_torch_train.py::_close``) unless said:

* ``param_shapes`` against ``jax.eval_shape(init_params)``, smoke and full;
* prefill logits and the cache (RoPE over the vision prefix too, ``pos``
  vision + S), then three decode steps; past the flash gate (vision 8 + 120
  tokens) the port's flash path against the reference's chunked one;
* ``train_loss`` (no loss on the vision positions), ``lm_loss`` and every
  gradient; AdamW twice on the reference's gradients; remat none / full /
  dots bit for bit; 2 microbatches against 1 within 2e-5; 60 steps
  lowering the loss;
* ``serve.main`` and ``launch.train.main`` on the CPU; ROADMAP C9: the
  reference's ``prefill`` raises at the cache of ``prompt + gen`` that its
  serve entry sizes, and the port's ``serve.main`` serves the same request.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_batch as torch_batch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train import _close, _jleaves  # noqa: E402

ARCH = "internvl2-76b"
MICRO_ATOL = 2e-5


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", remat="none", **kw)


def _vision(cfg, b, seed=2):
    rng = np.random.default_rng(seed)
    return 0.02 * rng.standard_normal((b, cfg.vision_tokens, cfg.d_model),
                                      dtype=np.float32)


def _batch(cfg, step=0, seq=16, batch=2):
    b = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch), step)
    b["loss_mask"][:, -3:] = 0.0          # a mask that drops some positions
    b["vision_embeds"] = _vision(cfg, batch, seed=step + 2)
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


def _prefills(ref, toks, vision, max_len, tcfg=None):
    jcfg, tcfg = ref["jcfg"], tcfg or ref["tcfg"]
    b = toks.shape[0]
    jl, jc = JM.prefill(jcfg, ref["jp"], {
        "tokens": jnp.asarray(toks, jnp.int32),
        "vision_embeds": jnp.asarray(vision)}, JM.init_cache(jcfg, b, max_len))
    tl, tc = TM.prefill(tcfg, ref["tp"], torch.as_tensor(toks),
                        TM.init_cache(tcfg, b, max_len, "cpu"),
                        embeds=torch.from_numpy(vision))
    return jl, jc, tl, tc


def test_param_shapes_match_the_reference_smoke_and_full():
    """The dense tree (the vision stub holds no parameter), by
    ``jax.eval_shape``, at the smoke config and the full 80 layers."""
    for jcfg, tcfg in ((jax_smoke(ARCH), get_smoke_config(ARCH)),
                       (jax_config(ARCH), get_config(ARCH))):
        want = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
        assert TM.param_shapes(tcfg) == want


def test_prefill_logits_and_cache_match_jax(ref):
    """The last position's logits, k / v over the vision prefix and the
    tokens (RoPE positions 0 ... vision + S - 1), ``pos`` = vision + S."""
    toks = np.random.default_rng(1).integers(0, 256, (2, 16))
    jl, jc, tl, tc = _prefills(ref, toks, _vision(ref["jcfg"], 2), 28)
    _close(tl, jl, "prefill logits")
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], key)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["pos"][0]) == 8 + 16


def test_flash_path_past_the_gate_matches_the_chunked_reference(ref,
                                                                monkeypatch):
    """8 vision + 120 tokens reach the flash gate (S >= 128, the prefix
    counted): with the kernels on, each layer's prefill attention goes
    through ``fa_ops.flash_attention`` (its plain version on the CPU),
    against the reference's chunked path."""
    calls = []
    flash = fa_ops.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return flash(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    toks = np.random.default_rng(3).integers(0, 256, (2, 120))
    kcfg = dataclasses.replace(ref["tcfg"], use_kernels=True)
    jl, jc, tl, tc = _prefills(ref, toks, _vision(ref["jcfg"], 2, 4), 132,
                               tcfg=kcfg)
    assert calls == [(2, 128, 8, 8)] * 2
    _close(tl, jl, "prefill logits, flash path")
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], key)


def test_three_decode_steps_match_jax(ref):
    """Three decode steps after a prefill with the vision prefix: each
    step's logits (RoPE at vision + S + i) and the caches after them."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 256, (2, 12))
    _, jc, _, tc = _prefills(ref, toks, _vision(ref["jcfg"], 2, 5), 24)
    for step in range(3):
        nxt = rng.integers(0, 256, (2, 1))
        jl, jc = JM.decode_step(ref["jcfg"], ref["jp"], jc,
                                jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(ref["tcfg"], ref["tp"], tc,
                                torch.as_tensor(nxt))
        _close(tl, jl, f"decode step {step}")
    for key in ("k", "v"):
        _close(tc["layers"][key], jc["layers"][key], key)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_train_loss_and_every_gradient_match_jax(ref):
    """The loss over the token positions alone, ``lm_loss`` (aux 0) and
    every gradient leaf."""
    tl, tm, tg = TS.loss_and_grads(ref["tcfg"], ref["tp"], ref["tb"])
    _close(tl, ref["jl"], "loss")
    _close(tm["lm_loss"], ref["jm"]["lm_loss"], "lm_loss")
    assert float(tm["aux_loss"]) == float(ref["jm"]["aux_loss"]) == 0.0
    jgl, tgl = _jleaves(ref["jg"]), leaves(tg)
    assert len(jgl) == len(tgl) == len(leaves(ref["tp"]))
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
    """``none``, ``full`` and ``dots`` give the same loss and gradients bit
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
    """2 microbatches (the vision embeddings split with the tokens) against
    one batch of 4: the loss and every summed gradient within 2e-5."""
    _, tb = _batch(ref["tcfg"], step=2, batch=4)
    l1, _, g1 = TS.batch_grads(ref["tcfg"], ref["tp"], tb, 1)
    l2, _, g2 = TS.batch_grads(ref["tcfg"], ref["tp"], tb, 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=0, atol=MICRO_ATOL)
    for i, (a, b) in enumerate(zip(leaves(g2), leaves(g1))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=MICRO_ATOL, err_msg=f"leaf {i}")


def test_training_reduces_loss():
    """60 steps of the smoke config on the pipeline's batches with seeded
    vision embeddings (``launch.train.data_config``) lower the loss by more
    than 0.5, every loss finite."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    oc = TA.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = TS.make_train_step(cfg, oc)
    data_cfg = LT.data_config(cfg, 16, 4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TA.init(params)
    losses = []
    for step in range(60):
        batch = LT.batch_on(torch_batch(data_cfg, step), torch.device("cpu"))
        assert batch["vision_embeds"].shape == (4, 8, 64)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_serve_and_train_entries_on_the_cpu(capsys):
    """``serve.main --smoke --device cpu`` serves internvl2-76b (zero
    vision embeddings, as the reference's entry), and ``launch.train.main``
    trains it from the pipeline's batches with vision embeddings, which the
    reference's trainer does not give it."""
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "3", "--batch", "2", "--prompt", "16",
                      "--gen", "4"])
    assert out["tokens"] == 12 and out["logits_finite"]
    assert out["flash_launches"] == 0
    res = LT.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
                   "20", "--batch", "4", "--seq", "16", "--log-every", "10"])
    assert len(res["losses"]) == 2 and np.isfinite(res["final_loss"])
    assert "tok/s" in capsys.readouterr().out


def test_c9_the_references_serve_cache_overflows_and_the_ports_does_not(ref):
    """ROADMAP C9: the reference's serve entry sizes the cache ``prompt +
    gen`` (``src/repro/launch/serve.py:37``), and a vlm prefill writes
    ``vision_tokens + prompt`` positions, so at gen < vision_tokens its
    prefill raises (vision 8, prompt 16, gen 4: 24 positions into 20).  The
    port's ``serve.main`` sizes it ``vision_tokens + prompt + gen`` and
    serves the same request."""
    jcfg = ref["jcfg"]
    prompt, gen = 16, 4
    toks = np.random.default_rng(6).integers(0, 256, (2, prompt))
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        JM.prefill(jcfg, ref["jp"], {
            "tokens": jnp.asarray(toks, jnp.int32),
            "vision_embeds": jnp.zeros((2, 8, 64))},
            JM.init_cache(jcfg, 2, prompt + gen))
    assert TM.prefix_len(get_smoke_config(ARCH)) == 8
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--requests", "2", "--batch", "2", "--prompt",
                      str(prompt), "--gen", str(gen)])
    assert out["tokens"] == 2 * gen and out["logits_finite"]
