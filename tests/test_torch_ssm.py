"""The port's SSM family (mamba2-130m) against the JAX package's, on the CPU.

The smoke config (2 layers, d 64, d_inner 128, 8 heads of 16, state 16,
chunk 8, tied embeddings) in float32 at atol = rtol = 1e-4 (the tolerance
of ``tests/test_torch_model.py``: the two frameworks sum the same float32
products in another order), on the JAX parameters of
``init_params(PRNGKey(0))`` carried over with ``params_from_jax``:

* ``param_shapes`` against ``jax.eval_shape`` of the reference's
  ``init_params``, smoke and full; ``params_from_jax`` and the port's init
  keeping ``A_log``, ``D`` and ``dt_bias`` in float32; the leaf-by-leaf
  ``init_serving_params`` bit for bit ``serving_params(init_params(...))``;
* ``_causal_conv`` and ``_gated_rmsnorm``;
* ``ssm_apply`` with ``return_state`` at S = 5, 8, 13 and 16 with chunk 8
  (one short chunk, one whole chunk, a padded second chunk, two whole
  chunks): the output, the final state and the conv tail;
* three ``ssm_decode`` steps from that state, the cache written in place;
* prefill and three decode steps' logits and caches; prefill(S) plus one
  decode step against prefill(S + 1) (the chunked form against the
  recurrent one);
* ``serve.main --smoke --device cpu``; ``train_loss`` taking the family
  (it refused it until the SSD scan's backward was ported; the test keeps
  its name).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCH = "mamba2-130m"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _pair(arch=ARCH, **kw):
    """(jax cfg, port cfg, JAX params, the port's copy), float32."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams))


def _layer0(jparams, tparams):
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    tp = TM._layer(tparams["blocks"], 0)["ssm"]
    return jp, tp


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_param_shapes_are_the_references_tree():
    """Smoke and full (the full tree by ``jax.eval_shape``, nothing
    allocated): one ``ssm`` block a layer behind ``ln1``, no ``ln2`` and
    no feed-forward, tied embeddings; 0.129 B parameters at full config."""
    for jget, tget in ((jax_smoke, get_smoke_config), (jax_config, get_config)):
        jcfg, tcfg = jget(ARCH), tget(ARCH)
        tree = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        assert TM.param_shapes(tcfg) == jax.tree.map(lambda a: tuple(a.shape),
                                                     tree)
    full = get_config(ARCH)
    assert set(TM.param_shapes(full)["blocks"]) == {"ln1", "ssm"}
    assert full.padded_vocab == 50432 and full.ssm_num_heads == 24
    assert abs(full.num_params() / 1e9 - 0.129) < 0.001


def test_params_from_jax_and_init_keep_the_fp32_leaves():
    """``params_from_jax`` copies every leaf; with ``param_dtype`` bf16 the
    SSM's ``A_log``, ``D`` and ``dt_bias`` stay float32, as the reference
    initialises them, and so does the port's init (``A_log`` and
    ``dt_bias`` 0, ``D`` 1, the conv filters at fan-in cw, ``w_out`` at
    d_inner)."""
    _, tcfg, jparams, tparams = _pair()
    back = jax.tree.map(np.asarray, jparams)
    flat_j = _leaves(back)
    for path, leaf in jax.tree_util.tree_leaves_with_path(tparams):
        np.testing.assert_array_equal(_np(leaf), flat_j[path])
    half = dataclasses.replace(tcfg, param_dtype="bfloat16")
    for tree in (params_from_jax(half, back),
                 TM.init_params(half, torch.Generator().manual_seed(0))):
        ssm = tree["blocks"]["ssm"]
        for key in ("A_log", "D", "dt_bias"):
            assert ssm[key].dtype == torch.float32, key
        assert ssm["w_x"].dtype == torch.bfloat16
    init = TM.init_params(get_config(ARCH), torch.Generator().manual_seed(0))
    ssm = init["blocks"]["ssm"]
    assert bool((ssm["A_log"] == 0).all()) and bool((ssm["D"] == 1).all())
    assert abs(ssm["conv_x"].std().item() * 4 ** 0.5 - 1) < 0.02
    assert abs(ssm["w_out"].std().item() * 1536 ** 0.5 - 1) < 0.02
    assert abs(ssm["w_x"].std().item() * 768 ** 0.5 - 1) < 0.02


def test_serving_init_leaf_by_leaf_equals_cast_of_full_init():
    """mamba2-130m and jamba-v0.1-52b (smoke): every leaf of
    ``init_serving_params`` bit for bit ``serving_params(init_params(...))``;
    the SSM's fp32 leaves and its gated norm's scale kept, its matrices in
    the compute dtype."""
    for arch in (ARCH, "jamba-v0.1-52b"):
        cfg = get_smoke_config(arch)
        want = TM.serving_params(cfg, TM.init_params(
            cfg, torch.Generator().manual_seed(3)))
        got = _leaves(TM.init_serving_params(
            cfg, torch.Generator().manual_seed(3)))
        flat = jax.tree_util.tree_leaves_with_path(want)
        assert len(flat) == len(got)
        for path, leaf in flat:
            assert got[path].dtype == leaf.dtype, path
            assert torch.equal(got[path], leaf), path
        blocks = want["blocks"]
        ssm = blocks["ssm"] if arch == ARCH else blocks["sub0"]["ssm"]
        for key in ("A_log", "D", "dt_bias"):
            assert ssm[key].dtype == torch.float32, key
        assert ssm["norm"]["scale"].dtype == torch.float32
        assert ssm["w_z"].dtype == torch.bfloat16


def test_causal_conv_and_gated_rmsnorm_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    z = rng.normal(size=(2, 11, 24)).astype(np.float32)
    for cw in (1, 4):
        w = rng.normal(size=(cw, 24)).astype(np.float32)
        want = JL._causal_conv(jnp.asarray(x), jnp.asarray(w))
        got = TL._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    scale = rng.normal(size=(24,)).astype(np.float32)
    want = JL._gated_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                             jnp.asarray(z))
    got = TL._gated_rmsnorm({"scale": torch.from_numpy(scale)},
                            torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("s", [5, 8, 13, 16])
def test_ssm_apply_with_state_matches_jax(s):
    """Chunk 8: S = 5 (one chunk of 5), 8 (one whole chunk), 13 (a second
    chunk padded with dt = 0 steps), 16 (two whole chunks): the output,
    the final state and the conv tail of the unpadded projections."""
    jcfg, tcfg, jparams, tparams = _pair()
    jp, tp = _layer0(jparams, tparams)
    x = np.random.default_rng(s).normal(size=(2, s, jcfg.d_model))
    x = x.astype(np.float32)
    jy, (jst, jtail) = JL.ssm_apply(jcfg, jp, jnp.asarray(x),
                                    return_state=True)
    ty, (tst, ttail) = TL.ssm_apply(tcfg, tp, torch.from_numpy(x),
                                    return_state=True)
    assert tst.shape == (2, tcfg.ssm_num_heads, tcfg.ssm_head_dim,
                         tcfg.ssm_state)
    assert ttail.shape == (2, tcfg.ssm_conv_width - 1,
                           tcfg.ssm_d_inner + 2 * tcfg.ssm_state)
    for got, want in ((ty, jy), (tst, jst), (ttail, jtail)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(TL.ssm_apply(tcfg, tp,
                                                torch.from_numpy(x))),
                               _np(jy), **TOL)


def test_three_ssm_decode_steps_match_jax_in_place():
    """From ``ssm_apply``'s state after 13 steps: three ``ssm_decode``
    steps' outputs, states and conv windows, the port's written into the
    tensors it was given."""
    jcfg, tcfg, jparams, tparams = _pair()
    jp, tp = _layer0(jparams, tparams)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    _, jstate = JL.ssm_apply(jcfg, jp, jnp.asarray(x), return_state=True)
    _, (state, conv) = TL.ssm_apply(tcfg, tp, torch.from_numpy(x),
                                    return_state=True)
    ptrs = (state.data_ptr(), conv.data_ptr())
    for _ in range(3):
        xt = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jstate = JL.ssm_decode(jcfg, jp, jnp.asarray(xt), jstate)
        ty, (st, cv) = TL.ssm_decode(tcfg, tp, torch.from_numpy(xt), state,
                                     conv)
        assert (st.data_ptr(), cv.data_ptr()) == ptrs
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
        np.testing.assert_allclose(_np(state), _np(jstate[0]), **TOL)
        np.testing.assert_allclose(_np(conv), _np(jstate[1]), **TOL)


def test_prefill_and_three_decode_steps_match_jax():
    jcfg, tcfg, jparams, tparams = _pair()
    B, S, MAX = 2, 13, 20
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        JM.init_cache(jcfg, B, MAX))
    tl, tc = TM.prefill(tcfg, tparams, torch.as_tensor(toks),
                        TM.init_cache(tcfg, B, MAX, "cpu"))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("state", "conv"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   _np(jc["layers"][key]), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))


def test_prefill_then_decode_equals_the_longer_prefill():
    """The chunked form against the recurrent one in float32: prefill(S)
    plus one decode step gives prefill(S + 1)'s logits, at S = 15 (the
    step lands in the padded second chunk) and 16 (it opens a third)."""
    _, tcfg, _, tparams = _pair()
    rng = np.random.default_rng(2)
    for s in (15, 16):
        toks = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (2, s + 1)))
        want, _ = TM.prefill(tcfg, tparams, toks,
                             TM.init_cache(tcfg, 2, s + 1, "cpu"))
        _, cache = TM.prefill(tcfg, tparams, toks[:, :s],
                              TM.init_cache(tcfg, 2, s + 1, "cpu"))
        got, _ = TM.decode_step(tcfg, tparams, cache, toks[:, s:])
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_serve_main_runs_the_ssm_family_on_the_cpu(capsys):
    fa.reset_launch_count()
    moe.reset_launch_count()
    summary = serve.main(["--arch", ARCH, "--smoke", "--requests", "4",
                          "--batch", "2", "--prompt", "20", "--gen", "4"],
                         device="cpu")
    assert summary["tokens"] == 16 and summary["logits_finite"]
    assert summary["flash_launches"] == 0
    assert summary["moe_launches"] == dict.fromkeys(moe.ENTRIES, 0)
    assert summary["prefill_dropped"] == 0
    assert "MoE entries dropped" not in capsys.readouterr().out


def test_train_loss_refuses_the_ssm_family():
    """The family trains now (the name is kept from the slice that only
    served it): ``train_loss`` runs on the smoke config, records autograd
    through the SSD scan, and gives a finite loss and a gradient for every
    SSM leaf; on the CPU the scan takes its plain versions (no launch)."""
    cfg = get_smoke_config(ARCH)
    assert "ssm" in TM.FAMILIES
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    flat = [p.requires_grad_() for p in jax.tree.leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    ssd.reset_launch_count()
    loss, metrics = TM.train_loss(cfg, params, {"tokens": toks,
                                                "targets": toks,
                                                "loss_mask": torch.ones(1, 8)})
    assert loss.requires_grad and torch.isfinite(loss)
    assert float(metrics["aux_loss"]) == 0.0
    grads = torch.autograd.grad(loss, flat)
    assert all(torch.isfinite(g).all() for g in grads)
    ssm = params["blocks"]["ssm"]
    for key in ("A_log", "dt_bias", "w_B", "w_C", "w_x", "conv_x"):
        g, = torch.autograd.grad(TM.train_loss(cfg, params, {
            "tokens": toks, "targets": toks,
            "loss_mask": torch.ones(1, 8)})[0], ssm[key])
        assert float(g.abs().max()) > 0, key
    assert ssd.launch_count() == 0
