"""The port's hybrid family (jamba-v0.1-52b) against the JAX package's, on
the CPU.

The smoke config: 4 layers, one period of ``attn_every`` 4 sub-layers
(attention at offset 2, the SSM elsewhere; MoE of 4 experts top-2 on
sub-layers 1 and 3, the MLP on 0 and 2), d 64, in float32 at atol = rtol =
1e-4 (``tests/test_torch_model.py``'s tolerance), on the JAX parameters of
``init_params(PRNGKey(0))`` carried over with ``params_from_jax``.  On the
CPU ``kernels/moe`` takes its plain versions and attention its chunked
einsum path; ``tests/test_torch_ssm_card.py`` holds the kernel path to
the plain one on the card.

* the period layout ``sub0`` ... ``sub3`` against the reference's tree,
  smoke and full (by ``jax.eval_shape``);
* the decode cache's layout against the reference's ``init_cache``;
* prefill and three decode steps at capacity 1.25 and 0.5 (entries
  dropped in the MoE sub-layers);
* ``serve.main --smoke --device cpu``, the drops reported; ``train_loss``
  taking the family (it refused it until the SSD scan's backward was
  ported; the test keeps its name; ``tests/test_torch_ssm_train.py`` holds
  its gradients to the reference's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


def test_period_layout_is_the_references_tree():
    """Smoke and full: ``blocks`` holds one period's sub-layers, each
    stacked over the periods; attention at ``attn_offset``, MoE on every
    ``moe_every``-th sub-layer, the MLP on the rest.  The full config at
    16 of 32 layers (2 periods, as the card serves it) is 26.0 B
    parameters."""
    for jget, tget in ((jax_smoke, get_smoke_config), (jax_config, get_config)):
        jcfg, tcfg = jget(ARCH), tget(ARCH)
        tree = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
        assert TM.param_shapes(tcfg) == _shapes(tree)
    full = get_config(ARCH)
    blocks = TM.param_shapes(full)["blocks"]
    assert sorted(blocks) == [f"sub{i}" for i in range(8)]
    assert [("attn" in b, "moe" in b) for b in
            (blocks[f"sub{i}"] for i in range(8))] == [
        (False, False), (False, True), (False, False), (False, True),
        (True, False), (False, True), (False, False), (False, True)]
    assert blocks["sub1"]["moe"]["w_gate"] == (4, 16, 4096, 14336)
    assert blocks["sub0"]["ssm"]["w_x"] == (4, 4096, 8192)
    cut = dataclasses.replace(full, num_layers=16)
    assert abs(cut.num_params() / 1e9 - 26.0) < 0.05
    with pytest.raises(ValueError, match="whole periods"):
        TM.param_shapes(dataclasses.replace(full, num_layers=12))


def test_cache_layout_is_the_references():
    """Per sub-layer over the periods: attention ``k`` / ``v`` (P, B,
    max_len, Hkv, Dh), the SSM's ``state`` (P, B, nh, hd, ns) and ``conv``
    (P, B, cw-1, d_inner + 2·ns), in the compute dtype; ``pos`` (B,)."""
    for jget, tget in ((jax_smoke, get_smoke_config), (jax_config, get_config)):
        jcfg, tcfg = jget(ARCH), tget(ARCH)
        want = jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 40))
        got = TM.init_cache(tcfg, 3, 40, "meta")      # nothing allocated
        assert jax.tree.map(lambda t: tuple(t.shape), got) == _shapes(want)
        assert got["layers"]["sub0"]["state"].dtype == torch.bfloat16
    assert got["pos"].dtype == torch.long


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_prefill_and_three_decode_steps_match_reference(cf):
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32",
                               capacity_factor=cf)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               capacity_factor=cf)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    B, S, MAX = 2, 13, 20
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        JM.init_cache(jcfg, B, MAX))
    drops = []
    tl, tc = TM.prefill(tcfg, tparams, torch.as_tensor(toks),
                        TM.init_cache(tcfg, B, MAX, "cpu"), drops)
    moe_layers = sum(tcfg.is_moe_layer(i) for i in range(tcfg.num_layers))
    assert len(drops) == moe_layers == 2
    assert (int(sum(drops)) > 0) == (cf == 0.5)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jc["layers"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(tc["layers"]):
        np.testing.assert_allclose(_np(leaf), _np(flat_j[path]), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))


def test_serve_main_runs_the_hybrid_family_on_the_cpu(capsys):
    moe.reset_launch_count()
    summary = serve.main(["--arch", ARCH, "--smoke", "--requests", "4",
                          "--batch", "2", "--prompt", "24", "--gen", "4"],
                         device="cpu")
    assert summary["tokens"] == 16 and summary["logits_finite"]
    assert summary["flash_launches"] == 0
    assert summary["moe_launches"] == dict.fromkeys(moe.ENTRIES, 0)
    assert summary["prefill_dropped"] >= 0
    assert "MoE entries dropped in prefill" in capsys.readouterr().out


def test_train_loss_refuses_the_hybrid_family():
    """The family trains now (the name is kept from the slice that only
    served it): ``train_loss`` runs on the smoke config period by period,
    records autograd through the SSD scan, the chunked attention and the
    MoE ops, and gives a finite loss, a positive aux loss and a gradient for
    every leaf."""
    cfg = get_smoke_config(ARCH)
    assert "hybrid" in TM.FAMILIES
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    flat = [p.requires_grad_() for p in jax.tree.leaves(params)]
    toks = torch.randint(0, cfg.vocab_size, (1, 16),
                         generator=torch.Generator().manual_seed(1))
    loss, metrics = TM.train_loss(cfg, params, {"tokens": toks,
                                                "targets": toks,
                                                "loss_mask": torch.ones(1, 16)})
    assert loss.requires_grad and torch.isfinite(loss)
    assert float(metrics["aux_loss"]) > 0
    grads = torch.autograd.grad(loss, flat)
    assert all(torch.isfinite(g).all() for g in grads)
    ssm = params["blocks"]["sub0"]["ssm"]
    g, = torch.autograd.grad(TM.train_loss(cfg, params, {
        "tokens": toks, "targets": toks,
        "loss_mask": torch.ones(1, 16)})[0], ssm["w_B"])
    assert float(g.abs().max()) > 0
