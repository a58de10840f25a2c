"""The port's MoE family against the JAX package's, on the CPU.

The two smoke MoE configs: qwen2-moe-a2.7b (8 experts, top-4, 2 shared
experts, QKV bias) and granite-moe-1b-a400m (8 experts, top-4, GQA 4:2, tied
embeddings).  On the CPU ``kernels/moe`` takes its plain versions, which the
card's kernel equals bit for bit (``tests/test_torch_moe_card.py``).

* The routing from the reference's own router probabilities: top-k, slots,
  keep flags, source tokens and the dropped count equal exactly, at
  capacity factor 1.25 and at 0.5, where entries drop.
* The plain combine on the reference's intermediates (its expert outputs,
  gates and routing) in bf16 equals the reference's ``moe_apply`` output
  bit for bit, and the descending expert order does not: the order is part
  of the function.
* ``moe_apply``, prefill and decode in float32 at atol = rtol = 1e-4 (the
  tolerance of ``tests/test_torch_model.py``: the two frameworks sum the
  same float32 products in another order).
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
from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.kernels.moe.ref import combine_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"]
TOL = dict(atol=1e-4, rtol=1e-4)
CAPACITY_FACTORS = (1.25, 0.5)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _moe_layer(arch, dtype, cf=1.25):
    """(jax cfg, port cfg, the reference's layer-0 MoE params, the port's
    copy, x (2, 64, d) in ``dtype``)."""
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype,
                               capacity_factor=cf)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               capacity_factor=cf)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    x = np.random.default_rng(5).normal(size=(2, 64, jcfg.d_model))
    return jcfg, tcfg, jp, tp, jnp.asarray(x, dtype)


def _reference_steps(cfg, p, x):
    """The reference's routing and expert outputs for one dispatch group,
    by the lines of ``repro.models.layers.moe_apply`` (``:277-321``)."""
    cdt = jnp.dtype(cfg.dtype)
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    n = b * s
    xg = x.reshape(1, n, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ p["router"], axis=-1)
    gate_vals, top_e = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    cap = min(max(int(np.ceil(n * k / e * cfg.capacity_factor / 8.0)) * 8, 8),
              n)
    flat_e = top_e.reshape(1, n * k)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(e),
                                                  side="left"))(se)
    pos = jnp.arange(n * k)[None, :] - jnp.take_along_axis(first, se, axis=1)
    keep = pos < cap
    slot = jnp.minimum(se * cap + pos, e * cap - 1)
    st = order // k
    gathered = (jnp.take_along_axis(xg, st[..., None], axis=1)
                * keep[..., None]).astype(cdt)
    buf = jax.vmap(lambda bf, sl, gv: bf.at[sl].add(gv))(
        jnp.zeros((1, e * cap, d), cdt), slot, gathered)
    h = buf.reshape(1, e, cap, d)
    hg = jax.nn.silu(jnp.einsum("gecd,edf->gecf", h, p["w_gate"].astype(cdt)))
    hu = jnp.einsum("gecd,edf->gecf", h, p["w_up"].astype(cdt))
    ho = jnp.einsum("gecf,edf->gecd", hg * hu,
                    p["w_down"].swapaxes(-1, -2).astype(cdt))
    return {"probs": probs[0], "top_e": top_e[0], "gates": gate_vals[0],
            "cap": cap, "order": order[0], "keep": keep[0], "slot": slot[0],
            "st": st[0], "ho": ho.reshape(e * cap, d)}


def _bf16_torch(a):
    """A JAX bf16 array as a torch bf16 tensor, bits unchanged."""
    bits = np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def _bits(t):
    return _np(t.contiguous().view(torch.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_equals_reference_exactly(arch):
    for cf in CAPACITY_FACTORS:
        jcfg, tcfg, jp, _, x = _moe_layer(arch, "bfloat16", cf)
        ref = _reference_steps(jcfg, jp, x)
        e, k = jcfg.moe_num_experts, jcfg.moe_top_k
        n = x.shape[0] * x.shape[1]
        cap = moe.capacity(n, k, e, tcfg.capacity_factor)
        assert cap == ref["cap"]
        gates, top_e = torch.topk(torch.tensor(_np(ref["probs"])), k, dim=-1)
        np.testing.assert_array_equal(_np(top_e), _np(ref["top_e"]))
        r = moe.route(top_e, e, cap)
        order = _np(ref["order"])
        keep = _np(ref["keep"])
        np.testing.assert_array_equal(_np(r.slot)[order], _np(ref["slot"]))
        np.testing.assert_array_equal(_np(r.keep)[order], keep)
        rows = np.full(e * cap, -1)
        rows[_np(ref["slot"])[keep]] = order[keep]
        np.testing.assert_array_equal(_np(r.rows), rows)
        np.testing.assert_array_equal(_np(r.rows)[rows >= 0] // k,
                                      _np(ref["st"])[keep])
        n_drop = int((~keep).sum())
        assert int(r.stats[-1]) == n_drop
        assert n_drop > 0 or cf != 0.5          # 0.5 must drop entries
        np.testing.assert_array_equal(_np(r.dropped)[:n_drop],
                                      np.sort(order[~keep]))
        assert (_np(r.dropped)[n_drop:] == -1).all()
        np.testing.assert_array_equal(
            _np(r.stats)[:-1], np.bincount(_np(ref["top_e"]).ravel(),
                                           minlength=e))
        # distinct experts at a capacity of every token: nothing can drop,
        # and the routing says so (the dispatch skips its non-finite pass)
        roomy = moe.route(top_e, e, n, distinct=True)
        assert r.may_drop and not roomy.may_drop
        assert int(roomy.stats[-1]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_combine_is_the_reference_bf16_output(arch):
    """The plain combine on the reference's expert outputs, gates and
    routing, plus the reference's shared MLP, against ``moe_apply`` bit for
    bit in bf16 (with drops, at 0.5); summing each token's terms in
    descending expert order instead differs."""
    differs = []
    for cf in CAPACITY_FACTORS:
        jcfg, _, jp, _, x = _moe_layer(arch, "bfloat16", cf)
        ref = _reference_steps(jcfg, jp, x)
        want, _ = JL.moe_apply(jcfg, jp, x)
        n, d = x.shape[0] * x.shape[1], x.shape[2]
        r = moe.route(torch.tensor(_np(ref["top_e"])), jcfg.moe_num_experts,
                      ref["cap"])
        gates = torch.tensor(_np(ref["gates"]))
        ho = _bf16_torch(ref["ho"])
        got = combine_ref(ho, r, gates)
        flipped = _descending_combine(ho, r, gates)
        if jcfg.moe_num_shared:
            shared = _bf16_torch(JL.mlp_apply(jcfg, jp["shared"],
                                              x.reshape(n, d)))
            got, flipped = got + shared, flipped + shared
        want = _bf16_torch(want.reshape(n, d))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        differs.append(int((_bits(flipped) != _bits(want)).sum()))
    assert min(differs) > 0, differs


def _descending_combine(ho, r, gates):
    n, k = r.top_e.shape
    order = torch.sort(r.top_e, dim=1, descending=True).indices
    slot = r.slot.view(n, k).gather(1, order).long()
    w = (gates.gather(1, order) * r.keep.view(n, k).gather(1, order)
         ).to(ho.dtype)
    acc = torch.zeros((n, ho.shape[1]), dtype=ho.dtype)
    for j in range(k):
        acc = acc + ho[slot[:, j]] * w[:, j, None]
    return acc


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference_in_float32(arch):
    for cf in CAPACITY_FACTORS:
        jcfg, tcfg, jp, tp, x = _moe_layer(arch, "float32", cf)
        jout, jaux = JL.moe_apply(jcfg, jp, x)
        moe.reset_launch_count()
        tout, routed = TL.moe_apply(tcfg, tp, torch.tensor(_np(x)))
        taux = TL.moe_aux_loss(tcfg, routed)
        assert moe.launch_count() == 0      # CPU tensors: the plain versions
        np.testing.assert_allclose(_np(tout), _np(jout), **TOL)
        np.testing.assert_allclose(float(taux), float(jaux), **TOL)


def _pair(arch):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32", remat="none")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat="none")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    B, S, MAX = 2, 16, 24
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        JM.init_cache(jcfg, B, MAX))
    drops = []
    tl, tc = TM.prefill(tcfg, tparams, torch.as_tensor(toks),
                        TM.init_cache(tcfg, B, MAX, "cpu"), drops)
    assert len(drops) == tcfg.num_layers
    print(f"{arch}: prefill dropped {int(sum(drops))} entries")
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   _np(jc["layers"][key]), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   _np(jc["layers"][key]), **TOL)


def test_param_shapes_fan_in_and_conversion():
    """``param_shapes`` is the reference's tree for both configs, smoke and
    full (the full one by ``jax.eval_shape``, nothing allocated); the port's
    init scales each ``w_down`` by its own MLP's width and keeps the router
    float32; ``params_from_jax`` round-trips with the router float32."""
    for arch in ARCHS:
        for jget, tget in ((jax_smoke, get_smoke_config),
                           (jax_config, get_config)):
            jcfg, tcfg = jget(arch), tget(arch)
            tree = jax.eval_shape(lambda: JM.init_params(
                jcfg, jax.random.PRNGKey(0)))
            want = jax.tree.map(lambda a: tuple(a.shape), tree)
            assert TM.param_shapes(tcfg) == want
        jcfg, tcfg, jparams, tparams = _pair(arch)
        back = jax.tree.map(np.asarray, jparams)
        flat_t = jax.tree_util.tree_leaves_with_path(tparams)
        flat_j = dict(jax.tree_util.tree_leaves_with_path(back))
        for path, leaf in flat_t:
            np.testing.assert_array_equal(_np(leaf), flat_j[path])
        assert tparams["blocks"]["moe"]["router"].dtype == torch.float32
        half = dataclasses.replace(tcfg, param_dtype="bfloat16")
        conv = params_from_jax(half, back)
        assert conv["blocks"]["moe"]["router"].dtype == torch.float32
        assert conv["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
        init = TM.init_params(half, torch.Generator().manual_seed(0))
        moe_p = init["blocks"]["moe"]
        assert moe_p["router"].dtype == torch.float32
        f = tcfg.moe_ff
        assert abs(moe_p["w_down"].float().std().item() * f ** 0.5 - 1) < 0.05
        if tcfg.moe_num_shared:
            fs = f * tcfg.moe_num_shared
            sd = moe_p["shared"]["w_down"].float().std().item()
            assert abs(sd * fs ** 0.5 - 1) < 0.05


def test_serving_init_leaf_by_leaf_equals_cast_of_full_init():
    for arch in ARCHS + ["qwen2-1.5b"]:
        cfg = get_smoke_config(arch)
        want = TM.serving_params(cfg, TM.init_params(
            cfg, torch.Generator().manual_seed(3)))
        got = TM.init_serving_params(cfg, torch.Generator().manual_seed(3))
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for path, leaf in flat_w:
            assert flat_g[path].dtype == leaf.dtype, path
            assert torch.equal(flat_g[path], leaf), path
        if cfg.family == "moe":
            assert got["blocks"]["moe"]["router"].dtype == torch.float32
            assert got["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_family_on_the_cpu(arch):
    moe.reset_launch_count()
    summary = serve.main(["--arch", arch, "--smoke", "--requests", "4",
                          "--batch", "2", "--prompt", "32", "--gen", "4"],
                         device="cpu")
    assert summary["tokens"] == 16 and summary["logits_finite"]
    assert summary["moe_launches"] == dict.fromkeys(moe.ENTRIES, 0)
    assert set(moe.ENTRIES) == {"route", "dispatch", "combine",
                                "combine_grad", "gate_grad"}
    assert summary["flash_launches"] == 0
    assert summary["prefill_dropped"] >= 0


def test_train_loss_refuses_moe_and_the_wrapper_is_forward_only():
    """Under its earlier name, the opposite of what it once held:
    ``train_loss`` accepts the MoE family, and ``moe.dispatch`` /
    ``moe.combine`` record autograd on the CPU (their plain backward: each
    token's kept rows summed into x's gradient, the gate's weight into
    ho's, ho's row into the gate's); without grad they record nothing.
    ``tests/test_torch_moe_train.py`` holds the gradients to the
    reference."""
    cfg = get_smoke_config("granite-moe-1b-a400m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.long)
    batch = {"tokens": toks, "targets": toks, "loss_mask": torch.ones(1, 8)}
    assert "moe" in TM.FAMILIES
    loss, metrics = TM.train_loss(cfg, params, batch)
    assert bool(torch.isfinite(loss)) and float(metrics["aux_loss"]) > 0
    r = moe.route(torch.tensor([[0, 1], [1, 0]]), 2, 2)
    x = torch.ones((2, 8), requires_grad=True)
    buf = moe.dispatch(x, r)
    assert buf.requires_grad and buf.shape == (4, 8)
    buf.sum().backward()
    assert torch.equal(x.grad, torch.full((2, 8), 2.0))
    ho = torch.arange(32.0).view(4, 8).requires_grad_()
    gates = torch.tensor([[0.25, 0.75], [0.5, 0.5]], requires_grad=True)
    moe.combine(ho, r, gates).sum().backward()
    rows = torch.tensor([0, 2, 3, 1])          # entry i's slot
    assert torch.equal(ho.grad[rows], gates.detach().reshape(4, 1).expand(
        4, 8))
    assert torch.equal(gates.grad.reshape(-1), ho.detach()[rows].sum(1))
    with torch.no_grad():
        assert not moe.dispatch(x, r).requires_grad
    # the reference's capacities at the full configs' serving shapes
    assert moe.capacity(2048, 4, 60, 1.25) == 176
    assert moe.capacity(2048, 8, 32, 1.25) == 640
    assert moe.capacity(4, 4, 60, 1.25) == moe.capacity(4, 8, 32, 1.25) == 4
