"""The port's MoE training path against the JAX package's, on the CPU.

The two smoke MoE configs (qwen2-moe-a2.7b with 2 shared experts and QKV
bias, granite-moe-1b-a400m with GQA and a tied head), float32, remat off,
the JAX parameters of ``init_params(PRNGKey(0))`` carried over with
``params_from_jax``, the data pipeline's batches.  On the CPU
``kernels/moe`` takes its plain versions, forward and backward, which the
card's kernels equal bit for bit (``tests/test_torch_moe_card.py``).

Held, at rtol 1e-4 with an absolute floor of 1e-4 of each leaf's largest
entry (``tests/test_torch_train.py::_close``: the two frameworks sum the
same float32 products in another order):

* ``train_loss``, ``lm_loss``, ``aux_loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``train_loss``, at capacity
  factor 1.25 and at 0.5, where entries drop;
* ``adamw.apply`` twice on the reference's gradients;
* remat ``none`` / ``full`` / ``dots`` giving bit-equal gradients;
* the 2-microbatch step against the reference's 2-microbatch step (the
  capacity follows each microbatch's tokens, so a step on two microbatches
  is not the step on one batch where something drops), and 2 equal to 1
  where nothing drops;
* 60 smoke steps lowering the loss; ``launch.train --smoke --device cpu``;
* in bf16 on the reference's own routing: the dispatch's cotangent for x,
  the combine's for the experts' outputs and the combine's for the gates
  bit for bit against ``jax.vjp`` of the reference's lines (the gates'
  sum in XLA:CPU's windows of 32, ``ref.xla_row_sum``; ROADMAP C7, closed)
  at the smoke width and at both MoE configs' widths, 1024 and 2048; the
  gates' in fp32 and at widths that are not a multiple of 32 too;
* the plain backward against autograd through the plain forward, NaN
  through dropped entries included.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.moe import moe, ref  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_moe import (_bf16_torch, _bits, _moe_layer,  # noqa: E402
                            _np, _reference_steps)
from test_torch_train import _close, _jleaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"]
CAPACITY_FACTORS = (1.25, 0.5)
#: the model width of each MoE config, where the bf16 gate cotangent is
#: also checked (besides the smoke width)
WIDTH = {"qwen2-moe-a2.7b": 2048, "granite-moe-1b-a400m": 1024}


def _pair(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32", remat="none",
                               **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat="none", **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _batch(cfg, step=0, seq=16, batch=2):
    b = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch), step)
    b["loss_mask"][:, -3:] = 0.0          # a mask that drops some positions
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _drops(tcfg, tp, tb):
    """Entries the port's forward drops, summed over the layers."""
    seen, apply = [], TM.L.moe_apply

    def watch(cfg, p, x):
        out, (probs, r) = apply(cfg, p, x)
        seen.append(int(r.stats[-1]))
        return out, (probs, r)

    TM.L.moe_apply = watch
    try:
        TM.train_loss(tcfg, tp, tb)
    finally:
        TM.L.moe_apply = apply
    return sum(seen)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    for cf in CAPACITY_FACTORS:
        jcfg, tcfg, jp, tp = _pair(arch, capacity_factor=cf)
        jb, tb = _batch(jcfg, seq=32)
        (jl, jm), jg = jax.value_and_grad(
            lambda p: JM.train_loss(jcfg, p, jb), has_aux=True)(jp)
        moe.reset_launch_count()
        tl, tm, tg = TS.loss_and_grads(tcfg, tp, tb)
        assert moe.launch_count() == 0          # CPU: the plain versions
        _close(tl, jl, "loss")
        _close(tm["lm_loss"], jm["lm_loss"], "lm_loss")
        _close(tm["aux_loss"], jm["aux_loss"], "aux_loss")
        assert float(tm["aux_loss"]) > 0
        jgl, tgl = _jleaves(jg), leaves(tg)
        assert len(jgl) == len(tgl) == len(leaves(tp))
        for i, (a, b) in enumerate(zip(tgl, jgl)):
            assert a.shape == b.shape, i
            _close(a, b, f"cf {cf}: gradient leaf {i}")
        assert not any(p.requires_grad for p in leaves(tp))
        if cf == 0.5:
            assert _drops(tcfg, tp, tb) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    """``adamw.apply`` twice on the reference's gradients of the MoE loss:
    the parameters (router and experts among them), both moments and the
    metrics, with clipping and weight decay on."""
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, _ = _batch(jcfg, step=3)
    oc = JA.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=0.5)
    toc = TA.OptConfig(**dataclasses.asdict(oc))
    jg = jax.grad(lambda p: JM.train_loss(jcfg, p, jb)[0])(jp)
    tg = params_from_jax(tcfg, jax.tree.map(np.asarray, jg))
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


def test_remat_modes_give_equal_gradients():
    """``none``, ``full`` (the layer recomputed: route, dispatch and
    combine run again) and ``dots`` compute the same arithmetic, so the
    loss, the aux loss and every gradient are equal bit for bit, with
    entries dropping (capacity 0.5)."""
    for arch in ARCHS:
        _, tcfg, _, tp = _pair(arch, capacity_factor=0.5)
        _, tb = _batch(tcfg, seq=24)
        want = None
        for mode in ("none", "full", "dots"):
            cfg = dataclasses.replace(tcfg, remat=mode)
            loss, metrics, grads = TS.loss_and_grads(cfg, tp, tb)
            flat = [loss, metrics["aux_loss"]] + leaves(grads)
            if want is None:
                want = flat
                continue
            for i, (a, b) in enumerate(zip(flat, want)):
                assert torch.equal(a, b), (arch, mode, i)


def test_two_microbatches_match_the_references_two_microbatch_step():
    """One step on 2 microbatches against the reference's
    ``make_train_step(num_microbatches=2)``, at capacity 0.5 (each
    microbatch routes its own 64 tokens, and entries drop): the loss, the
    last microbatch's ``lm_loss`` and ``aux_loss``, the grad norm, and the
    first moment, (1 - b1) times the summed gradients, leaf by leaf."""
    for arch in ARCHS:
        jcfg, tcfg, jp, tp = _pair(arch, capacity_factor=0.5)
        jb, tb = _batch(jcfg, seq=32, batch=4)
        oc = JA.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10,
                          clip_norm=1e9)
        toc = TA.OptConfig(**dataclasses.asdict(oc))
        _, jo, jmet = JS.make_train_step(jcfg, oc, num_microbatches=2)(
            jp, JA.init(jp), jb)
        _, to, tmet = TS.make_train_step(tcfg, toc, num_microbatches=2)(
            tp, TA.init(tp), tb)
        for key in ("loss", "lm_loss", "aux_loss", "grad_norm"):
            _close(tmet[key], jmet[key], f"{arch} {key}")
        for i, (a, b) in enumerate(zip(leaves(to["mu"]), _jleaves(jo["mu"]))):
            _close(a, b, f"{arch} mu leaf {i}")
        half = {key: v[:2] for key, v in tb.items()}
        assert _drops(tcfg, tp, half) > 0


def test_two_microbatches_equal_one_where_nothing_drops():
    """At capacity factor E / k every expert holds every token, and with
    the aux weight at 0 (the Switch loss is a product of two batch means,
    so it is no mean over microbatches) the 2-microbatch gradients are the
    whole batch's, to float32 summation."""
    for arch in ARCHS:
        base = get_smoke_config(arch)
        _, tcfg, _, tp = _pair(arch, router_aux_weight=0.0,
                               capacity_factor=base.moe_num_experts
                               / base.moe_top_k)
        _, tb = _batch(tcfg, seq=32, batch=4)
        assert _drops(tcfg, tp, tb) == 0
        l1, _, g1 = TS.batch_grads(tcfg, tp, tb, 1)
        l2, _, g2 = TS.batch_grads(tcfg, tp, tb, 2)
        _close(l2, l1, f"{arch} loss")
        for i, (a, b) in enumerate(zip(leaves(g2), leaves(g1))):
            _close(a, b, f"{arch} gradient leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_training_reduces_loss(arch):
    """60 steps of the smoke config on the pipeline's structured data lower
    the loss by more than 0.5, the aux loss finite throughout."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    oc = TA.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = TS.make_train_step(cfg, oc)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TA.init(params)
    losses, aux = [], []
    for step in range(60):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(data_cfg, step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all(np.isfinite(aux)) and min(aux) > 0


def _reference_vjps(jcfg, jp, x, seed):
    """The reference's routing and, by ``jax.vjp`` of its dispatch and
    combine lines (``layers.py:305-308``, ``:320-323``), the cotangents for
    x, ho and the gates of random bf16 cotangents."""
    ref_steps = _reference_steps(jcfg, jp, x)
    e, k = jcfg.moe_num_experts, jcfg.moe_top_k
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    ecap, cdt = e * ref_steps["cap"], jnp.dtype(jcfg.dtype)
    st, slot = ref_steps["st"][None], ref_steps["slot"][None]
    keep, order = ref_steps["keep"][None], ref_steps["order"][None]

    def disp(xg):
        g = (jnp.take_along_axis(xg, st[..., None], axis=1)
             * keep[..., None]).astype(cdt)
        return jax.vmap(lambda bf, sl, gv: bf.at[sl].add(gv))(
            jnp.zeros((1, ecap, d), cdt), slot, g)

    def comb(ho, gates):
        sg = jnp.take_along_axis(gates.reshape(1, n * k), order, axis=1)
        back = (jnp.take_along_axis(ho, slot[..., None], axis=1)
                * (sg * keep).astype(cdt)[..., None])
        return jax.vmap(lambda o, tt, bb: o.at[tt].add(bb))(
            jnp.zeros((1, n, d), cdt), st, back)

    rng = np.random.default_rng(seed)
    dbuf = jnp.asarray(rng.normal(size=(1, ecap, d)), cdt)
    dout = jnp.asarray(rng.normal(size=(1, n, d)), cdt)
    (dx,) = jax.vjp(disp, x.reshape(1, n, d))[1](dbuf)
    dho, dg = jax.vjp(comb, ref_steps["ho"][None], ref_steps["gates"])[1](dout)
    return ref_steps, {"dbuf": dbuf[0], "dout": dout[0], "dx": dx[0],
                       "dho": dho[0], "dg": np.asarray(dg, np.float32)}


def _moe_layer_at(arch, dtype, cf, d):
    """:func:`test_torch_moe._moe_layer` at model width ``d`` (None: the
    smoke config's): (jax cfg, the layer-0 MoE params, x (2, 64, d))."""
    if d is None:
        jcfg, _, jp, _, x = _moe_layer(arch, dtype, cf)
        return jcfg, jp, x
    jcfg = dataclasses.replace(jax_smoke(arch), dtype=dtype,
                               capacity_factor=cf, d_model=d)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = np.random.default_rng(5).normal(size=(2, 64, d))
    return jcfg, jp, jnp.asarray(x, dtype)


def _gate_bits_equal(arch, dtype, cf, d):
    """``ref.gate_grad_ref`` (what ``moe.gate_grad`` runs on the CPU; the
    card's kernel equals it bit for bit) on the reference's routing and
    expert outputs against ``jax.vjp`` of its combine, bit for bit; the
    number of dropped entries."""
    jcfg, jp, x = _moe_layer_at(arch, dtype, cf, d)
    steps, v = _reference_vjps(jcfg, jp, x, seed=3)
    r = ref.route_ref(torch.tensor(_np(steps["top_e"])),
                      jcfg.moe_num_experts, steps["cap"])
    if dtype == "bfloat16":
        dout, ho = _bf16_torch(v["dout"]), _bf16_torch(steps["ho"])
    else:
        dout = torch.tensor(np.asarray(v["dout"]))
        ho = torch.tensor(np.asarray(steps["ho"]))
    dg = ref.gate_grad_ref(dout, ho, r)
    np.testing.assert_array_equal(_np(dg.view(torch.int32)),
                                  v["dg"].view(np.int32))
    return int(r.stats[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_backward_against_the_references_vjp(arch):
    """On the reference's routing and expert outputs in bf16: the plain
    dispatch_grad (the combine with unit gates), combine_grad and gate_grad
    equal the reference's VJP bit for bit (+0 where its scatter-add into
    zeros gives +0), at capacity 1.25 and 0.5; gate_grad also at the
    config's own model width (:data:`WIDTH`: 2048 and 1024)."""
    for cf in CAPACITY_FACTORS:
        jcfg, _, jp, _, x = _moe_layer(arch, "bfloat16", cf)
        steps, v = _reference_vjps(jcfg, jp, x, seed=3)
        r = moe.route(torch.tensor(_np(steps["top_e"])), jcfg.moe_num_experts,
                      steps["cap"])
        assert (int(r.stats[-1]) > 0) == (cf == 0.5)
        gates = torch.tensor(_np(steps["gates"]))
        dout, ho = _bf16_torch(v["dout"]), _bf16_torch(steps["ho"])
        dx = moe.dispatch_grad(_bf16_torch(v["dbuf"]), r)
        np.testing.assert_array_equal(_bits(dx), _bits(_bf16_torch(v["dx"])))
        dho = moe.combine_grad(dout, r, gates)
        np.testing.assert_array_equal(_bits(dho), _bits(_bf16_torch(v["dho"])))
        dg = moe.gate_grad(dout, ho, r)
        np.testing.assert_array_equal(_np(dg.view(torch.int32)),
                                      v["dg"].view(np.int32))
        dropped = _gate_bits_equal(arch, "bfloat16", cf, WIDTH[arch])
        assert (dropped > 0) == (cf == 0.5)


def test_gate_grad_in_fp32_and_ragged_widths_against_the_references_vjp():
    """gate_grad's plain version bit for bit against ``jax.vjp`` in fp32
    (XLA:CPU's program has the same windows of 32 there, its adds in fp32)
    at the smoke width, 1024 and 2048, and at widths that are not a
    multiple of 32 (XLA pads the windows, ``pad // 2`` zeros in front:
    1001 and 1000 one level, 4100 two levels), with entries dropped."""
    arch = "granite-moe-1b-a400m"
    for dtype, d in (("float32", None), ("float32", 1024), ("float32", 2048),
                     ("bfloat16", 1001), ("bfloat16", 4100),
                     ("float32", 1000)):
        assert _gate_bits_equal(arch, dtype, 0.5, d) > 0


def test_plain_backward_against_autograd_of_the_plain_forward():
    """In fp32 with entries dropped (capacity 0.5), the plain backward
    against torch's autograd through ``dispatch_ref`` / ``combine_ref``
    (sums of 4-32 float32 terms in two orders: rtol 1e-5); then NaN: a
    non-finite dout at a token whose dropped entry's slot is a row turns
    that row of dho NaN (``dout · 0``), and a NaN in ho under a dropped
    entry turns its gate's cotangent NaN, as autograd gives; a NaN in dbuf
    at a dropped entry's slot reaches dx (the reference's ``x · keep`` has
    that term, which ``dispatch_ref``'s index writes have not), as
    ``jax.vjp`` of the reference's dispatch gives."""
    rng = np.random.default_rng(11)
    n, e, k, d = 96, 8, 4, 32
    logits = torch.from_numpy(rng.normal(size=(n, e))).float()
    probs = torch.softmax(logits, -1)
    gates, top_e = torch.topk(probs, k, dim=-1)
    cap = moe.capacity(n, k, e, 0.5)
    r = moe.route(top_e, e, cap)
    drop = r.dropped[r.dropped >= 0].long()
    assert drop.numel() > 0
    x = torch.from_numpy(rng.normal(size=(n, d))).float().requires_grad_()
    ho = torch.from_numpy(rng.normal(size=(e * cap, d))).float()
    ho.requires_grad_()
    g = gates.clone().requires_grad_()
    dbuf = torch.from_numpy(rng.normal(size=(e * cap, d))).float()
    dout = torch.from_numpy(rng.normal(size=(n, d))).float()
    want_x, = torch.autograd.grad(ref.dispatch_ref(x, r), x, dbuf)
    want_ho, want_g = torch.autograd.grad(ref.combine_ref(ho, r, g), (ho, g),
                                          dout)
    got_x, = torch.autograd.grad(moe.dispatch(x, r), x, dbuf)
    got_ho, got_g = torch.autograd.grad(moe.combine(ho, r, g), (ho, g), dout)
    for got, want in ((got_x, want_x), (got_ho, want_ho), (got_g, want_g)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

    bad_tok = drop[:3] // k
    dout[bad_tok, 5] = float("inf")
    ho.data[r.slot[drop[3:6]].long(), 7] = float("nan")
    want_ho, want_g = torch.autograd.grad(ref.combine_ref(ho, r, g), (ho, g),
                                          dout)
    got_ho, got_g = torch.autograd.grad(moe.combine(ho, r, g), (ho, g), dout)
    assert bool(torch.isnan(got_ho[r.slot[drop[:3]].long(), 5]).all())
    assert bool(torch.isnan(got_g.view(-1)[drop[3:6]]).all())
    for got, want in ((got_ho, want_ho), (got_g, want_g)):
        np.testing.assert_array_equal(torch.isnan(got).numpy(),
                                      torch.isnan(want).numpy())
        ok = ~torch.isnan(want)
        np.testing.assert_allclose(got[ok].numpy(), want[ok].numpy(),
                                   rtol=1e-5, atol=1e-5)

    dbuf[r.slot[drop[:2]].long(), 9] = float("nan")
    got_x, = torch.autograd.grad(moe.dispatch(x, r), x, dbuf)
    order = torch.argsort(r.top_e.reshape(-1), stable=True)
    st = (order // k).numpy()[None]
    keep = r.keep.reshape(-1)[order].numpy()[None]
    slot = r.slot.reshape(-1)[order].numpy()[None]

    def disp(xg):
        gathered = jnp.take_along_axis(xg, st[..., None], axis=1) \
            * keep[..., None]
        return jax.vmap(lambda bf, sl, gv: bf.at[sl].add(gv))(
            jnp.zeros((1, e * cap, d)), slot, gathered)

    (jdx,) = jax.vjp(disp, jnp.asarray(x.detach().numpy())[None])[1](
        jnp.asarray(dbuf.numpy())[None])
    jdx = np.asarray(jdx[0])
    np.testing.assert_array_equal(torch.isnan(got_x).numpy(), np.isnan(jdx))
    assert np.isnan(jdx[(drop[:2] // k).numpy(), 9]).all()
    ok = ~np.isnan(jdx)
    np.testing.assert_allclose(got_x.numpy()[ok], jdx[ok], rtol=1e-5,
                               atol=1e-5)


def test_launch_train_moe_smoke_on_the_cpu():
    """``python -m repro_torch.launch.train --arch granite-moe-1b-a400m
    --smoke --device cpu`` trains and lowers the loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--steps",
         "30", "--batch", "4", "--seq", "32", "--log-every", "10"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0], out.stdout
