"""The port's dense training path against the JAX package's.

float32 smoke configs of the dense family's four (olmo-1b, qwen2-1.5b,
granite-3-2b, granite-34b), remat off, the JAX parameters of
``init_params(PRNGKey(0))`` carried over with ``params_from_jax``, the
batches of the data pipeline.  Tolerance: rtol 1e-4 (ROADMAP's model
convention), because the two frameworks sum the same float32 products in
another order; an absolute floor of 1e-4 of each leaf's largest entry, as
a gradient's entries near zero have no relative accuracy to keep.  Held:
``train_loss`` and every gradient leaf, one ``adamw.apply``, ``lr_at`` on
the three schedules, ``global_norm`` in the reference's leaf order, int8
compression exactly, the three remat modes' gradients equal, the
counterparts of ``tests/test_system.py``'s loss-reduction and
microbatch-equivalence tests, and the flash kernel refusing autograd.
"""
import dataclasses

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
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = ["olmo-1b", "qwen2-1.5b", "granite-3-2b", "granite-34b"]
RTOL = 1e-4


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", remat="none", **kw)


def _pair(arch, seed=0):
    jcfg = _f32(jax_smoke(arch))
    tcfg = _f32(get_smoke_config(arch))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _batch(cfg, step=0, seq=16, batch=2):
    b = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch), step)
    b["loss_mask"][:, -3:] = 0.0          # a mask that drops some positions
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    floor = 1e-4 * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor,
                               err_msg=what)


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, jb), has_aux=True)(jp)
    tl, tm, tg = TS.loss_and_grads(tcfg, tp, tb)
    _close(tl, jl, "loss")
    _close(tm["lm_loss"], jm["lm_loss"], "lm_loss")
    assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    jgl, tgl = _jleaves(jg), leaves(tg)
    assert len(jgl) == len(tgl) == len(leaves(tp))
    for i, (a, b) in enumerate(zip(tgl, jgl)):
        assert a.shape == b.shape, i
        _close(a, b, f"gradient leaf {i}")
    # the parameters carry no autograd state out of the step
    assert not any(p.requires_grad for p in leaves(tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    """``adamw.apply`` on the same gradients (the reference's, of the
    smoke config's loss), twice, so the second update starts from moments
    that are not zero: the parameters, both moments, the count and the
    metrics, with clipping and weight decay on.  (The gradients themselves
    are held by the test above; a first Adam step divides each gradient by
    its own magnitude, so an entry near zero would turn rounding into a
    different sign.)"""
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
    assert to["count"].dtype == torch.int32 and int(to["count"]) == 2


def test_adamw_split_into_chunks_changes_no_bit(monkeypatch):
    """``adamw.apply`` updates a leaf in runs of rows of at most
    ``CHUNK`` elements: at a CHUNK that splits every leaf of the smoke
    tree (and at one below a row's size), twice, the parameters and both
    moments equal the whole-leaf update's bit for bit."""
    jcfg, tcfg, jp, _ = _pair("qwen2-1.5b")
    jb, _ = _batch(jcfg, step=3)
    jg = jax.grad(lambda p: JM.train_loss(jcfg, p, jb)[0])(jp)
    toc = TA.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                       clip_norm=0.5)
    runs = []
    for chunk in (TA.CHUNK, 96, 5):
        monkeypatch.setattr(TA, "CHUNK", chunk)
        tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
        tg = params_from_jax(tcfg, jax.tree.map(np.asarray, jg))
        to = TA.init(tp)
        for _ in range(2):
            tp, to, _ = TA.apply(toc, tg, to, tp)
        runs.append(leaves(tp) + leaves(to["mu"]) + leaves(to["nu"]))
    assert max(x.numel() for x in runs[0]) > 96
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


def test_lr_schedules_match_jax():
    for schedule in ("cosine", "linear", "constant"):
        oc = JA.OptConfig(lr=3e-3, warmup_steps=7, total_steps=50,
                          schedule=schedule)
        toc = TA.OptConfig(**dataclasses.asdict(oc))
        for step in range(0, 60):
            want = np.asarray(JA.lr_at(oc, jnp.asarray(step, jnp.int32)))
            got = TA.lr_at(toc, torch.tensor(step, dtype=torch.int32))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=f"{schedule} at {step}")


def test_global_norm_sums_leaves_in_the_references_order():
    """Leaves in sorted-key order, an empty dict skipped (olmo's norms)."""
    _, _, jp, tp = _pair("olmo-1b")
    assert tp["final_norm"] == {} and tp["blocks"]["ln1"] == {}
    want = np.asarray(JA.global_norm(jp))
    got = TA.global_norm(tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    order = [x.shape for x in jax.tree.leaves(jp)]
    assert [tuple(x.shape) for x in leaves(tp)] == [tuple(s) for s in order]


def test_int8_compression_is_the_references_exactly():
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(7, 9)).astype(np.float32),
            "b": {"c": (rng.normal(size=33) * 1e-3).astype(np.float32),
                  "half": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0],
                                   np.float32) / 127.0 * 3},
            "s": np.float32(2.5)}
    want = JS.compress_grads_int8(jax.tree.map(jnp.asarray, tree))
    got = TS.compress_grads_int8(
        jax.tree.map(lambda v: torch.tensor(v), tree))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # round half to even, clipped to ±127
    g = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0])
    q = TS.compress_grads_int8({"g": g})["g"] / (127.0 / 127 + 1e-12)
    np.testing.assert_array_equal(q.numpy().round(4), [0, 2, 2, -0, 127])


def test_remat_modes_give_equal_gradients():
    """``none``, ``full`` (the whole layer recomputed) and ``dots`` (the
    matrix products' outputs kept) compute the same arithmetic, so their
    gradients are equal bit for bit on the CPU."""
    _, tcfg, _, tp = _pair("granite-3-2b")
    _, tb = _batch(tcfg, seq=24)
    ref = None
    for mode in ("none", "full", "dots"):
        cfg = dataclasses.replace(tcfg, remat=mode)
        loss, _, grads = TS.loss_and_grads(cfg, tp, tb)
        flat = [loss] + leaves(grads)
        if ref is None:
            ref = flat
            continue
        for a, b in zip(flat, ref):
            assert torch.equal(a, b), mode
    with pytest.raises(ValueError, match="remat"):
        TM.train_loss(dataclasses.replace(tcfg, remat="some"), tp,
                      {k: v for k, v in tb.items()})


def test_training_reduces_loss():
    """The counterpart of ``tests/test_system.py::test_training_reduces_loss``:
    60 steps of the olmo-1b smoke config on the pipeline's structured data
    lower the loss by more than 0.5."""
    cfg = _f32(get_smoke_config("olmo-1b"))
    oc = TA.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    step_fn = TS.make_train_step(cfg, oc)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    opt = TA.init(params)
    losses = []
    for step in range(60):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(data_cfg, step).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_microbatched_step_matches_single_batch():
    """The counterpart of ``tests/test_system.py::
    test_microbatched_step_matches_single_batch``: two microbatches give
    the fused batch's parameters within the reference test's atol 2e-5, and
    the same mean loss."""
    cfg = _f32(get_smoke_config("qwen2-1.5b"))
    oc = TA.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=4)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(data_cfg, 0).items()}
    base = TM.init_params(cfg, torch.Generator().manual_seed(0))
    runs = []
    for n in (1, 2):
        params = TM.init_params(cfg, torch.Generator().manual_seed(0))
        p, _, m = TS.make_train_step(cfg, oc, num_microbatches=n)(
            params, TA.init(params), batch)
        runs.append((p, m))
    (p1, m1), (p2, m2) = runs
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    assert not all(torch.equal(a, b) for a, b in
                   zip(leaves(p1), leaves(base)))   # the step moved them
    with pytest.raises(ValueError, match="microbatches"):
        TS.make_train_step(cfg, oc, num_microbatches=3)(
            base, TA.init(base), batch)


def test_flash_attention_refuses_autograd():
    """The flash kernel is forward only (the reference's has no VJP), so a
    call autograd would record raises instead of dropping q, k and v's
    gradients; without grad it runs (here its plain version)."""
    q = torch.randn(1, 128, 4, 64, requires_grad=True)
    k = torch.randn(1, 128, 2, 64)
    v = torch.randn(1, 128, 2, 64)
    with pytest.raises(RuntimeError, match="forward only"):
        fa_ops.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        out = fa_ops.flash_attention(q, k, v, causal=True)
    assert out.shape == q.shape and not out.requires_grad
    cfg = dataclasses.replace(_f32(get_smoke_config("olmo-1b")),
                              use_kernels=True)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in make_batch(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=1),
        0).items()}
    with pytest.raises(RuntimeError, match="forward only"):
        TS.loss_and_grads(cfg, params, tb)
    assert not any(p.requires_grad for p in leaves(params))
