"""The port's SSM and hybrid training paths against the JAX package's, on
the CPU.

The smoke configs of mamba2-130m (2 SSM layers, chunk 8) and
jamba-v0.1-52b (one period of 4 sub-layers: SSM, SSM + MoE, attention, SSM
+ MoE), float32, remat off unless said, the JAX parameters of
``init_params(PRNGKey(0))`` carried over with ``params_from_jax``, the data
pipeline's batches.  On the CPU ``kernels/ssd`` and ``kernels/moe`` take
their plain versions, forward and backward, which the card's kernels are
held to (``tests/test_torch_ssd_card.py``, ``tests/test_torch_moe_card.py``).

Held, at rtol 1e-4 with an absolute floor of 1e-4 of each leaf's largest
entry (``tests/test_torch_train.py::_close``):

* ``train_loss``, ``lm_loss``, ``aux_loss`` and every gradient leaf against
  ``jax.value_and_grad`` of the reference's ``train_loss`` (mamba2-130m;
  jamba at capacity 1.25 and 0.5, where entries drop);
* ``adamw.apply`` twice on the reference's gradients;
* remat ``none`` / ``full`` / ``dots`` giving bit-equal gradients (the
  scan's per-chunk states from remat's recompute);
* 60 smoke steps lowering the loss; 2 microbatches against the whole batch
  within 2e-5 (jamba at a capacity of every token, the aux weight 0);
* ``launch.train --arch ... --smoke --device cpu`` for both.
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_train import _close, _jleaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SSM, HYBRID = "mamba2-130m", "jamba-v0.1-52b"
ARCHS = [SSM, HYBRID]
MICRO_ATOL = 2e-5


def _pair(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32", remat="none",
                               **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat="none", **kw)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _batch(cfg, step=0, seq=32, batch=2):
    b = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch), step)
    b["loss_mask"][:, -3:] = 0.0          # a mask that drops some positions
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("arch,cf", [(SSM, None), (HYBRID, 1.25),
                                     (HYBRID, 0.5)])
def test_train_loss_and_every_gradient_match_jax(arch, cf):
    """The loss, its parts and every gradient leaf; S = 32 is four chunks
    of 8 (the scan's reverse pass over chunks), and the hybrid's period
    holds each kind of sub-layer."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg, jp, tp = _pair(arch, **kw)
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.train_loss(jcfg, p, jb), has_aux=True)(jp)
    ssd.reset_launch_count()
    moe.reset_launch_count()
    tl, tm, tg = TS.loss_and_grads(tcfg, tp, tb)
    assert ssd.launch_count() == moe.launch_count() == 0   # the plain versions
    _close(tl, jl, "loss")
    _close(tm["lm_loss"], jm["lm_loss"], "lm_loss")
    _close(tm["aux_loss"], jm["aux_loss"], "aux_loss")
    assert (float(tm["aux_loss"]) > 0) == (arch == HYBRID)
    jgl, tgl = _jleaves(jg), leaves(tg)
    assert len(jgl) == len(tgl) == len(leaves(tp))
    for i, (a, b) in enumerate(zip(tgl, jgl)):
        assert a.shape == b.shape, i
        _close(a, b, f"{arch} cf {cf}: gradient leaf {i}")
    assert not any(p.requires_grad for p in leaves(tp))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_jax(arch):
    """``adamw.apply`` twice on the reference's gradients: the parameters
    (the SSM's fp32 ``A_log``, ``D`` and ``dt_bias`` among them), both
    moments and the metrics, with clipping and weight decay on."""
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
    """``none``, ``full`` (the layer, or the hybrid's period, recomputed in
    the backward pass: the scan runs again and its backward takes the
    recomputed per-chunk states) and ``dots`` compute the same arithmetic,
    so the loss, the aux loss and every gradient are equal bit for bit
    (jamba at capacity 0.5, entries dropping)."""
    for arch, kw in ((SSM, {}), (HYBRID, {"capacity_factor": 0.5})):
        _, tcfg, _, tp = _pair(arch, **kw)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_training_reduces_loss(arch):
    """60 steps of the smoke config on the pipeline's structured data lower
    the loss by more than 0.5, every loss finite."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
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
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_two_microbatches_match_the_whole_batch():
    """2 microbatches against one whole batch: the loss and every summed
    gradient within 2e-5 (mamba2-130m; jamba at a capacity of every token
    with the aux weight 0, where the routing does not depend on the batch
    and the Switch loss, a product of batch means, is off)."""
    for arch, kw in ((SSM, {}), (HYBRID, {"router_aux_weight": 0.0})):
        if arch == HYBRID:
            base = get_smoke_config(arch)
            kw["capacity_factor"] = base.moe_num_experts / base.moe_top_k
        _, tcfg, _, tp = _pair(arch, **kw)
        _, tb = _batch(tcfg, seq=32, batch=4)
        l1, _, g1 = TS.batch_grads(tcfg, tp, tb, 1)
        l2, _, g2 = TS.batch_grads(tcfg, tp, tb, 2)
        np.testing.assert_allclose(float(l2), float(l1), rtol=0,
                                   atol=MICRO_ATOL)
        for i, (a, b) in enumerate(zip(leaves(g2), leaves(g1))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=MICRO_ATOL,
                                       err_msg=f"{arch} gradient leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_smoke_on_the_cpu(arch):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --device
    cpu`` trains and lowers the loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "30", "--batch", "4",
         "--seq", "32", "--log-every", "10"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0], out.stdout
