"""The port's dense training path on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_train_card.py

One training step of olmo-1b at its full width (2 of its 16 layers, batch
2 x 512) in float32 with TF32 off on the card against the same step on the
CPU from the same parameters: the loss, grad norm and every gradient, then
AdamW's parameters and moments on the same gradients, at rtol 1e-4 (an
absolute floor of 1e-4 of each leaf's largest entry, as
``tests/test_torch_train.py``); a smoke training loop on the card that
lowers the loss and launches no flash kernel; and the flash kernel
refusing a call that autograd would record.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.card

RTOL = 1e-4


@pytest.fixture
def card():
    """The card, for tests that launch the kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(a, b, what):
    a = a.cpu()
    floor = 1e-4 * b.abs().max().item()
    assert bool(((a - b).abs() <= floor + RTOL * b.abs()).all()), \
        (what, tuple(b.shape), (a - b).abs().max().item())


def test_full_width_fp32_step_matches_the_cpu(card):
    """The step in its two parts: the loss, grad norm and every gradient on
    the card against the CPU from the same parameters, then AdamW on the
    same gradients on both.  (A first Adam step divides each gradient by
    its own magnitude, so gradients that differ by rounding move a
    parameter whose gradient is near Adam's eps by up to the step size.)"""
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2,
                              dtype="float32")
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=512,
                                  global_batch=2), 0)
    cpu = torch.device("cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p_cpu = LT.init_state(cfg, cpu)["params"]
        p_card = tree_map(lambda t: t.to(card, copy=True), p_cpu)
        l_card, _, g_card = TS.batch_grads(cfg, p_card,
                                           LT.batch_on(batch, card))
        l_cpu, _, g_cpu = TS.batch_grads(cfg, p_cpu, LT.batch_on(batch, cpu))
        assert float(l_card) == pytest.approx(float(l_cpu), rel=RTOL)
        assert float(adamw.global_norm(g_card)) == pytest.approx(
            float(adamw.global_norm(g_cpu)), rel=RTOL)
        for a, b in zip(leaves(g_card), leaves(g_cpu)):
            _close(a, b, "gradient")
        g_same = tree_map(lambda t: t.to(card), g_cpu)
        _, o_card, m_card = adamw.apply(oc, g_same, adamw.init(p_card), p_card)
        _, o_cpu, m_cpu = adamw.apply(oc, g_cpu, adamw.init(p_cpu), p_cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert float(m_card["lr"]) == pytest.approx(float(m_cpu["lr"]), rel=RTOL)
    for a, b in zip(leaves({"p": p_card, "mu": o_card["mu"],
                            "nu": o_card["nu"]}),
                    leaves({"p": p_cpu, "mu": o_cpu["mu"],
                            "nu": o_cpu["nu"]})):
        _close(a, b, "updated state")


def test_smoke_training_loop_on_the_card(card):
    """60 steps of the olmo-1b smoke config in float32 on the card lower the
    loss by more than 0.5, as ``tests/test_system.py`` asks of the
    reference, with no flash launch (training takes the chunked
    attention)."""
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32",
                              remat="none")
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60)
    one_step = LT.make_step(cfg, oc, card)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                          global_batch=4)
    state = LT.init_state(cfg, card)
    fa.reset_launch_count()
    losses = []
    for step in range(60):
        state, metrics = one_step(state, make_batch(data_cfg, step))
        losses.append(float(metrics["loss"]))
    assert fa.launch_count() == 0
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert all(p.device.type == "cuda" for p in leaves(state))


def test_flash_attention_refuses_autograd_on_the_card(card):
    q = torch.randn(1, 256, 4, 64, device=card, requires_grad=True)
    k = torch.randn(1, 256, 2, 64, device=card)
    v = torch.randn(1, 256, 2, 64, device=card)
    fa.reset_launch_count()
    with pytest.raises(RuntimeError, match="forward only"):
        fa_ops.flash_attention(q, k, v, causal=True)
    assert fa.launch_count() == 0
    with torch.no_grad():
        out = fa_ops.flash_attention(q, k, v, causal=True)
    assert fa.launch_count() == 1 and out.shape == q.shape
