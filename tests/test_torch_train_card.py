"""The port's dense training path on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_train_card.py

A smoke training loop on the card that lowers the loss and launches no
flash kernel, and the flash kernel refusing a call that autograd would
record.  (olmo-1b's full-width fp32 step on the card against the CPU, the
loss, every gradient and AdamW's parameters, moments and learning rate, is
``chip_smoke.py``'s: ``train_cpu_check``.)
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The card, for tests that launch the kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


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
