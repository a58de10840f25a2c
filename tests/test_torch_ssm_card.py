"""The hybrid family's kernel path against its plain path, on the card.

jamba-v0.1-52b's smoke config with 64-wide attention heads (the flash
kernels take heads of 64 and 128), served in bf16 and fp32 with the kernels
on: a prefill of 2 x 128 tokens and three decode steps through the flash
kernel and ``moe_sm90.cu``, against the same with ``layers.moe_ops`` bound
to the MoE's plain versions, bit for bit (logits and every cache leaf).
The SSM sub-layers run the same torch ops on both paths.  This file imports
nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_ssm_card.py
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.moe import moe, ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _plain_moe_ops():
    def route(top_e, e, cap, distinct=False):
        return ref.route_ref(top_e.int(), e, cap)

    return types.SimpleNamespace(capacity=ref.capacity, route=route,
                                 dispatch=ref.dispatch, combine=ref.combine)


def _serve(cfg, params, toks, steps):
    cache = TM.init_cache(cfg, toks.shape[0], toks.shape[1] + steps,
                          toks.device)
    logits, cache = TM.prefill(cfg, params, toks, cache)
    out = [logits]
    for _ in range(steps):
        logits, cache = TM.decode_step(cfg, params, cache,
                                       logits.argmax(-1, keepdim=True))
        out.append(logits)
    return out, cache


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_kernel_path_equals_the_plain_path(card, dtype):
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"), dtype=dtype,
                              head_dim=64, use_kernels=True)
    params = TM.init_serving_params(cfg, torch.Generator(device=card)
                                    .manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    fa.reset_launch_count()
    moe.reset_launch_count()
    got, cache_k = _serve(cfg, params, toks, 3)
    assert sum(fa.launch_counts().values()) == 1          # one attention layer
    assert moe.launch_counts() == {"route": 8, "dispatch": 8, "combine": 8,
                                   "combine_grad": 0, "gate_grad": 0}
    kernel_ops, TL.moe_ops = TL.moe_ops, _plain_moe_ops()
    try:
        want, cache_p = _serve(cfg, params, toks, 3)
    finally:
        TL.moe_ops = kernel_ops
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for sub, leaves in cache_k["layers"].items():
        for key, t in leaves.items():
            assert torch.equal(t, cache_p["layers"][sub][key]), (sub, key)
