"""The flash-attention CUDA kernels against their plain version, on the card.

The kernels have no CPU mode, so every test here carries the ``card``
marker and asks for the ``card`` fixture, which skips it without a card.
This file imports nothing of JAX, so it also runs on a host that has the
card but not the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_card.py

bf16 goes through the tensor-core kernel (``csrc/flash_attention_sm90.cu``)
at the JAX kernel tests' bf16 tolerance, 2e-2; float32 through the FMA
kernel (``csrc/flash_attention.cu``) at their float32 tolerance, 2e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# (B, S, H, Hkv, D): the JAX kernel tests' sweep, a ragged length, the
# serving prefill, and a long prompt at two heads
SWEEP = [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64), (2, 256, 8, 1, 128),
         (2, 384, 6, 2, 64), (2, 200, 4, 2, 64)]
SERVING = (4, 512, 12, 2, 128)
LONG = (1, 8192, 2, 2, 128)


@pytest.fixture
def card():
    """The card, for tests that launch a kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, case, dtype, device):
    b, s, h, hkv, d = case
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(device=device, dtype=dtype)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


def _check(case, dtype, causal, device, seed=0):
    q, k, v = _inputs(seed, case, dtype, device)
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol + tol * want.float().abs()).all()), (
        case, dtype, causal, diff.max().item())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_against_plain_version(card, dtype):
    """Each dtype goes to its own kernel, and only to it."""
    fa.reset_launch_count()
    for i, case in enumerate(SWEEP):
        for causal in (True, False):
            _check(case, dtype, causal, card, seed=i)
    name = fa.KERNELS[dtype]
    assert fa.launch_counts() == {**dict.fromkeys(fa.SOURCES, 0),
                                  name: 2 * len(SWEEP)}


@pytest.mark.card
@pytest.mark.parametrize("case", [SERVING, LONG], ids=["serving", "long"])
def test_bf16_kernel_at_serving_and_long_shapes(card, case):
    fa.reset_launch_count()
    for causal in (True, False):
        _check(case, torch.bfloat16, causal, card)
    assert fa.launch_counts()["sm90_bf16"] == 2
    assert fa.launch_count() == 2


@pytest.mark.card
def test_fma_kernel_on_bf16_when_asked(card):
    """The FMA kernel stays reachable on bf16, as the yardstick it is."""
    q, k, v = _inputs(4, SERVING, torch.bfloat16, card)
    fa.reset_launch_count()
    got = fa.launch_bshd(q, k, v, causal=True, kernel="fma")
    want = ops.flash_attention_ref(q, k, v, causal=True)
    assert bool(((got.float() - want.float()).abs()
                 <= 2e-2 + 2e-2 * want.float().abs()).all())
    assert fa.launch_counts() == {"sm90_bf16": 0, "fma": 1}


@pytest.mark.card
def test_unsupported_cases_raise_on_the_card(card):
    q = torch.zeros(1, 128, 2, 96, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.launch_bshd(q, q, q, causal=True)
    q = torch.zeros(1, 128, 2, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.launch_bshd(q, q, q, causal=True)
    q = torch.zeros(1, 128, 2, 64, device=card, dtype=torch.float32)
    with pytest.raises(TypeError, match="sm90"):
        fa.launch_bshd(q, q, q, causal=True, kernel="sm90_bf16")
