"""The flash-attention CUDA kernels against their plain version, on the card.

The kernels have no CPU mode, so every test here carries the ``card``
marker and asks for the ``card`` fixture, which skips it without a card.
This file imports nothing of JAX, so it also runs on a host that has the
card but not the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_card.py

bf16 goes through the tensor-core kernel (``csrc/flash_attention_sm90.cu``)
at the JAX kernel tests' bf16 tolerance, 2e-2; float32 through the 3xTF32
tensor-core kernel (``csrc/flash_attention_sm90_fp32.cu``) at their
float32 tolerance, 2e-5.  The FMA kernel (``csrc/flash_attention.cu``)
runs when asked, on either dtype.
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
def test_fp32_kernel_at_serving_and_long_shapes(card, case):
    fa.reset_launch_count()
    for causal in (True, False):
        _check(case, torch.float32, causal, card)
    assert fa.launch_counts() == {**dict.fromkeys(fa.SOURCES, 0),
                                  "sm90_fp32": 2}


@pytest.mark.card
def test_fp32_pre_pass_matches_its_plain_version_exactly(card):
    """k and v^T split into TF32 hi and lo, zero-padded to whole kv tiles
    and in the kernel's kv order, bit for bit; a ragged S at both head
    dims."""
    for i, (b, s, hkv, d) in enumerate(((2, 200, 2, 64), (1, 333, 3, 128))):
        k, v, _ = _inputs(10 + i, (b, s, hkv, hkv, d), torch.float32, card)
        got = fa.split_kv_tf32(k, v)
        want = fa.split_kv_tf32_ref(k, v)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), (b, s, hkv, d)


@pytest.mark.card
def test_fp32_kernel_sees_a_wrong_kv_order(card):
    """Inputs on which a P.V product in the wrong kv order cannot pass:
    each query's own key wins its softmax outright (unit k, q = 40 sqrt(D)
    k: a score of 40 against others of 0 +- 5), so each output row is
    its own row of v, and the v rows differ by 1 / S or more."""
    b, s, h, d = 1, 128, 2, 64
    rng = np.random.default_rng(7)
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    q = np.float32(40.0 * np.sqrt(d)) * k
    v = np.arange(b * s * h * d, dtype=np.float32).reshape(b, s, h, d) / (s * h * d)
    q, k, v = (torch.from_numpy(x).to(card) for x in (q, k, v))
    fa.reset_launch_count()
    got = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.launch_counts()["sm90_fp32"] == 1
    diff = (got - want).abs()
    assert bool((diff <= 2e-5 + 2e-5 * want.abs()).all()), diff.max().item()


@pytest.mark.card
def test_fma_kernel_on_fp32_when_asked(card):
    q, k, v = _inputs(5, SERVING, torch.float32, card)
    fa.reset_launch_count()
    got = fa.launch_bshd(q, k, v, causal=True, kernel="fma")
    want = ops.flash_attention_ref(q, k, v, causal=True)
    assert bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
    assert fa.launch_counts() == {**dict.fromkeys(fa.SOURCES, 0), "fma": 1}


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
    assert fa.launch_counts() == {**dict.fromkeys(fa.SOURCES, 0), "fma": 1}


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
    q = torch.zeros(1, 128, 2, 96, device=card, dtype=torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.launch_bshd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.split_kv_tf32(q, q)
    q = torch.zeros(1, 128, 2, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="sm90_fp32"):
        fa.launch_bshd(q, q, q, causal=True, kernel="sm90_fp32")
