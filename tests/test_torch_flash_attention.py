"""The port's flash attention against the JAX package's Pallas kernel.

Here on the CPU the port's wrapper takes its plain version (the kernel runs
only on the card, where ``chip_smoke.py`` holds it against the same plain
version); the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  Inputs come from numpy with a seed.
Tolerances are those of the JAX kernel tests: 2e-5 in float32 (summation
order) and 2e-2 in bfloat16 (one rounding of the output to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


def _to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("s", [256, 384])
def test_flash_attention_matches_jax(s, h, hkv, d, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(s + h + d, 1, s, h, hkv, d)
    want = jax_ops.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                   jnp.asarray(v, jdt), causal=causal)
    got = ops.flash_attention(torch.tensor(q, dtype=tdt),
                              torch.tensor(k, dtype=tdt),
                              torch.tensor(v, dtype=tdt), causal=causal)
    assert got.dtype == tdt and tuple(got.shape) == (1, s, h, d)
    np.testing.assert_allclose(_to_np(got), _to_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_matches_attention_ref(causal):
    """S=200 divides no tile; the JAX side is its plain ``attention_ref``."""
    b, s, h, d = 2, 200, 4, 64
    q, k, v = _inputs(7, b, s, h, h, d)

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    want = jax_ref(jnp.asarray(fold(q)), jnp.asarray(fold(k)),
                   jnp.asarray(fold(v)), causal=causal)
    got = fa.flash_attention_bhsd(torch.tensor(fold(q)), torch.tensor(fold(k)),
                                  torch.tensor(fold(v)), causal=causal)
    np.testing.assert_allclose(_to_np(got), _to_np(want), atol=2e-5, rtol=2e-5)
    got_gqa = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), causal=causal)
    np.testing.assert_allclose(
        _to_np(got_gqa), _to_np(want).reshape(b, h, s, d).transpose(0, 2, 1, 3),
        atol=2e-5, rtol=2e-5)


def test_plain_attention_matches_jax_reference_with_unequal_lengths():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(3, 40, 64)).astype(np.float32)
    k = rng.normal(size=(3, 56, 64)).astype(np.float32)
    v = rng.normal(size=(3, 56, 64)).astype(np.float32)
    for causal in (True, False):
        want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal)
        got = attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            causal=causal)
        np.testing.assert_allclose(_to_np(got), _to_np(want),
                                   atol=2e-5, rtol=2e-5)


def test_wrappers_reject_malformed_shapes():
    q = torch.zeros(1, 16, 6, 64)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros(1, 16, 4, 64), torch.zeros(1, 16, 4, 64))
    with pytest.raises(ValueError, match="differ"):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64))
    with pytest.raises(ValueError, match="BH, S, D"):
        fa.flash_attention_bhsd(torch.zeros(2, 16, 64), torch.zeros(2, 8, 64),
                                torch.zeros(2, 8, 64))
