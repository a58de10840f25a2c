"""The arithmetic of the bf16 tensor-core flash kernel, and the dtype dispatch.

``csrc/flash_attention_sm90.cu`` runs only on the card.  Here a torch
emulation of its arithmetic (kept in this file, not in the package) is held
against the JAX package's Pallas kernel in interpret mode, at the JAX kernel
tests' bf16 tolerance of 2e-2: bf16 operands, fp32 scores and sums, kv tiles
of 128 rows, the running max in the exp2 domain, P rounded to bf16 against
the running max of each tile before the P.V product, the running sum of the
unrounded P, and the same final division.  It shows, where the kernel
cannot run, that rounding P to bf16 keeps the result inside the tolerance.
On the card, ``chip_smoke.py`` and ``tests/test_torch_flash_card.py`` hold
the kernel itself against the plain version.  Inputs come from numpy with a
seed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

BN = 128                 # kv rows per tile of the sm90 kernel
NEG_INF = -1e30
TOL = 2e-2               # the JAX kernel tests' bf16 tolerance


def sm90_emulation(q, k, v, *, causal):
    """q (B, S, H, D), k, v (B, S, Hkv, D) bf16 -> bf16, as the kernel
    computes it (every q row walks every kv tile; tiles past a row's
    diagonal hold only masked scores and change nothing)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)                                 # (B, H, S, D)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, s), NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, BN):
        sc = qf @ kf[:, :, k0:k0 + BN].transpose(-1, -2)            # raw fp32 scores
        kpos = torch.arange(k0, min(k0 + BN, s))[None, :]
        if causal:
            sc = torch.where(kpos > qpos, NEG_INF, sc)
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(sc * c - (mx * c)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + BN]
        m = mx
    out = acc / (l + 1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_emulation_matches_jax_pallas_kernel(d, causal):
    """S of 200 (ragged), 384 and 512; GQA 6:1 and 2:1 at small head counts."""
    for s, h, hkv in ((200, 6, 1), (384, 4, 2), (512, 6, 1)):
        q, k, v = _inputs(s + d + h, 1, s, h, hkv, d)
        want = jax_ops.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                         for x in (q, k, v)), causal=causal)
        got = sm90_emulation(*(torch.tensor(x, dtype=torch.bfloat16)
                               for x in (q, k, v)), causal=causal)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, s, h, d)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jnp.asarray(want, jnp.float32)),
                                   atol=TOL, rtol=TOL, err_msg=f"S={s} H={h}")


def test_emulation_matches_plain_version_over_many_tiles():
    """Eight kv tiles and a ragged edge (S=1000), against the plain version
    the kernel is held to on the card, at the same tolerance."""
    q, k, v = (torch.tensor(x, dtype=torch.bfloat16)
               for x in _inputs(3, 2, 1000, 4, 1, 64))
    for causal in (True, False):
        got = sm90_emulation(q, k, v, causal=causal)
        want = ops.flash_attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   atol=TOL, rtol=TOL)


def test_select_kernel_dispatches_by_dtype_and_head_dim():
    for d in fa.HEAD_DIMS:
        assert fa.select_kernel(torch.bfloat16, d) == "sm90_bf16"
        assert fa.select_kernel(torch.float32, d) == "sm90_fp32"
        assert fa.select_kernel(torch.bfloat16, d, "fma") == "fma"
        assert fa.select_kernel(torch.float32, d, "fma") == "fma"
    for dtype, d, kernel, err in (
            (torch.bfloat16, 96, None, ValueError),
            (torch.float32, 32, None, ValueError),
            (torch.float16, 128, None, TypeError),
            (torch.float32, 128, "sm90_bf16", TypeError),
            (torch.bfloat16, 64, "sm90_fp32", TypeError),
            (torch.float16, 64, "fma", TypeError),
            (torch.bfloat16, 128, "tf32", TypeError)):
        with pytest.raises(err):
            fa.select_kernel(dtype, d, kernel)
    assert set(fa.SOURCES) == set(fa.KERNELS.values()) | {"fma"}


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.tensor(x, dtype=torch.bfloat16)
               for x in _inputs(5, 1, 130, 4, 2, 64))
    fa.reset_launch_count()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ops.flash_attention_ref(q, k, v, causal=True))
    assert fa.launch_counts() == {"sm90_bf16": 0, "sm90_fp32": 0, "fma": 0}
    assert fa.launch_count() == 0
    with pytest.raises(ValueError, match="one card"):
        fa.launch_bshd(q, k, v, causal=True)
    assert fa.launch_count() == 0
