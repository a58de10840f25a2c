"""The arithmetic of the fp32 tensor-core flash kernel (3xTF32), its kv
layout, and the dtype dispatch.

``csrc/flash_attention_sm90_fp32.cu`` runs only on the card.  Here a torch
emulation of its arithmetic (kept in this file, not in the package) is held
against the JAX package's Pallas kernel in interpret mode, at the JAX kernel
tests' float32 tolerance of 2e-5: every operand split as hi = tf32(x), lo =
tf32(x - hi) with a bit-exact TF32 round to nearest (ties away from zero),
each product hi hi' + hi lo' + lo hi' summed in fp32, kv tiles of 64 rows,
the running max in the exp2 domain, P split the same way before the P.V
product, the running sum of the unsplit P, and the same final division.
The same emulation with one TF32 product (hi hi') misses 2e-5, so the test
tells the two apart.  The kernel's kv layout (k and v^T split, padded and
in the A fragment's kv order) is checked through its plain version.  On the
card, ``chip_smoke.py`` and ``tests/test_torch_flash_card.py`` hold the
kernel itself against the plain version.  Inputs come from numpy with a
seed.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jax_ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

BN = 64                  # kv rows per tile of the fp32 kernel
NEG_INF = -1e30
TOL = 2e-5               # the JAX kernel tests' float32 tolerance
# (B, S, H, Hkv, D): tests/test_kernels.py's sweep, and a ragged S
SWEEP = [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64), (2, 256, 8, 1, 128),
         (2, 384, 6, 2, 64), (2, 200, 4, 2, 64)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 to TF32, round to nearest with ties away from zero, bit-exact:
    add half of the 13 dropped bits' unit to the magnitude, then drop them
    (numpy, independent of the package's ``tf32_round``)."""
    bits = x.numpy().astype(np.float32).view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(out)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tf32_emulation(q, k, v, *, causal, products=3):
    """q (B, S, H, D), k, v (B, S, Hkv, D) fp32 -> fp32, as the kernel
    computes it with three TF32 products per product (``products=1``: hi
    hi' alone).  Every q row walks every kv tile; tiles past a row's
    diagonal hold only masked scores and change nothing."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.transpose(1, 2)                                     # (B, H, S, D)
    kf = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(g, dim=2).transpose(1, 2)
    (qh, ql), (kh, kl), (vh, vl) = split(qf), split(kf), split(vf)
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full((b, h, s), NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, BN):
        t = slice(k0, k0 + BN)
        sc = qh @ kh[:, :, t].transpose(-1, -2)
        if products == 3:
            sc = sc + qh @ kl[:, :, t].transpose(-1, -2) + ql @ kh[:, :, t].transpose(-1, -2)
        kpos = torch.arange(k0, min(k0 + BN, s))[None, :]
        if causal:
            sc = torch.where(kpos > qpos, NEG_INF, sc)
        mx = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(sc * c - (mx * c)[..., None])
        l = l * alpha + p.sum(-1)
        ph, pl = split(p)
        pv = ph @ vh[:, :, t]
        if products == 3:
            pv = pv + ph @ vl[:, :, t] + pl @ vh[:, :, t]
        acc = acc * alpha[..., None] + pv
        m = mx
    out = acc / (l + 1e-30)[..., None]
    return out.transpose(1, 2)


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32),
            rng.normal(size=(b, s, hkv, d)).astype(np.float32))


@functools.cache
def _case(i, causal):
    """The i-th sweep case's numpy inputs and the Pallas kernel's output."""
    b, s, h, hkv, d = SWEEP[i]
    q, k, v = _inputs(s + h + i, b, s, h, hkv, d)
    want = jax_ops.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                   causal=causal)
    return (q, k, v), np.asarray(want)


def _emulate(i, causal, products):
    (q, k, v), want = _case(i, causal)
    got = tf32_emulation(*(torch.from_numpy(x) for x in (q, k, v)),
                         causal=causal, products=products)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    return got.numpy(), want


def test_tf32_round_is_bit_exact_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) * np.float32(1e3)
    base = np.float32([1.0, -1.0, 3.0e-3, -7.5e5]).view(np.uint32)
    ties = (base | np.uint32(0x1000)).view(np.float32)   # exactly half way
    xs = torch.from_numpy(np.concatenate([x, ties]))
    got = fa.tf32_round(xs)
    assert torch.equal(got, tf32(xs))
    assert not (got.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
    # half way rounds away from zero: the magnitude grows by one TF32 unit
    up = ((base + np.uint32(0x2000)) & np.uint32(0xFFFFE000)).view(np.float32)
    np.testing.assert_array_equal(got.numpy()[-4:], up)
    rel = (got - xs).abs() / xs.abs()
    assert float(rel.max()) <= 2.0 ** -11
    hi, lo = split(xs)
    assert float(((hi + lo - xs).abs() / xs.abs()).max()) <= 2.0 ** -22


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_emulation_matches_jax_pallas_kernel(causal):
    """The JAX sweep's shapes and a ragged S, at 2e-5."""
    for i, case in enumerate(SWEEP):
        got, want = _emulate(i, causal, products=3)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=f"{case} causal={causal}")


def test_one_tf32_product_misses_the_fp32_tolerance():
    """The same emulation with hi hi' alone fails 2e-5 on every case the
    3xTF32 split holds, by more than a factor of 4 somewhere."""
    worst = 0.0
    for causal in (True, False):
        for i, case in enumerate(SWEEP):
            got, want = _emulate(i, causal, products=1)
            excess = np.abs(got - want) / (TOL + TOL * np.abs(want))
            assert excess.max() > 1.0, (case, causal)
            worst = max(worst, float(excess.max()))
    assert worst > 4.0


def test_3xtf32_emulation_matches_plain_version_over_many_tiles():
    """Sixteen kv tiles and a ragged edge (S=1000), against the plain
    version the kernel is held to on the card, at the same tolerance."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(3, 2, 1000, 4, 1, 64))
    for causal in (True, False):
        got = tf32_emulation(q, k, v, causal=causal)
        want = ops.flash_attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL,
                                   rtol=TOL)


def test_kv_order_is_the_a_fragment_read_of_the_accumulator():
    """For TF32 k8 a thread (t = lane % 4) holds accumulator columns 2t,
    2t + 1 of each group of 8 and A-fragment columns t (registers a0, a1)
    and t + 4 (a2, a3); the kernel passes accumulator entries {0, 2, 1, 3}
    as {a0, a1, a2, a3}, so A column t is kv 2t and column t + 4 is kv
    2t + 1: the order the pre-pass writes v^T in."""
    order = [None] * 8
    for t in range(4):
        acc_cols = [2 * t, 2 * t + 1, 2 * t, 2 * t + 1]     # entries 0..3
        frag_cols = [t, t, t + 4, t + 4]                    # a0..a3
        for reg, entry in enumerate((0, 2, 1, 3)):
            order[frag_cols[reg]] = acc_cols[entry]
    assert tuple(order) == fa.KV_ORDER
    assert sorted(fa.KV_ORDER) == list(range(8))


def test_pre_pass_layout_gives_the_same_products():
    """The pre-pass's plain version: k hi + lo and v^T hi + lo rebuild k
    and v to 2^-22, rows past S are zero, and P with its columns read in
    the kernel's kv order times v^T's rows gives P v; in natural order it
    does not."""
    b, s, hkv, d = 2, 200, 2, 64
    _, k, v = (torch.from_numpy(x) for x in _inputs(11, b, s, hkv, hkv, d))
    kx, vt = fa.split_kv_tf32(k, v)          # CPU tensors: the plain version
    sp = -(-s // fa.KV_TILE_FP32) * fa.KV_TILE_FP32
    assert kx.shape == (2, b * hkv, sp, d) and vt.shape == (2, b * hkv, d, sp)
    for part in (kx, vt):
        assert torch.equal(part, fa.tf32_round(part))   # both halves TF32
    k_heads = k.transpose(1, 2).reshape(b * hkv, s, d)
    v_heads = v.transpose(1, 2).reshape(b * hkv, s, d)
    k_back = kx[0] + kx[1]
    assert torch.allclose(k_back[:, :s], k_heads, rtol=2.0 ** -22, atol=0)
    assert not k_back[:, s:].any() and not (vt[0] + vt[1])[..., s:].any()

    order = torch.arange(sp).view(-1, 8)[:, list(fa.KV_ORDER)].reshape(-1)
    p = torch.from_numpy(np.random.default_rng(12).random((b * hkv, 64, sp),
                                                          dtype=np.float32))
    p[..., s:] = 0.0
    want = p[..., :s].double() @ v_heads.double()
    v_rows = (vt[0] + vt[1]).transpose(-1, -2).double()  # (heads, S_pad, D)
    got = p[..., order].double() @ v_rows
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)
    wrong = p.double() @ v_rows
    assert not torch.allclose(wrong, want, rtol=1e-2, atol=1e-2)


def test_select_kernel_names_the_tf32_kernel_for_float32():
    for d in fa.HEAD_DIMS:
        assert fa.select_kernel(torch.float32, d) == "sm90_fp32"
        assert fa.select_kernel(torch.float32, d, "fma") == "fma"
        assert fa.select_kernel(torch.bfloat16, d) == "sm90_bf16"
        with pytest.raises(TypeError, match="sm90_fp32"):
            fa.select_kernel(torch.bfloat16, d, "sm90_fp32")
    with pytest.raises(ValueError, match="head dim"):
        fa.select_kernel(torch.float32, 96)
    assert fa.KERNELS[torch.float32] == "sm90_fp32"
    assert fa.SOURCES["sm90_fp32"] == "flash_attention_sm90_fp32"


def test_cpu_float32_takes_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 130, 4, 2, 64))
    fa.reset_launch_count()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ops.flash_attention_ref(q, k, v, causal=True))
    for g, w in zip(fa.split_kv_tf32(k, v), fa.split_kv_tf32_ref(k, v)):
        assert torch.equal(g, w)
    assert fa.launch_counts() == dict.fromkeys(fa.SOURCES, 0)
    with pytest.raises(ValueError, match="one card"):
        fa.launch_bshd(q, k, v, causal=True)
    assert fa.launch_count() == 0
