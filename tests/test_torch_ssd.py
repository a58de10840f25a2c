"""The SSD scan's plain versions (``kernels/ssd/ref.py``) against torch's
autograd and the JAX package's recurrence, on the CPU.

* ``scan_grad_ref`` (the chunk recurrence's VJP written out as a reverse
  loop) against torch autograd through ``scan_ref`` and against
  ``jax.vjp`` of the reference's ``chunk_step`` under its ``lax.scan``
  (``src/repro/models/layers.py:404-430``, copied below as
  :func:`_jax_scan`; its forward held to ``scan_ref`` too), in float32 at S
  = 5, 8, 13 and 16 with chunk 8 (one short chunk, one whole, a second
  chunk padded with dt = 0, two whole), with a nonzero cotangent for the
  final state, at 1e-5 (autograd) and 1e-4 (JAX) of each tensor's largest
  magnitude;
* ROADMAP C8: at the reference's default chunk of 256 its ``jax.grad``
  through ``ssm_apply`` is NaN (the masked scores' zero cotangent times
  ``exp(cums_i - cums_j)`` overflowed above the diagonal), while
  ``scan_grad_ref`` is finite and equals ``jax.vjp`` of the same
  recurrence with the exponent masked before the exp;
* ``ssd.scan`` (the autograd Function) on CPU tensors equal to
  ``scan_ref`` and its backward to ``scan_grad_ref``, bit for bit, with no
  launch; the wrapper's refusals;
* ``step_ref`` bit for bit the decode body the port served before the
  kernel (``ssm_decode``'s state update, window shift and readout), in
  float32 and bfloat16.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.kernels.ssd import ref, ssd  # noqa: E402

AUTOGRAD_TOL, JAX_TOL = 1e-5, 1e-4


def _inputs(b, s, nh, hd, ns, seed, s_in=None, dtype=torch.float32):
    """Scan inputs as ``ssm_apply`` makes them: dt a softplus, 0 at the
    padded steps past ``s_in``; A = -exp(A_log)."""
    g = np.random.default_rng(seed)
    dt = np.log1p(np.exp(g.normal(size=(b, s, nh)) - 1.0))
    if s_in is not None:
        dt[:, s_in:] = 0.0
    xh = g.normal(size=(b, s, nh, hd))
    B, C = g.normal(size=(b, s, ns)), g.normal(size=(b, s, ns))
    A = -np.exp(0.5 * g.normal(size=(nh,)))
    return (torch.tensor(dt, dtype=torch.float32),
            torch.tensor(xh).to(dtype), torch.tensor(B).to(dtype),
            torch.tensor(C).to(dtype), torch.tensor(A, dtype=torch.float32))


def _jax_scan(dt, xh, Bm, Cm, A, lc, masked_exponent=False):
    """The reference's chunk recurrence, its lines as they stand in
    ``ssm_apply`` (``chunk_step`` under the ``lax.scan``), float32; with
    ``masked_exponent`` the decay is exp of the exponent masked to 0 above
    the diagonal."""
    b, s, nh, hd = xh.shape
    ns, nc = Bm.shape[-1], s // lc
    mask = jnp.tril(jnp.ones((lc, lc), bool))

    def chunk_step(state, inp):
        dtc, xc, Bc, Cc = inp
        cums = jnp.cumsum(dtc * A, axis=1)
        seg = cums[:, -1, :]
        diff = cums[:, :, None, :] - cums[:, None, :, :]
        if masked_exponent:
            diff = jnp.where(mask[None, :, :, None], diff, 0.0)
        decay = jnp.exp(diff)
        cb = jnp.einsum("bin,bjn->bij", Cc, Bc)
        att = cb[..., None] * decay * dtc[:, None, :, :]
        att = jnp.where(mask[None, :, :, None], att, 0.0)
        y = jnp.einsum("bijh,bjhp->bihp", att, xc)
        y = y + jnp.einsum("bin,bhpn,bih->bihp", Cc, state, jnp.exp(cums))
        sdecay = jnp.exp(seg[:, None, :] - cums) * dtc
        contrib = jnp.einsum("bjn,bjh,bjhp->bhpn", Bc, sdecay, xc)
        new_state = state * jnp.exp(seg)[:, :, None, None] + contrib
        return new_state, y

    chunks = (dt.reshape(b, nc, lc, nh).swapaxes(0, 1),
              xh.reshape(b, nc, lc, nh, hd).swapaxes(0, 1),
              Bm.reshape(b, nc, lc, ns).swapaxes(0, 1),
              Cm.reshape(b, nc, lc, ns).swapaxes(0, 1))
    final, ys = jax.lax.scan(chunk_step, jnp.zeros((b, nh, hd, ns)), chunks)
    return ys.swapaxes(0, 1).reshape(b, s, nh, hd), final


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of the largest magnitude (limit {tol})"


def _jax_vjp(args, lc, dy, dfinal, masked_exponent=False):
    """(y, final) and the cotangents (dxh, ddt, dB, dC, dA) by
    ``jax.vjp`` of :func:`_jax_scan`."""
    dt, xh, B, C, A = (jnp.asarray(t.numpy()) for t in args)
    out, vjp = jax.vjp(lambda dt_, xh_, B_, C_, A_: _jax_scan(
        dt_, xh_, B_, C_, A_, lc, masked_exponent), dt, xh, B, C, A)
    ddt, dxh, dB, dC, dA = vjp((jnp.asarray(dy.numpy()),
                                jnp.asarray(dfinal.numpy())))
    return out, (dxh, ddt, dB, dC, dA)


@pytest.mark.parametrize("s_in", [5, 8, 13, 16])
def test_scan_grad_ref_against_autograd_and_the_references_vjp(s_in):
    lc = min(8, s_in)
    s = -(-s_in // lc) * lc
    args = _inputs(2, s, 3, 4, 6, s_in, s_in)
    leaves = [t.clone().requires_grad_() for t in args]
    y, final, states = ref.scan_ref(*leaves, lc)
    g = np.random.default_rng(100 + s_in)
    dy = torch.tensor(g.normal(size=y.shape), dtype=torch.float32)
    dfinal = torch.tensor(g.normal(size=final.shape), dtype=torch.float32)
    auto = torch.autograd.grad((y * dy).sum() + (final * dfinal).sum(), leaves)
    auto = (auto[1], auto[0], auto[2], auto[3], auto[4])   # dxh, ddt, ...
    got = ref.scan_grad_ref(*args, lc, states.detach(), dy, dfinal)
    (jy, jfinal), want = _jax_vjp(args, lc, dy, dfinal)
    _close(y.detach(), jy, JAX_TOL, "y")
    _close(final.detach(), jfinal, JAX_TOL, "final state")
    names = ("dxh", "ddt", "dB", "dC", "dA")
    for name, a, w, j in zip(names, got, auto, want):
        assert a.dtype == w.dtype
        _close(a, w, AUTOGRAD_TOL, f"{name} against autograd")
        _close(a, j, JAX_TOL, f"{name} against jax.vjp")


def test_large_chunks_grad_is_finite_where_the_reference_is_nan():
    """ROADMAP C8.  At chunk 256 (mamba2-130m's ``ssm_chunk``) the
    reference's own ``jax.grad`` of ``ssm_apply`` is NaN for w_B, w_C, w_dt,
    the convs' B and C, A_log and dt_bias: exp(cums_i - cums_j) overflows
    above the diagonal and the masked score's zero cotangent times inf is
    NaN.  ``scan_grad_ref`` masks the exponent first: finite, and equal to
    ``jax.vjp`` of the recurrence so masked, and to the reference's VJP for
    xh (which the overflow does not reach)."""
    cfg = dataclasses.replace(jax_smoke("mamba2-130m"), dtype="float32",
                              ssm_chunk=256)
    p = jax.tree.map(lambda a: a[0], JM.init_params(
        cfg, jax.random.PRNGKey(0))["blocks"]["ssm"])
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, 256, 64)),
                    jnp.float32)
    grads = jax.grad(lambda q: JL.ssm_apply(cfg, q, x).sum())(p)
    nan = {k for k, v in grads.items() if not isinstance(v, dict)
           and bool(jnp.isnan(v).any())}
    assert {"w_B", "w_C", "w_dt", "A_log", "dt_bias"} <= nan
    assert not bool(jnp.isnan(grads["w_x"]).any())

    args = _inputs(1, 256, 2, 4, 6, 7)
    _, final, states = ref.scan_ref(*args, 256)
    g = np.random.default_rng(8)
    dy = torch.tensor(g.normal(size=args[1].shape), dtype=torch.float32)
    dfinal = torch.tensor(g.normal(size=final.shape), dtype=torch.float32)
    got = ref.scan_grad_ref(*args, 256, states, dy, dfinal)
    _, plain_ref = _jax_vjp(args, 256, dy, dfinal)
    _, masked = _jax_vjp(args, 256, dy, dfinal, masked_exponent=True)
    assert bool(jnp.isnan(plain_ref[2]).any())             # dB
    for name, a, w in zip(("dxh", "ddt", "dB", "dC", "dA"), got, masked):
        assert bool(torch.isfinite(a).all()), name
        _close(a, w, JAX_TOL, f"{name} against the masked recurrence")
    _close(got[0], plain_ref[0], JAX_TOL, "dxh against the reference")


def test_scan_function_on_the_cpu_is_the_plain_versions_bit_for_bit():
    """``ssd.scan`` on CPU tensors: the forward ``scan_ref``'s (y, final)
    and the backward ``scan_grad_ref``'s cotangents, bit for bit (final's
    cotangent None when it takes no part), and no launch; ``ref.scan`` the
    same."""
    args = _inputs(2, 24, 3, 4, 6, 3)
    want_y, want_final, states = ref.scan_ref(*args, 8)
    g = np.random.default_rng(4)
    dy = torch.tensor(g.normal(size=want_y.shape), dtype=torch.float32)
    want = ref.scan_grad_ref(*args, 8, states, dy, None)
    for fn in (ssd.scan, ref.scan):
        ssd.reset_launch_count()
        leaves = [t.clone().requires_grad_() for t in args]
        y, final = fn(*leaves, 8)
        assert torch.equal(y, want_y) and torch.equal(final, want_final)
        got = torch.autograd.grad((y * dy).sum(), leaves)
        for a, w in zip((got[1], got[0], got[2], got[3], got[4]), want):
            assert torch.equal(a, w)
        assert ssd.launch_count() == 0


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    args = _inputs(1, 24, 2, 4, 6, 5)
    with pytest.raises(ValueError, match="whole chunks"):
        ssd.scan(*args, 7)
    with pytest.raises(ValueError, match="whole chunks"):
        ssd.scan(*_inputs(1, 512, 1, 2, 2, 5), 512)
    with pytest.raises(ValueError, match="state values"):
        ssd.scan(*_inputs(1, 8, 1, 64, 256, 5), 8)
    dt, xh, B, C, A = args
    with pytest.raises(ValueError, match="float32"):
        ssd.scan(dt.double(), xh, B, C, A, 8)
    with pytest.raises(ValueError, match="xh's"):
        ssd.scan(dt, xh, B.bfloat16(), C, A, 8)
    state = torch.zeros((1, 2, 4, 6))
    with pytest.raises(ValueError, match="do not fit"):
        ssd.step(state, torch.zeros(1, 3, 10), torch.zeros(1, 3, 10),
                 torch.zeros(1, 2, 4), torch.zeros(1, 2), torch.zeros(2),
                 torch.zeros(1, 6), torch.zeros(1, 6))


def _served_decode_body(state, conv, window, xh, dtv, A_log, Bv, Cv):
    """The decode step as the port served it before the kernel
    (``ssm_decode``'s span body), with A = -exp(A_log)."""
    cdt = state.dtype
    da = torch.exp(dtv * -torch.exp(A_log.float()))
    upd = (xh * dtv.to(cdt)[:, :, None])[..., None] * Bv[:, None, None, :]
    state.copy_(state * da[:, :, None, None].to(cdt) + upd)
    conv.copy_(window[:, 1:])
    return torch.einsum("bn,bhpn->bhp", Cv, state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_ref_is_the_served_decode_body_bit_for_bit(dtype):
    g = np.random.default_rng(6)
    b, nh, hd, ns, cw, width = 2, 3, 4, 6, 4, 20

    def t(*shape):
        return torch.tensor(g.normal(size=shape)).to(dtype)

    state, conv, window = t(b, nh, hd, ns), t(b, cw - 1, width), \
        t(b, cw, width)
    xh, Bv, Cv = t(b, nh, hd), t(b, ns), t(b, ns)
    dtv = torch.tensor(np.abs(g.normal(size=(b, nh))), dtype=torch.float32)
    A_log = torch.tensor(g.normal(size=(nh,)), dtype=torch.float32)
    s1, c1, s2, c2 = state.clone(), conv.clone(), state.clone(), conv.clone()
    y = ref.step_ref(s1, c1, window, xh, dtv, -torch.exp(A_log), Bv, Cv)
    want = _served_decode_body(s2, c2, window, xh, dtv, A_log, Bv, Cv)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    assert torch.equal(y, want)
    assert torch.equal(c1, window[:, 1:])
    y3 = ssd.step(state.clone(), conv.clone(), window, xh, dtv,
                  -torch.exp(A_log), Bv, Cv)
    assert torch.equal(y3, want)
