"""A numpy emulation of ``ssd_sm90.cu``'s loops, held against the plain
versions (``kernels/ssd/ref.py``) on the CPU.

The emulation follows the kernels launch by launch: each chunk's cumsum in
order; the scores C·B only for the 64 x 64 tiles on or below the diagonal
(the rest of the buffer NaN, so a read above the diagonal shows); each
chunk's contribution to the state all at once, then the one sequential
pass over the chunks that turns them into the entering states in place;
the outputs in tiles of 64 rows.  The backward: each chunk's state
cotangent, the reverse pass with its fixed reduction tree for d exp(seg)
(256 threads' partials over their elements in order, then halves), the
state update's and inter-chunk cotangents in tiles of 64 rows (row sums
tile by tile), the scores' row strips (64 x lc) and column strips (lc x
64, NaN-filled first: the strips' rows above the column block are never
read), the exponents' reverse cumsum a (batch, chunk, head), and dB / dC
summed over the heads in head order.  Every product sums its k in order
in float32, as the kernel's fmaf does (here a float32 product and add).
Held at 1e-5 (forward) and 1e-4 (backward) of each tensor's largest
magnitude in float32, 2e-2 in bfloat16, on chunks of 8, 13 and 80 (two
tiles of 64 a chunk, a state of 72: two column tiles); and ``step``'s
elementwise update bit for bit ``step_ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd import ref  # noqa: E402

TILE, THREADS = 64, 256
F32 = np.float32
#: (b, s, nh, hd, ns, lc)
SHAPES = [(2, 16, 3, 4, 6, 8), (1, 26, 2, 4, 5, 13), (1, 160, 2, 8, 72, 80)]
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rounder(dtype):
    if dtype == torch.float32:
        return lambda v: np.asarray(v, F32)
    return lambda v: torch.from_numpy(np.asarray(v, F32)).to(dtype).float() \
        .numpy()


def _exp(v):
    """float32 exp as torch takes it on the CPU."""
    return torch.exp(torch.from_numpy(np.asarray(v, F32))).numpy()


def _gemm(a, b):
    """sum_k a[k, m] * b[k, n] in k order, accumulated in float32."""
    acc = np.zeros((a.shape[1], b.shape[1]), F32)
    for k in range(a.shape[0]):
        acc = acc + a[k][:, None] * b[k][None, :]
    return acc


def _inputs(shape, dtype, seed):
    b, s, nh, hd, ns, _ = shape
    g = np.random.default_rng(seed)
    dt = torch.tensor(np.log1p(np.exp(g.normal(size=(b, s, nh)) - 1)),
                      dtype=torch.float32)
    xh = torch.tensor(g.normal(size=(b, s, nh, hd))).to(dtype)
    B = torch.tensor(g.normal(size=(b, s, ns))).to(dtype)
    C = torch.tensor(g.normal(size=(b, s, ns))).to(dtype)
    A = -torch.tensor(np.exp(0.5 * g.normal(size=(nh,))), dtype=torch.float32)
    return dt, xh, B, C, A


def _np(*ts):
    return [t.float().numpy() for t in ts]


def _cums(dt, A, lc):
    """cums_kernel: a thread a (batch, chunk, head), in order."""
    b, s, nh = dt.shape
    out = np.empty_like(dt)
    for c0 in range(0, s, lc):
        acc = np.zeros((b, nh), F32)
        for j in range(lc):
            acc = acc + dt[:, c0 + j] * A
            out[:, c0 + j] = acc
    return out


def _scores(C, B, lc, r):
    """cb_kernel: r(C_i . B_j) for the tiles with j0 <= i0; NaN elsewhere."""
    b, s, _ = C.shape
    cb = np.full((s // lc, b, lc, lc), np.nan, F32)
    for c in range(s // lc):
        Cc, Bc = C[:, c * lc:(c + 1) * lc], B[:, c * lc:(c + 1) * lc]
        for i0 in range(0, lc, TILE):
            for j0 in range(0, i0 + 1, TILE):
                for bb in range(b):
                    ci, bj = Cc[bb, i0:i0 + TILE], Bc[bb, j0:j0 + TILE]
                    cb[c, bb, i0:i0 + TILE, j0:j0 + TILE] = r(_gemm(ci.T, bj.T))
    return cb


def _score(cb, cu, dtc, i, j):
    """The masked score (cb * exp(cums_i - cums_j)) * dt_j of one (i, j <=
    i); and exp's value."""
    e = _exp(cu[i] - cu[j])
    return F32(F32(cb * e) * dtc[j]), e


def emulate_scan(dt, xh, B, C, A, lc, dtype):
    r = _rounder(dtype)
    dt, xh, B, C, A = _np(dt, xh, B, C, A)
    b, s, nh, hd = xh.shape
    nc = s // lc
    cums = _cums(dt, A, lc)
    cb = _scores(C, B, lc, r)
    states = np.empty((nc, b, nh, hd, B.shape[-1]), F32)
    for c in range(nc):                   # contrib_kernel, all chunks at once
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            for h in range(nh):
                cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                sd = r(_exp(cu[-1] - cu) * dtc)
                u = r(sd[:, None] * xh[bb, sl, h])
                states[c, bb, h] = r(_gemm(u, B[bb, sl]))
    sv = np.zeros(states.shape[1:], F32)  # states_kernel: in place, in order
    for c in range(nc):
        contrib = states[c].copy()
        states[c] = sv
        g = r(_exp(cums[:, c * lc + lc - 1]))[:, :, None, None]
        sv = r(r(sv * g) + contrib)
    y = np.empty_like(xh)
    for c in range(nc):                   # out_kernel, tiles of 64 rows
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            for h in range(nh):
                cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                for i0 in range(0, lc, TILE):
                    rows = range(i0, min(lc, i0 + TILE))
                    kmax = min(lc, i0 + TILE)
                    L = np.zeros((kmax, len(rows)), F32)
                    for m, i in enumerate(rows):
                        for j in range(i + 1):
                            L[j, m] = r(_score(cb[c, bb, i, j], cu, dtc, i,
                                               j)[0])
                    a1 = _gemm(L, xh[bb, sl, h][:kmax])
                    ci = C[bb, sl][list(rows)]
                    a2 = _gemm(ci.T, states[c, bb, h].T)
                    e = r(_exp(cu[list(rows)]))[:, None]
                    y[bb, c * lc + i0:c * lc + rows[-1] + 1, h] = r(
                        r(a1) + r(r(a2) * e))
    return y, sv, states


def _tree_sum(values):
    """reverse_kernel's d exp(seg): thread t sums elements t, t + 256, ...
    in order, then the 256 partials are summed in halves."""
    part = np.zeros(THREADS, F32)
    for q in range(0, values.size, THREADS):
        chunk = values[q:q + THREADS]
        part[:chunk.size] = part[:chunk.size] + chunk
    half = THREADS // 2
    while half:
        part[:half] = part[:half] + part[half:2 * half]
        half //= 2
    return part[0]


def emulate_scan_grad(dt, xh, B, C, A, lc, states, dy, dfinal, dtype):
    r = _rounder(dtype)
    dt, xh, B, C, A, states, dy = _np(dt, xh, B, C, A, states, dy)
    b, s, nh, hd = xh.shape
    ns, nc = B.shape[-1], s // lc
    cums = _cums(dt, A, lc)
    cb = _scores(C, B, lc, r)
    gs = np.empty((nc, b, nh, hd, ns), F32)
    for c in range(nc):                   # w_kernel
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            for h in range(nh):
                dq = dy[bb, sl, h] * r(_exp(cums[bb, sl, h]))[:, None]
                gs[c, bb, h] = _gemm(dq, C[bb, sl])
    dG = np.empty((nc, b, nh), F32)       # reverse_kernel, in place
    g = (np.zeros((b, nh, hd, ns), F32) if dfinal is None
         else dfinal.float().numpy())
    for c in reversed(range(nc)):
        w = gs[c].copy()
        gs[c] = g
        for bb in range(b):
            for h in range(nh):
                dG[c, bb, h] = _tree_sum((g[bb, h] * states[c, bb, h]).ravel())
        gr = r(_exp(cums[:, c * lc + lc - 1]))[:, :, None, None]
        g = g * gr + w
    dxs = np.empty_like(xh)
    dsd, dE, rowsum, colsum, ddti = (np.zeros((b, s, nh), F32)
                                     for _ in range(5))
    dBh = np.full((nh, b, s, ns), np.nan, F32)
    dCh = np.full((nh, b, s, ns), np.nan, F32)
    dxh = np.empty_like(xh)
    for c in range(nc):
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            for h in range(nh):
                cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                xc, dyc = xh[bb, sl, h], dy[bb, sl, h]
                Bc, Cc, S, G = B[bb, sl], C[bb, sl], states[c, bb, h], gs[c, bb, h]
                for j0 in range(0, lc, TILE):       # state_grad_kernel
                    rw = slice(j0, min(lc, j0 + TILE))
                    sdr = r(_exp(cu[-1] - cu[rw]) * dtc[rw])
                    du = _gemm(Bc[rw].T, G.T)
                    dxs[bb, c * lc + j0:c * lc + rw.stop, h] = sdr[:, None] * du
                    dsd[bb, c * lc + j0:c * lc + rw.stop, h] = _row_sums(
                        xc[rw] * du)
                    u = r(sdr[:, None] * xc[rw])
                    dBh[h, bb, c * lc + j0:c * lc + rw.stop] = _gemm(u.T, G)
                    q = r(_gemm(Cc[rw].T, S.T))
                    dE[bb, c * lc + j0:c * lc + rw.stop, h] = _row_sums(
                        dyc[rw] * q)
                    dq = dyc[rw] * r(_exp(cu[rw]))[:, None]
                    dCh[h, bb, c * lc + j0:c * lc + rw.stop] = _gemm(dq.T, S)
                for i0 in range(0, lc, TILE):       # rows_kernel
                    rows = list(range(i0, min(lc, i0 + TILE)))
                    kmax = min(lc, i0 + TILE)
                    dl = _gemm(dyc[rows].T, xc[:kmax].T)     # (rows, kmax)
                    strip = np.zeros((len(rows), kmax), F32)
                    dexp = np.zeros_like(strip)
                    for m, i in enumerate(rows):
                        for j in range(i + 1):
                            L, e = _score(cb[c, bb, i, j], cu, dtc, i, j)
                            strip[m, j] = F32(F32(dl[m, j] * e) * dtc[j])
                            dexp[m, j] = F32(dl[m, j] * L)
                    rowsum[bb, c * lc + i0:c * lc + rows[-1] + 1, h] = \
                        _row_sums(dexp)
                    at = slice(c * lc + i0, c * lc + rows[-1] + 1)
                    dCh[h, bb, at] = dCh[h, bb, at] + _gemm(strip.T, Bc[:kmax])
                for j0 in range(0, lc, TILE):       # cols_kernel
                    cols = list(range(j0, min(lc, j0 + TILE)))
                    strip = np.full((lc, len(cols)), np.nan, F32)
                    c1 = np.zeros(len(cols), F32)
                    c2 = np.zeros(len(cols), F32)
                    dl = _gemm(dyc[j0:].T, xc[cols].T)       # (lc - j0, cols)
                    Lr = np.zeros((lc - j0, len(cols)), F32)
                    for i in range(j0, lc):
                        for n, j in enumerate(cols):
                            d, dx_, ddt_ = F32(0), F32(0), F32(0)
                            if j <= i:
                                L, e = _score(cb[c, bb, i, j], cu, dtc, i, j)
                                v = dl[i - j0, n]
                                d = F32(F32(v * e) * dtc[j])
                                dx_ = F32(v * L)
                                ddt_ = F32(F32(v * cb[c, bb, i, j]) * e)
                                Lr[i - j0, n] = r(L)
                            strip[i, n] = d
                            c1[n] = c1[n] + dx_
                            c2[n] = c2[n] + ddt_
                    at = slice(c * lc + j0, c * lc + cols[-1] + 1)
                    colsum[bb, at, h], ddti[bb, at, h] = c1, c2
                    dxh[bb, at, h] = r(dxs[bb, at, h] + _gemm(Lr, dyc[j0:]))
                    dBh[h, bb, at] = dBh[h, bb, at] + _gemm(strip[j0:],
                                                            Cc[j0:])
    ddt = np.empty_like(dt)                         # finish_kernel
    dA_part = np.empty((b, nc, nh), F32)
    for bb in range(b):
        for c in range(nc):
            for h in range(nh):
                sl = slice(c * lc, (c + 1) * lc)
                cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                seg = cu[-1]
                e = _exp(seg - cu)
                sdv = (e * dtc).astype(F32)
                acc = F32(0)
                for j in range(lc):
                    acc = F32(acc + dsd[bb, c * lc + j, h] * sdv[j])
                dseg = F32(F32(dG[c, bb, h] * _exp(seg)) + acc)
                da, dA = F32(0), F32(0)
                for i in reversed(range(lc)):
                    p = c * lc + i
                    dc = F32(rowsum[bb, p, h] - colsum[bb, p, h])
                    dc = F32(dc + F32(dE[bb, p, h] * _exp(cu[i])))
                    dc = F32(dc - F32(dsd[bb, p, h] * sdv[i]))
                    if i == lc - 1:
                        dc = F32(dc + dseg)
                    da = F32(da + dc)
                    ddt[bb, p, h] = F32(F32(ddti[bb, p, h]
                                            + F32(dsd[bb, p, h] * e[i]))
                                        + F32(da * A[h]))
                    dA = F32(dA + da * dtc[i])
                dA_part[bb, c, h] = dA
    dB = np.zeros((b, s, ns), F32)                  # reduce_kernel, head order
    dC = np.zeros((b, s, ns), F32)
    for h in range(nh):
        dB, dC = dB + dBh[h], dC + dCh[h]
    dA = np.zeros(nh, F32)
    for bc in range(b * nc):
        dA = dA + dA_part.reshape(b * nc, nh)[bc]
    return r(dxh), ddt, r(dB), r(dC), dA


def _row_sums(tile):
    """A tile's rows summed in order, column tile by column tile of 64."""
    acc = np.zeros(tile.shape[0], F32)
    for q in range(tile.shape[1]):
        acc = acc + tile[:, q]
    return acc


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = want.float().numpy().astype(np.float64)
    assert np.isfinite(got).all(), f"{what}: not finite"
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err} of the largest magnitude (limit {tol})"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_scan_against_scan_ref(dtype):
    for n, shape in enumerate(SHAPES):
        lc = shape[-1]
        args = _inputs(shape, dtype, n)
        got = emulate_scan(*args, lc, dtype)
        want = ref.scan_ref(*args, lc)
        for name, a, w in zip(("y", "final", "states"), got, want):
            _close(a, w, FWD_TOL[dtype], f"{shape} {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_scan_grad_against_scan_grad_ref(dtype):
    for n, shape in enumerate(SHAPES):
        lc = shape[-1]
        args = _inputs(shape, dtype, 10 + n)
        _, final, states = ref.scan_ref(*args, lc)
        g = np.random.default_rng(n)
        dy = torch.tensor(g.normal(size=args[1].shape)).to(dtype)
        dfinal = torch.tensor(g.normal(size=final.shape)).to(dtype)
        for df in (dfinal, None):
            got = emulate_scan_grad(*args, lc, states, dy, df, dtype)
            want = ref.scan_grad_ref(*args, lc, states, dy, df)
            for name, a, w in zip(("dxh", "ddt", "dB", "dC", "dA"), got, want):
                _close(a, w, BWD_TOL[dtype], f"{shape} {name}")


def test_reduction_tree_sums_every_element_once():
    """The reverse pass's tree over 256 threads' partials: every element
    counted once, at sizes under, at and over one pass of the block."""
    for size in (16, 255, 256, 1152, 8192):
        v = np.arange(1, size + 1, dtype=F32) / 64
        assert _tree_sum(v) == F32(v.astype(np.float64).sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_step_is_step_ref_bit_for_bit(dtype):
    """step_kernel's element: xd = r(x * r(dt)), u = r(xd * B_n), s' =
    r(r(s * r(exp(dt * A))) + u), in float32 products and adds, each rounded
    as written; the window shifted; the readout in order over n."""
    r = _rounder(dtype)
    g = np.random.default_rng(3)
    b, nh, hd, ns, cw, width = 2, 3, 4, 6, 4, 20

    def t(*shape):
        return torch.tensor(g.normal(size=shape)).to(dtype)

    state, conv, window = t(b, nh, hd, ns), t(b, cw - 1, width), \
        t(b, cw, width)
    xh, Bv, Cv = t(b, nh, hd), t(b, ns), t(b, ns)
    dtv = torch.tensor(np.abs(g.normal(size=(b, nh))), dtype=torch.float32)
    A = -torch.tensor(np.exp(g.normal(size=(nh,))), dtype=torch.float32)
    st, cv = state.clone(), conv.clone()
    y = ref.step_ref(st, cv, window, xh, dtv, A, Bv, Cv)
    s_, x_, b_, c_, dtv_, A_ = _np(state, xh, Bv, Cv, dtv, A)
    da = r(_exp(dtv_ * A_))[:, :, None, None]
    xd = r(x_ * r(dtv_)[:, :, None])
    u = r(xd[..., None] * b_[:, None, None, :])
    new = r(r(s_ * da) + u)
    np.testing.assert_array_equal(new, st.float().numpy())
    assert torch.equal(cv, window[:, 1:])
    acc = np.zeros((b, nh, hd), F32)
    for n in range(ns):
        acc = acc + c_[:, None, None, n] * new[..., n]
    _close(r(acc), y, FWD_TOL[dtype], "step y")
