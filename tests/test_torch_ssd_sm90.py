"""A numpy emulation of ``ssd_sm90.cu``'s loops, held against the plain
versions (``kernels/ssd/ref.py``) on the CPU.

The forward's two launches: the state walk of a (batch, head) (each chunk's
cumsum in order, then chunk by chunk the contribution U^T B with U =
r(sdecay x) computed in registers, the entering state written and the state
updated with the plain version's roundings); the outputs, a block a pair of
64-row tiles (the first with the last) and a group of heads, the scores'
strip r(C_I B_J^T) once for the group, each head's intra product r(L) x
with r(L) computed in registers (masked before the exp) and C_I S^T, y
rounded as the plain version rounds. The backward's four launches: the
reverse pass of a (batch, head) (gs on the tensor cores, dG as each
thread's partial over the elements it owns in each_mma's map, then the tree
over 256 threads); the heads kernel's walk over the 64-column tiles J, each
tile of dL = dy x^T computed once a head, dcb summed over the group of
heads in head order, the tile's row and column sums in the kernel's
shuffle-and-warp order, dx as sdecay (B g^T) + r(L)^T dy in one
accumulator; the groups' dcb folded in group order and the reverse cumsums;
dB and dC in one accumulator over (head, p) and then the scores' part.
Every product of both is the tensor cores' (``_mma``): each operand split
into planes (bf16 hi and lo of a product of two bf16 values; 3xTF32, the
TF32 rounding done on the float32 bits, for an fp32 operand and for every
operand in fp32), each k step of 16 (bf16) or 8 (TF32) summed exactly and
added to the fp32 accumulator; a product whose A the kernel computes in
registers (``_mma_split``: the scores r(L), dy r(exp(cums)), U; in the
forward r(L) and U) sums each step's two halves of k apart, one a
warpgroup, and adds the two partials at the end. Held at 1e-5 (forward) and
1e-4 (backward) of each tensor's largest magnitude in float32, 2e-2 in
bfloat16, on chunks of 8, 13 and 80 (two tiles of 64 a chunk, a state of
72: two column tiles), where the heads fall into two or three groups; the
splits themselves against exact products; and ``step``'s elementwise update
bit for bit ``step_ref``, its readout in the kernel's tree (a lane a chunk of
a 16-byte vector, then a butterfly over the row's lanes).
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
    """The cumsums of dt * A, a thread a (batch, chunk, head), in order:
    state_kernel's and carry_kernel's."""
    b, s, nh = dt.shape
    out = np.empty_like(dt)
    for c0 in range(0, s, lc):
        acc = np.zeros((b, nh), F32)
        for j in range(lc):
            acc = acc + dt[:, c0 + j] * A
            out[:, c0 + j] = acc
    return out


# The tensor-core products of the backward, as ssd_sm90.cu's wgmma takes
# them: each operand split into planes (BF: bf16 hi and lo; TF: TF32 hi
# and lo, the TF32 rounding cvt.rna on the float32 bits), one MMA a pair of
# planes (lo terms first, lo lo dropped), each k step of 16 (BF) or 8 (TF)
# from k_lo summed exactly and added to the fp32 accumulator.
BF, TF = "bf", "tf"
KSTEP = {BF: 16, TF: 8}
#: the k depth of a step of the kernel's products
KS = 32
#: the heads kernel's groups (group_size): blocks aimed at, groups at most,
#: heads a group at most
GROUP_BLOCKS, GROUPS_AIM, G_MAX = 256, 8, 16
SUMS_HEADS = 32


def _tf32(v):
    """cvt.rna.tf32.f32 with the low 13 bits cleared: round to nearest,
    ties away from zero, on the float32 bits."""
    bits = np.asarray(v, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(F32)


def _bf16(v):
    return torch.from_numpy(np.asarray(v, F32)).to(torch.bfloat16).float() \
        .numpy()


def _planes(v, kind, planes):
    """v's planes: hi = round(v), lo = round(v - hi) (v - hi exact)."""
    rnd = _bf16 if kind == BF else _tf32
    hi = rnd(v)
    return [hi] if planes == 1 else [hi, rnd(np.asarray(v, F32) - hi)]


def _mma(acc, a, b, kind, pa, pb):
    """acc (M, N) + sum_k a[k, m] b[k, n] on the tensor cores."""
    ap, bp = _planes(a, kind, pa), _planes(b, kind, pb)
    pairs = ([(1, 0)] if pa == 2 else []) + ([(0, 1)] if pb == 2 else []) \
        + [(0, 0)]
    acc = np.array(acc, F32)
    step = KSTEP[kind]
    for k0 in range(0, a.shape[0], step):
        for i, j in pairs:
            part = ap[i][k0:k0 + step].astype(np.float64).T \
                @ bp[j][k0:k0 + step].astype(np.float64)
            acc = (acc.astype(np.float64) + part).astype(F32)
    return acc


def _mma_split(acc, a, b, kind, pa, pb):
    """The same with A in registers: each step of KS = 32 k split between
    the two warpgroups (the first 16 k to one, the rest to the other),
    each summing its slices into its own float32 partial as ``_mma`` does;
    then acc + (partial 0 + partial 1)."""
    ap, bp = _planes(a, kind, pa), _planes(b, kind, pb)
    pairs = ([(1, 0)] if pa == 2 else []) + ([(0, 1)] if pb == 2 else []) \
        + [(0, 0)]
    parts = [np.zeros((a.shape[1], b.shape[1]), np.float64) for _ in (0, 1)]
    step = KSTEP[kind]
    for k0 in range(0, a.shape[0], step):
        wg = (k0 % KS) // (KS // 2)
        for i, j in pairs:
            part = ap[i][k0:k0 + step].astype(np.float64).T \
                @ bp[j][k0:k0 + step].astype(np.float64)
            parts[wg] = (parts[wg] + part).astype(F32)
    return (np.asarray(acc, F32) + (parts[0].astype(F32)
                                    + parts[1].astype(F32))).astype(F32)


def _kinds(dtype):
    """(T x T, a product of two T values x T, fp32 x T, T x fp32) as (kind,
    planes of A, planes of B); fp32: every operand 3xTF32."""
    if dtype == torch.float32:
        return ((TF, 2, 2),) * 4
    return (BF, 1, 1), (BF, 2, 1), (TF, 2, 1), (TF, 1, 2)


def _owners():
    """each_mma's map, wgmma's accumulator layout: (tid, q) -> (row,
    column) of a 64 x 64 tile, warpgroup tid // 128 its 32 columns."""
    tid = np.arange(THREADS)[:, None]
    q = np.arange(16)[None, :]
    lane, w, wg = tid & 31, (tid >> 5) & 3, tid >> 7
    g, t = lane >> 2, lane & 3
    m = w * 16 + g + 8 * ((q & 3) >> 1)
    n = wg * 32 + (q >> 2) * 8 + 2 * t + (q & 1)
    return m, n


OWN_M, OWN_N = _owners()


def _tree_sum(parts):
    """The block's fixed tree over its 256 threads' partials: halves."""
    part = np.array(parts, F32)
    half = THREADS // 2
    while half:
        part[:half] = part[:half] + part[half:2 * half]
        half //= 2
    return part[0]


def _pad(v, rows=TILE, cols=TILE):
    out = np.zeros((rows, cols), F32)
    out[:v.shape[0], :v.shape[1]] = v
    return out


def _tile_row_sums(v):
    """row_parts / row_total: each thread's eight values of a row (((c,
    c+1) + (c+8, c+9)) + ((c+16, c+17) + (c+24, c+25)), c = 32 wg + 2 t),
    the four lanes of the row by shuffles ((t0 + t1) + (t2 + t3)), then the
    two warpgroups in order."""
    v = _pad(v)
    lanes = []
    for t in range(4):
        c = np.array([32 * wg + 2 * t for wg in range(2)])
        lanes.append(((v[:, c] + v[:, c + 1]) + (v[:, c + 8] + v[:, c + 9]))
                     + ((v[:, c + 16] + v[:, c + 17])
                        + (v[:, c + 24] + v[:, c + 25])))
    wgs = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
    return wgs[:, 0] + wgs[:, 1]


def _tile_col_sums(v):
    """col_parts / col_total: each thread's two values of a column (r, r+8),
    the eight lanes by shuffles (xor 4, 8, 16), then the four warps of the
    warpgroup in order."""
    v = _pad(v)
    g8 = [np.stack([v[16 * w + g] + v[16 * w + g + 8] for w in range(4)])
          for g in range(8)]
    s = [g8[i] + g8[i ^ 1] for i in range(8)]
    s = [s[i] + s[i ^ 2] for i in range(8)]
    s = [s[i] + s[i ^ 4] for i in range(8)]
    return ((s[0][0] + s[0][1]) + s[0][2]) + s[0][3]


def _group_size(b, nh, lc, nc):
    pairs = (-(-lc // TILE) + 1) // 2
    g = pairs * nc * b * nh // GROUP_BLOCKS
    g = max(g, -(-nh // GROUPS_AIM))
    return max(1, min(g, G_MAX, nh))


def _masked_scores(strip, cu, dtc, rows, cols, r):
    """masked_score: r((cb * exp(cums_i - cums_j)) * dt_j) for j <= i, 0
    above the diagonal (the exponent masked before the exp), as (k = j, m =
    i)."""
    i, j = np.meshgrid(np.array(rows), np.array(cols), indexing="ij")
    low = j <= i
    e = _exp(np.where(low, cu[i] - cu[j], 0))
    L = ((strip[i - rows[0], j] * e).astype(F32) * dtc[j]).astype(F32)
    return np.where(low, r(L), 0).astype(F32).T


def emulate_scan(dt, xh, B, C, A, lc, dtype):
    """ssd_sm90.cu's forward, its two launches.  (1) state_kernel: a
    (batch, head) walks its chunks in order: the chunks' cumsums in order,
    sdecay, the contribution U^T B with U = r(sdecay x) in registers
    (``_mma_split``), the entering state written, S <- r(r(S r(exp(seg))) +
    r(contrib)).  (2) out_kernel: a block a pair of 64-row tiles (the first
    and the last, the second and the one before), a chunk, a batch and a
    group of heads: the scores' strip r(C_I B_J^T), J <= I, once for the
    group; each head's intra product r(L) x with r(L) in registers
    (``_mma_split``) and C_I S^T (``_mma``); y = r(r(intra) + r(r(C S)
    r(exp(cums_i))))."""
    r = _rounder(dtype)
    TT = _kinds(dtype)[0]
    dt, xh, B, C, A = _np(dt, xh, B, C, A)
    b, s, nh, hd = xh.shape
    ns, nc, nt = B.shape[-1], s // lc, -(-lc // TILE)
    cums = _cums(dt, A, lc)
    states = np.empty((nc, b, nh, hd, ns), F32)
    final = np.empty((b, nh, hd, ns), F32)
    for bb in range(b):                   # (1) the state walk
        for h in range(nh):
            sv = np.zeros((hd, ns), F32)
            for c in range(nc):
                sl = slice(c * lc, (c + 1) * lc)
                cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                sd = r((_exp(cu[-1] - cu) * dtc).astype(F32))
                u = r((sd[:, None] * xh[bb, sl, h]).astype(F32))
                contrib = _mma_split(np.zeros((hd, ns), F32), u, B[bb, sl],
                                     *TT)
                states[c, bb, h] = sv
                sv = r(r(sv * r(_exp(cu[-1]))) + r(contrib))
            final[bb, h] = sv
    y = np.empty_like(xh)
    gsz = _group_size(b, nh, lc, nc)
    for c in range(nc):                   # (2) the outputs
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            Bc, Cc = B[bb, sl], C[bb, sl]
            for h0 in range(0, nh, gsz):
                for bx in range((nt + 1) // 2):
                    for it in dict.fromkeys((bx, nt - 1 - bx)):
                        I0, iend = it * TILE, min(lc, (it + 1) * TILE)
                        rows = range(I0, iend)
                        strip = r(_mma(np.zeros((len(rows), iend), F32),
                                       Cc[rows].T, Bc[:iend].T, *TT))
                        for h in range(h0, min(nh, h0 + gsz)):
                            cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                            rL = _masked_scores(strip, cu, dtc, rows,
                                                range(iend), r)
                            a1 = _mma_split(np.zeros((len(rows), hd), F32),
                                            rL, xh[bb, sl, h][:iend], *TT)
                            a2 = _mma(np.zeros((len(rows), hd), F32),
                                      Cc[rows].T, states[c, bb, h].T, *TT)
                            e = r(_exp(cu[list(rows)]))[:, None]
                            y[bb, c * lc + I0:c * lc + iend, h] = r(
                                r(a1) + r(r(a2) * e))
    return y, final, states


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def emulate_scan_grad(dt, xh, B, C, A, lc, states, dy, dfinal, dtype):
    r = _rounder(dtype)
    TT, PP, FT, TF2 = _kinds(dtype)
    dt, xh, B, C, A, states, dy = _np(dt, xh, B, C, A, states, dy)
    b, s, nh, hd = xh.shape
    ns, nc, nt = B.shape[-1], s // lc, -(-lc // TILE)
    cums = _cums(dt, A, lc)
    # (1) carry: the reverse pass of a (batch, head), gs on the tensor cores
    gc = np.empty((nc, b, nh, hd, ns), F32)
    dG = np.empty((nc, b, nh), F32)
    for bb in range(b):
        for h in range(nh):
            g = (np.zeros((hd, ns), F32) if dfinal is None
                 else dfinal[bb, h].float().numpy())
            parts = np.zeros(THREADS, F32)
            for c in reversed(range(nc)):
                sl = slice(c * lc, (c + 1) * lc)
                cu = cums[bb, sl, h]
                ef = r(_exp(cu))
                dq = (dy[bb, sl, h] * ef[:, None]).astype(F32)
                gs = _mma_split(np.zeros((hd, ns), F32), dq, C[bb, sl], *PP)
                parts[:] = 0
                for p0 in range(0, hd, TILE):
                    for n0 in range(0, ns, TILE):
                        for q in range(16):
                            m, n = p0 + OWN_M[:, q], n0 + OWN_N[:, q]
                            ok = (m < hd) & (n < ns)
                            parts[ok] = _fma(g[m[ok], n[ok]],
                                             states[c, bb, h][m[ok], n[ok]],
                                             parts[ok])
                dG[c, bb, h] = _tree_sum(parts)
                gc[c, bb, h] = g
                g = (g * r(_exp(cu[-1])) + gs).astype(F32)
    # (2) heads: for each 64 columns J and group of heads
    gsz = _group_size(b, nh, lc, nc)
    ngroups = -(-nh // gsz)
    dcbp = np.zeros((ngroups, nc, b, lc, lc), F32)
    rowp = np.zeros((nt, b, s, nh), F32)
    colsum, ddti, dsd, dE = (np.zeros((b, s, nh), F32) for _ in range(4))
    dxh = np.empty_like(xh)
    for c in range(nc):
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            Bc, Cc = B[bb, sl], C[bb, sl]
            for grp in range(ngroups):
                heads = range(grp * gsz, min(nh, (grp + 1) * gsz))
                for jt in range(nt):
                    J0 = jt * TILE
                    cols = range(J0, min(lc, J0 + TILE))
                    strip = r(_mma(np.zeros((lc - J0, len(cols)), F32),
                                   Cc[J0:].T, Bc[cols].T, *TT))
                    colacc = {h: np.zeros(len(cols), F32) for h in heads}
                    ddtacc = {h: np.zeros(len(cols), F32) for h in heads}
                    for I0 in range(J0, lc, TILE):
                        rows = range(I0, min(lc, I0 + TILE))
                        i, j = np.meshgrid(np.array(rows), np.array(cols),
                                           indexing="ij")
                        low = j <= i
                        cbv = strip[i - J0, j - J0]
                        dcb = np.zeros(i.shape, F32)
                        for h in heads:
                            cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                            dl = _mma(np.zeros(i.shape, F32),
                                      dy[bb, sl, h][rows].T,
                                      xh[bb, sl, h][cols].T, *TT)
                            e = _exp(np.where(low, cu[i] - cu[j], 0))
                            L = ((cbv * e).astype(F32) * dtc[j]).astype(F32)
                            dcb = np.where(low, dcb + ((dl * e).astype(F32)
                                                       * dtc[j]), dcb)
                            dcb = dcb.astype(F32)
                            vr = np.where(low, dl * L, 0).astype(F32)
                            vd = np.where(low, ((dl * cbv).astype(F32) * e),
                                          0).astype(F32)
                            rowp[jt, bb, c * lc + I0:c * lc + rows[-1] + 1,
                                 h] = _tile_row_sums(vr)[:len(rows)]
                            colacc[h] = colacc[h] + \
                                _tile_col_sums(vr)[:len(cols)]
                            ddtacc[h] = ddtacc[h] + \
                                _tile_col_sums(vd)[:len(cols)]
                        dcbp[grp, c, bb, I0:rows[-1] + 1,
                             J0:cols[-1] + 1] = dcb
                    at = slice(c * lc + J0, c * lc + cols[-1] + 1)
                    for h in heads:
                        colsum[bb, at, h], ddti[bb, at, h] = colacc[h], \
                            ddtacc[h]
                        cu, dtc = cums[bb, sl, h], dt[bb, sl, h]
                        sdr = r((_exp(cu[-1] - cu[cols]) * dtc[cols])
                                .astype(F32))
                        x_j, dy_h = xh[bb, sl, h], dy[bb, sl, h]
                        i, j = np.meshgrid(np.arange(J0, lc), np.array(cols),
                                           indexing="ij")
                        low = j <= i
                        e = _exp(np.where(low, cu[i] - cu[j], 0))
                        rL = np.where(low, r(((strip[i - J0, j - J0] * e)
                                              .astype(F32) * dtc[j])
                                             .astype(F32)), 0).astype(F32)
                        acc_d = np.zeros(len(cols), F32)
                        acc_e = np.zeros(len(cols), F32)
                        for p0 in range(0, hd, TILE):
                            ps = range(p0, min(hd, p0 + TILE))
                            du = _mma(np.zeros((len(cols), len(ps)), F32),
                                      Bc[cols].T, gc[c, bb, h][ps].T, *TF2)
                            vr = (x_j[cols][:, ps] * du).astype(F32)
                            rs = _tile_row_sums(vr)[:len(cols)]
                            acc_d = rs if p0 == 0 else (acc_d + rs)
                            acc = (sdr[:, None] * du).astype(F32)
                            acc = _mma_split(acc, rL, dy_h[J0:, ps], *TT)
                            dxh[bb, at, h][:, ps] = r(acc)
                            q_ = _mma(np.zeros((len(cols), len(ps)), F32),
                                      Cc[cols].T, states[c, bb, h][ps].T,
                                      *TT)
                            vr = (dy_h[cols][:, ps] * r(q_)).astype(F32)
                            rs = _tile_row_sums(vr)[:len(cols)]
                            acc_e = rs if p0 == 0 else (acc_e + rs)
                        dsd[bb, at, h], dE[bb, at, h] = acc_d, acc_e
    # (3) finish: the groups' dcb folded in group order, then the reverse
    # cumsums
    dcb_all = dcbp[0].copy()
    for grp in range(1, ngroups):
        dcb_all = dcb_all + dcbp[grp]
    ddt = np.empty_like(dt)
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
                    acc = _fma(dsd[bb, c * lc + j, h], sdv[j], acc)
                dseg = F32(F32(dG[c, bb, h] * _exp(seg)) + acc)
                da, dA = F32(0), F32(0)
                for i in reversed(range(lc)):
                    p = c * lc + i
                    rowsum = F32(0)
                    for jt in range(i // TILE + 1):
                        rowsum = F32(rowsum + rowp[jt, bb, p, h])
                    dc = F32(rowsum - colsum[bb, p, h])
                    dc = F32(dc + F32(dE[bb, p, h] * _exp(cu[i])))
                    dc = F32(dc - F32(dsd[bb, p, h] * sdv[i]))
                    if i == lc - 1:
                        dc = F32(dc + dseg)
                    da = F32(da + dc)
                    ddt[bb, p, h] = F32(F32(ddti[bb, p, h]
                                            + F32(dsd[bb, p, h] * e[i]))
                                        + F32(da * A[h]))
                    dA = _fma(da, dtc[i], dA)
                dA_part[bb, c, h] = dA
    # (4) sums: dB and dC over every head in one accumulator, k = (h, p)
    dB = np.empty((b, s, ns), F32)
    dC = np.empty((b, s, ns), F32)
    for c in range(nc):
        sl = slice(c * lc, (c + 1) * lc)
        for bb in range(b):
            cu, dtc = cums[bb, sl], dt[bb, sl]            # (lc, nh)
            sdr = r((_exp(cu[-1][None, :] - cu) * dtc).astype(F32))
            ef = r(_exp(cu))
            U = r((sdr[:, :, None] * xh[bb, sl]).astype(F32))
            dq = (dy[bb, sl] * ef[:, :, None]).astype(F32)
            dcb = dcb_all[c, bb]
            accB = np.zeros((lc, ns), F32)
            accC = np.zeros((lc, ns), F32)
            for hb in range(0, nh, SUMS_HEADS):
                hs = slice(hb, min(nh, hb + SUMS_HEADS))
                u = U[:, hs].reshape(lc, -1).T              # k = (h, p)
                gk = gc[c, bb, hs].reshape(-1, ns)
                accB = _mma_split(accB, u, gk, *TF2)
                qk = dq[:, hs].reshape(lc, -1).T
                sk = states[c, bb, hs].reshape(-1, ns)
                accC = _mma_split(accC, qk, sk, *PP)
            for T0 in range(0, lc, TILE):
                rows = slice(T0, min(lc, T0 + TILE))
                accB[rows] = _mma(accB[rows], dcb[T0:, rows], C[bb, sl][T0:],
                                  *FT)
                tend = min(lc, T0 + TILE)
                accC[rows] = _mma(accC[rows], dcb[rows, :tend].T,
                                  B[bb, sl][:tend], *FT)
            dB[bb, sl], dC[bb, sl] = accB, accC
    dA = np.zeros(nh, F32)
    for bc in range(b * nc):
        dA = dA + dA_part.reshape(b * nc, nh)[bc]
    return r(dxh), ddt, r(dB), r(dC), dA


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
    """The reverse pass's dG: each thread's partial over the elements it
    owns in each_mma's map, tile by tile, then the tree over 256 threads:
    every element counted once, at states under, at and over one 64 x 64
    tile; and the tile's row and column sums (tile_row_sum / tile_col_sum)
    count every element of a row or a column once."""
    for hd, ns in ((4, 4), (8, 72), (64, 64), (64, 128), (16, 512)):
        v = (np.arange(hd * ns) % 64 + 1).astype(F32).reshape(hd, ns)
        parts = np.zeros(THREADS, F32)
        for p0 in range(0, hd, TILE):
            for n0 in range(0, ns, TILE):
                for q in range(16):
                    m, n = p0 + OWN_M[:, q], n0 + OWN_N[:, q]
                    ok = (m < hd) & (n < ns)
                    parts[ok] = parts[ok] + v[m[ok], n[ok]]
        assert _tree_sum(parts) == F32(v.astype(np.float64).sum())
    m, n = OWN_M.ravel(), OWN_N.ravel()
    assert len(set(zip(m.tolist(), n.tolist()))) == TILE * TILE
    w = np.arange(1, 40 * 50 + 1, dtype=F32).reshape(40, 50) / 64
    np.testing.assert_array_equal(_tile_row_sums(w)[:40],
                                  w.astype(np.float64).sum(1).astype(F32))
    np.testing.assert_array_equal(_tile_col_sums(w)[:50],
                                  w.astype(np.float64).sum(0).astype(F32))


def test_operand_splits():
    """3xTF32 on two fp32 operands (hi = tf32_rna(v), lo = tf32_rna(v -
    hi); hi hi' + hi lo' + lo hi') reproduces their product within 2^-20 of
    it; a product of two bf16 values splits into a bf16 hi and lo exactly;
    and the emulated tensor-core product of split fp32 operands is their
    fp32 product within 2^-20 of its largest magnitude."""
    g = np.random.default_rng(5)
    a = (g.normal(size=100_000) * np.exp(g.normal(size=100_000) * 4)) \
        .astype(F32)
    b = (g.normal(size=100_000) * np.exp(g.normal(size=100_000) * 4)) \
        .astype(F32)
    (ah, al), (bh, bl) = _planes(a, TF, 2), _planes(b, TF, 2)
    assert np.array_equal(ah.view(np.uint32) & 0x1fff, np.zeros_like(
        ah.view(np.uint32)))
    d = np.float64
    got = d(ah) * d(bh) + d(ah) * d(bl) + d(al) * d(bh)
    want = d(a) * d(b)
    assert (np.abs(got - want) <= 2.0 ** -20 * np.abs(want)).all()
    x, y = _bf16(g.normal(size=100_000)), _bf16(g.normal(size=100_000))
    p = (x * y).astype(F32)
    assert np.array_equal(d(p), d(x) * d(y))         # exact in fp32
    hi, lo = _planes(p, BF, 2)
    assert np.array_equal(d(hi) + d(lo), d(p))
    A_, B_ = g.normal(size=(40, 24)).astype(F32), \
        g.normal(size=(40, 20)).astype(F32)
    want = A_.astype(d).T @ B_.astype(d)
    got = _mma(np.zeros((24, 20), F32), A_, B_, TF, 2, 2)
    assert np.abs(got - want).max() <= 2.0 ** -20 * 40 * np.abs(want).max()


#: step_kernel's readout: a row's ns values in chunks of a 16-byte vector,
#: the chunks' count rounded up to a power of two lanes (at most 32)
STEP_LANES_MAX = 32


def _step_lanes(ns, elem):
    chunks, lanes = -(-ns // (16 // elem)), 1
    while lanes < chunks and lanes < STEP_LANES_MAX:
        lanes *= 2
    return lanes


def _step_tree(ns, elem, add, zero):
    """The readout's order over n: lane l sums chunks l, l + lanes, ... of
    V = 16 / elem values in order from ``zero`` (``add(acc, n)``), then the
    lanes meet in a butterfly, offsets lanes / 2, ..., 1, lane l adding lane
    l ^ o's sum; -> lane 0's sum."""
    v, lanes = 16 // elem, _step_lanes(ns, elem)
    part = []
    for lane in range(lanes):
        acc = zero
        for n0 in range(lane * v, ns, lanes * v):
            for n in range(n0, min(n0 + v, ns)):
                acc = add(acc, n)
        part.append(acc)
    o = lanes // 2
    while o >= 1:
        part = [part[lane] + part[lane ^ o] for lane in range(lanes)]
        o //= 2
    return part[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_step_is_step_ref_bit_for_bit(dtype):
    """step_kernel's element: xd = r(x * r(dt)), u = r(xd * B_n), s' =
    r(r(s * r(exp(dt * A))) + u), in float32 products and adds, each rounded
    as written: the state bit for bit, the window shifted; the readout in
    the kernel's tree (each lane its chunks of a 16-byte vector in order,
    then a butterfly over the row's lanes) within FWD_TOL of step_ref's, and
    the tree sums every product once, at ns 6 (a chunk or two), 40 and 128
    (8-32 lanes) and 8192 (32 lanes of many chunks)."""
    r = _rounder(dtype)
    elem = 2 if dtype == torch.bfloat16 else 4
    for ns in (6, 40, 128, 8192):
        terms = _step_tree(ns, elem, lambda acc, n: acc + [n], [])
        assert sorted(terms) == list(range(ns)), ns
    g = np.random.default_rng(3)
    for b, nh, hd, ns, cw, width in ((2, 3, 4, 6, 4, 20), (1, 2, 3, 40, 4, 16),
                                     (2, 2, 2, 128, 4, 24)):
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
        prod = (c_[:, None, None, :] * new).astype(F32)
        acc = _step_tree(ns, elem, lambda acc, n: (acc + prod[..., n]).astype(
            F32), np.zeros((b, nh, hd), F32))
        _close(r(acc), y, FWD_TOL[dtype], f"step y, ns {ns}")
