"""A numpy emulation of ``moe_sm90.cu``'s dispatch kernel (the entries
``dispatch`` and ``combine_grad``) against the plain versions.

The kernel has no CPU mode, so this file runs its schedule the way the card
does and holds the result to ``kernels/moe/ref.py``'s ``dispatch_ref`` and
``combine_grad_ref`` bit for bit (the plain versions the card tests hold the
kernel to):

* the launch from :func:`repro_torch.kernels.moe.moe.geometry`, its order
  from :func:`moe.by_token` (x's bytes past ``ROWS_IN_L2``);
* rows in order: block b copies rows [b·rpb, ...), each row gathering its
  entry's token row (a row of zeros where ``rows`` is -1);
* by token: the zero blocks first, the rows no entry fills (expert x's rows
  past ``min(stats[x], cap)``) as one list in expert order, a warp a row,
  the row found by the kernel's binary search over the zero rows' prefix;
  then the token blocks, each staging its entries' slots (kept where
  ``rows[slot]`` is the entry) and weights, reading each token row once and
  storing it at every kept entry's slot;
* every row of the buffer written once before the non-finite pass, which
  stores NaN at the dropped entries' slots where their token's value is not
  finite (only if one is);
* each stored value: a copy (dispatch), or ``+0 + cdt(x · cdt(gate))``
  (combine_grad: -0 becomes +0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe import moe, ref  # noqa: E402

WARP = 32
F32 = np.float32


def _round(v, dtype):
    """float32 values rounded to ``dtype`` (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(v, F32)).to(dtype).float() \
        .numpy()


def _value(xrows, w, dtype):
    """The stored rows: copies (w None) or +0 + cdt(x · w) with w an entry,
    as ``Terms<T>::add`` from a zero accumulator."""
    if w is None:
        return xrows
    with np.errstate(invalid="ignore", over="ignore"):
        p = _round(xrows * w[:, None], dtype)
        return _round(F32(0) + p, dtype)


class Buffer:
    """The (E·cap, D) buffer as float32 values, each row's stores and each
    token row's loads counted."""

    def __init__(self, ecap, d, n):
        self.val = np.full((ecap, d), F32(7.0))
        self.stores = np.zeros(ecap, int)
        self.loads = np.zeros(n, int)

    def put(self, rows, v):
        self.val[rows] = v
        np.add.at(self.stores, rows, 1)


def zero_rows(stats, e, cap, zblocks):
    """``zero_rows``: the rows no entry fills in the order the zero blocks'
    warps take them (q = block·8 + warp, striding by zblocks·8), each found
    by the kernel's binary search over the prefix."""
    c = np.minimum(stats[:e], cap)
    z = cap - c
    base = np.concatenate([[0], np.cumsum(z)])      # the warp scan's sums
    first = np.arange(e) * cap + c
    warps = zblocks * (moe.COPY_THREADS // WARP)
    out = []
    for w0 in range(min(warps, base[e])):
        for q in range(w0, base[e], warps):
            lo, hi = 0, e - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if base[mid] <= q:
                    lo = mid
                else:
                    hi = mid - 1
            out.append(first[lo] + q - base[lo])
    return np.asarray(out, np.int64)


def emulate(x, r, gates=None, d=None):
    """``dispatch_kernel``'s schedule on x (N, D') with the routing ``r``:
    the launch as ``moe.geometry`` gives it at D columns (``d``, by default
    D'), the values at x's own D' columns (each column the same function).
    -> (Buffer, order)."""
    dtype = x.dtype
    n, dx = x.shape
    d = dx if d is None else d
    k, e, cap = r.top_k, r.num_experts, r.cap
    ecap = e * cap
    elem = x.element_size()
    entry = "dispatch" if gates is None else "combine_grad"
    g = moe.geometry(entry, n, k, d, e, cap, elem)
    xs = x.float().numpy()
    rows, slot = r.rows.numpy(), r.slot.numpy()
    stats = r.stats.numpy()
    w = (None if gates is None else
         _round(gates.float().numpy().reshape(-1), dtype))   # gate · keep(1)
    buf = Buffer(ecap, dx, n)
    by_token = moe.by_token(n, d, elem)
    if not by_token:
        rpb = g["per_block"]
        assert g["blocks"] == -(-ecap // rpb)
        for b in range(g["blocks"]):
            mine = np.arange(b * rpb, min(b * rpb + rpb, ecap))
            i = rows[mine]
            buf.put(mine[i < 0], np.zeros(dx, F32))
            full, i = mine[i >= 0], i[i >= 0]
            np.add.at(buf.loads, i // k, 1)
            buf.put(full, _value(xs[i // k], None if w is None else w[i],
                                 dtype))
    else:
        tpb = g["per_block"]
        tblocks = -(-n // tpb)
        zblocks = g["blocks"] - tblocks
        assert zblocks == min(-(-ecap // (moe.COPY_THREADS // WARP)),
                              moe.ZERO_BLOCKS)
        buf.put(zero_rows(stats, e, cap, zblocks), np.zeros(dx, F32))
        for b in range(tblocks):
            t0 = b * tpb
            nt = min(tpb, n - t0)
            ent = t0 * k + np.arange(nt * k)
            s = slot[ent]
            kept = rows[s] == ent                        # the staged slots
            buf.loads[t0:t0 + nt] += 1                   # one load a vector
            i = ent[kept]
            buf.put(s[kept], _value(xs[i // k], None if w is None else w[i],
                                    dtype))
    assert (buf.stores == 1).all(), "a row not written once before the pass"
    nd = int(stats[e]) if r.may_drop else 0
    drop = r.dropped.numpy()[:nd]
    bad = ~np.isfinite(xs[drop // k])
    if bad.any():                                       # flagged: the pass
        for i, cols in zip(drop, bad):
            buf.val[slot[i], cols] = np.nan
    return buf, ("tokens" if by_token else "rows")


def _topk(seed, n, e, k, skew=0.0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, e)) - skew * np.arange(e) / max(e - 1, 1)
    return np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)


def _same(buf, want):
    """Bit for bit, NaN in the same places."""
    got, w = buf.val, want.float().numpy()
    nan = np.isnan(w)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  w[~nan].view(np.uint32))


def _check(x, r, gates, d=None):
    """Both entries' emulations against the plain versions; returns the
    order taken and the dispatch's buffer."""
    b, order = emulate(x, r, None, d)
    _same(b, ref.dispatch_ref(x, r))
    bg, order_g = emulate(x, r, gates, d)
    want = ref.combine_grad_ref(x, r, gates)
    _same(bg, want)
    assert order_g == order
    zero = bg.val == 0
    assert not np.signbit(bg.val[zero]).any(), "combine_grad stored -0"
    if order == "tokens":
        assert (b.loads == 1).all(), "a token row read more than once"
    else:
        assert b.loads.sum() == int((r.rows >= 0).sum())
    return order, b


def _values(seed, n, d, dtype, drop_tokens):
    """Rows with -0, inf and NaN, the last two at tokens with dropped
    entries."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, d))).to(dtype)
    x[0, :3] = -0.0
    x[1, 2] = -0.0
    if len(drop_tokens):
        x[drop_tokens[0], 1] = float("inf")
        x[drop_tokens[-1], 0] = float("nan")
    return x


#: (name, n, e, k, cap or capacity factor): drops, E = 1, cap 1, k = 8,
#: experts out of range
CASES = [("drops", 64, 8, 4, 0.5), ("e1_cap1", 40, 1, 1, 1),
         ("cap_one", 37, 24, 2, 1), ("top8", 48, 16, 8, 1.25),
         ("out_of_range", 50, 12, 3, 1.0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_both_orders_equal_the_plain_versions(case, dtype):
    """Each case in both orders (its own D: rows in order; a D whose x is
    past ROWS_IN_L2: by token), bit for bit, NaN and inf through dropped
    entries, -0 copied by the dispatch and +0 in combine_grad."""
    name, n, e, k, c = case
    top_e = _topk(n + e, n, max(e, k), k, skew=2.0) % e
    if name == "out_of_range":
        top_e[::7, 0] = -1
        top_e[3::7, -1] = e + 2
    cap = c if isinstance(c, int) else moe.capacity(n, k, e, c)
    r = ref.route_ref(torch.from_numpy(top_e), e, cap)
    drop = r.dropped[r.dropped >= 0].numpy()
    d = 64 if dtype == torch.bfloat16 else 32
    x = _values(n, n, d, dtype, drop // k)
    gates = torch.from_numpy(np.random.default_rng(e).random((n, k))).float()
    big = 4 * moe.ROWS_IN_L2 // (n * x.element_size())
    orders = [_check(x, r, gates)[0], _check(x, r, gates, d=big)[0]]
    assert orders == ["rows", "tokens"]
    if name in ("drops", "cap_one", "out_of_range"):
        assert len(drop) > 0


def test_zero_rows_are_the_rows_no_entry_fills():
    """The zero blocks' list (each expert's rows past its count, found by
    the binary search over the prefix) is exactly the rows ``rows`` marks
    -1, each once, whatever the number of zero blocks; experts with no
    zero row, and one with every row, among them."""
    rng = np.random.default_rng(3)
    for e, cap in ((1, 1), (5, 3), (64, 40), (32, 160)):
        top_e = rng.integers(0, e, size=(e * cap // 2 + 3, 1)).astype(np.int32)
        top_e[: cap + 2] = 0                    # expert 0 over capacity
        if e > 2:
            top_e[top_e == e - 1] = 0           # the last expert empty
        r = ref.route_ref(torch.from_numpy(top_e), e, cap)
        want = np.sort(np.nonzero(r.rows.numpy() < 0)[0])
        for zblocks in (1, 3, moe.ZERO_BLOCKS):
            got = zero_rows(r.stats.numpy(), e, cap, zblocks)
            np.testing.assert_array_equal(np.sort(got), want)
            assert len(set(got.tolist())) == len(got)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"])
def test_training_shape_goes_by_token(arch):
    """Both MoE configs' training shape (8 x 2048 tokens, their D, cf 1.25
    and 0.5): ``moe.geometry``'s launch is by token (x is 33.5 / 67.1 MB),
    and its schedule, emulated at 4 columns of the values, equals the plain
    versions bit for bit with each token row read once; the prefill shape
    (4 x 512) keeps the rows in order."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    n = 8 * 2048
    assert moe.by_token(n, d, 2) and not moe.by_token(2048, d, 2)
    g = moe.geometry("combine_grad", n, k, d, e, moe.capacity(
        n, k, e, 1.25), 2)
    assert g["per_block"] == 4096 // d and g["blocks"] == \
        moe.ZERO_BLOCKS + n // g["per_block"]
    top_e = _topk(len(arch), n, e, k, skew=0.5)
    gates = torch.from_numpy(np.random.default_rng(1).random((n, k))).float()
    for cf in (1.25, 0.5):
        cap = moe.capacity(n, k, e, cf)
        r = ref.route_ref(torch.from_numpy(top_e), e, cap)
        drop = r.dropped[r.dropped >= 0].numpy()
        x = _values(k, n, 4, torch.bfloat16, drop // k)
        order, b = _check(x, r, gates, d=d)
        assert order == "tokens"
        assert bool(np.isnan(b.val).any()) == (len(drop) > 0)
        assert cf == 1.25 or len(drop) > 0


def test_geometry_of_both_orders():
    """The launches the rule gives: rows in order at the serving shapes
    (the buffer's rows over rpb), by token past ROWS_IN_L2 (at most
    ZERO_BLOCKS zero blocks first, then COPY_SPREAD token blocks or more
    where N allows)."""
    g = moe.geometry
    assert g("dispatch", 2048, 8, 1024, 32, 640, 2) == {
        "blocks": 32 * 640 // 4, "threads": 256, "cluster": 0, "per_block": 4}
    assert g("dispatch", 4, 4, 2048, 60, 4, 2)["blocks"] == 60 * 4 // 2
    big = g("combine_grad", 16384, 4, 2048, 60, 1368, 2)
    assert big == {"blocks": 264 + 8192, "threads": 256, "cluster": 0,
                   "per_block": 2}
    small_n = g("dispatch", 200, 8, 65536, 8, 20, 2)       # 26 MB of x
    assert small_n["per_block"] == 1 and small_n["blocks"] == 20 + 200
    assert moe.by_token(16384, 1024, 2) and not moe.by_token(8192, 1024, 2)
