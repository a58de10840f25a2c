"""A numpy emulation of ``moe_sm90.cu``'s route against the plain routing.

The route kernel has no CPU mode, so this file runs its partition the way
the card does, step by step, and holds the result to
``kernels/moe/ref.py::route_ref`` (the plain version the card tests hold
the kernel to, bit for bit):

* the launch from :func:`repro_torch.kernels.moe.moe.geometry` (one warp up
  to 32 entries; else one cluster of up to 16 blocks of 512 threads, each
  block a contiguous share of the entries, in block order);
* a warp's ``__match_any_sync`` groups and a lane's rank, the popcount of
  its lower peers; ``__ballot_sync`` for the dropped entries;
* pass 1, each block's counts of each key (the experts, then one key for
  every expert out of range); the exchange after ``cluster.sync()``: each
  expert's base is the sum of the counts of the blocks before, in block
  order, and the dropped entries before a block are sum_e max(base_e -
  cap, 0) plus its earlier out-of-range entries;
* pass 2, tile by tile: the per-(warp, expert) counts scanned over the
  warps with the shuffle scan's steps on top of the running base, the
  dropped entries compacted by a scan of the warps' ballots;
* the -1 fills only where no entry writes (each expert's rows past its
  count, the dropped list past its total), and every written place written
  once.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.kernels.moe.ref import route_ref  # noqa: E402

WARP = 32
OUT_OF_RANGE = moe.MAX_EXPERTS


def match_ranks(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For (warps, 32) keys: each lane's count of peers (``__popc`` of its
    ``__match_any_sync`` mask) and of its lower peers."""
    same = keys[:, :, None] == keys[:, None, :]
    lower = np.tril(np.ones((WARP, WARP), dtype=bool), -1)   # [lane, peer<lane]
    return same.sum(-1), (same & lower).sum(-1)


def shfl_scan(vals: np.ndarray, width: int) -> np.ndarray:
    """``warp_scan``: the inclusive sum over the first ``width`` lanes of
    the last axis, by the kernel's shuffle steps."""
    v = vals.copy()
    o = 1
    while o < min(width, WARP):
        up = np.zeros_like(v)
        up[..., o:] = v[..., :-o]
        v = v + up                        # lanes >= o add the lane o below
        o <<= 1
    return v


def _keys(top_e: np.ndarray, lo: int, hi: int, e: int, threads: int,
          t0: int) -> np.ndarray:
    """``route_key`` of a tile's threads: expert, OUT_OF_RANGE, -1 past."""
    i = t0 + np.arange(threads)
    ex = np.where(i < hi, top_e[np.minimum(i, len(top_e) - 1)], -1)
    key = np.where((ex >= 0) & (ex < e), ex, OUT_OF_RANGE)
    return np.where(i < hi, key, -1)


def _slot(key, pos, cap, ecap):
    return np.where(key == OUT_OF_RANGE, ecap - 1,
                    np.minimum(key.astype(np.int64) * cap + pos, ecap - 1))


def _strided(start: int, end: int, b: int, threads: int, nblk: int
             ) -> np.ndarray:
    """The places block ``b``'s threads take of [start, end) in a loop
    ``idx = start + b * threads + tid; idx += nblk * threads``."""
    idx = np.arange(start, end)
    return idx[(idx - start) // threads % nblk == b]


class Out:
    """The outputs, each place's writes counted (every place once)."""

    def __init__(self, nk, e, cap):
        self.ecap = e * cap
        self.slot = np.full(nk, -7, np.int64)
        self.keep = np.zeros(nk, bool)
        self.rows = np.full(self.ecap, -7, np.int64)
        self.stats = np.full(e + 1, -7, np.int64)
        self.dropped = np.full(nk, -7, np.int64)
        self.writes = {k: np.zeros(len(getattr(self, k)), int)
                       for k in ("slot", "rows", "stats", "dropped")}

    def put(self, name, idx, val):
        idx = np.asarray(idx, np.int64).reshape(-1)
        np.add.at(self.writes[name], idx, 1)
        getattr(self, name)[idx] = np.asarray(val).reshape(-1)


def emulate_warp(top_e: np.ndarray, e: int, cap: int) -> Out:
    """``route_warp_kernel``: N·k <= 32, one warp."""
    nk = len(top_e)
    out = Out(nk, e, cap)
    key = _keys(top_e, 0, nk, e, WARP, 0)[None]
    peers, lower = match_ranks(key)
    key, peers, pos = key[0], peers[0], lower[0]
    valid = key >= 0
    ok = valid & (key != OUT_OF_RANGE)
    kept = ok & (pos < cap)
    lost = valid & ~kept
    fills = {"rows": np.arange(out.ecap), "stats": np.arange(e + 1),
             "dropped": np.arange(nk)}
    for name, idx in fills.items():            # before __syncwarp
        getattr(out, name)[idx] = -1 if name != "stats" else 0
    lanes = np.arange(WARP)
    out.put("slot", lanes[valid], _slot(key, pos, cap, out.ecap)[valid])
    out.keep[lanes[valid]] = kept[valid]
    out.put("rows", key[kept] * cap + pos[kept], lanes[kept])
    out.put("dropped", np.cumsum(lost)[lost] - 1, lanes[lost])
    leader = ok & (pos == 0)
    out.put("stats", key[leader], peers[leader])
    out.put("stats", [e], [lost.sum()])
    for name in ("rows", "stats", "dropped"):  # the fills count as one write
        out.writes[name][:] = 1
    return out


def emulate_cluster(top_e: np.ndarray, e: int, cap: int,
                    cluster_max: int = moe.MAX_CLUSTER) -> Out:
    """``route_cluster_kernel``: N·k > 32, one cluster of blocks."""
    nk = len(top_e)
    g = moe.geometry("route", nk, 1, 8, e, cap, 2, cluster_max)
    nblk, threads, share = g["blocks"], g["threads"], g["per_block"]
    assert g["cluster"] == nblk and nblk * share >= nk
    warps = threads // WARP
    out = Out(nk, e, cap)
    spans = [(b * share, min(b * share + share, nk)) for b in range(nblk)]

    # pass 1: bcnt, each block's entries a key (atomicAdd by the leaders)
    bcnt = np.zeros((nblk, OUT_OF_RANGE + 1), np.int64)
    for b, (lo, hi) in enumerate(spans):
        for t0 in range(lo, hi, threads):
            key = _keys(top_e, lo, hi, e, threads, t0).reshape(warps, WARP)
            peers, lower = match_ranks(key)
            lead = (key >= 0) & (lower == 0)
            np.add.at(bcnt[b], key[lead], peers[lead])
    # cluster.sync(); each block reads every block's counts
    for b, (lo, hi) in enumerate(spans):
        keys = list(range(e)) + [OUT_OF_RANGE]
        before = np.array([bcnt[:b, j].sum() for j in keys])
        total = np.array([bcnt[:, j].sum() for j in keys])
        d_before = np.maximum(before[:e] - cap, 0).sum() + before[e]
        n_dropped = np.maximum(total[:e] - cap, 0).sum() + total[e]
        base = before[:e].copy()
        # the fills, block b's stride of the cluster
        idx = _strided(0, out.ecap, b, threads, nblk)
        fill = idx[idx % cap >= total[idx // cap]]
        out.put("rows", fill, -1)
        out.put("dropped", _strided(n_dropped, nk, b, threads, nblk), -1)
        if b == 0:
            out.put("stats", np.arange(e), total[:e])
            out.put("stats", [e], [n_dropped])
        # pass 2
        drun = d_before
        for t0 in range(lo, hi, threads):
            i = (t0 + np.arange(threads)).reshape(warps, WARP)
            key = _keys(top_e, lo, hi, e, threads, t0).reshape(warps, WARP)
            valid = key >= 0
            ok = valid & (key != OUT_OF_RANGE)
            peers, lower = match_ranks(key)
            cnt = np.zeros((warps, moe.MAX_EXPERTS), np.int64)
            lead = ok & (lower == 0)
            w_idx = np.nonzero(lead)
            cnt[w_idx[0], key[lead]] = peers[lead]
            incl = shfl_scan(cnt[:, :e].T, warps).T     # over the warps
            cnt[:, :e] = base + incl - cnt[:, :e]
            base = base + incl[-1]
            pos = np.where(ok, cnt[np.arange(warps)[:, None],
                                   np.where(ok, key, 0)] + lower, 0)
            kept = ok & (pos < cap)
            out.put("slot", i[valid], _slot(key, pos, cap, out.ecap)[valid])
            out.keep[i[valid]] = kept[valid]
            out.put("rows", (key * cap + pos)[kept], i[kept])
            lost = valid & ~kept
            wdrop = lost.sum(1)
            incl = shfl_scan(wdrop, warps)
            off = (incl - wdrop)[:, None] + np.cumsum(lost, 1) - lost
            out.put("dropped", (drun + off)[lost], i[lost])
            drun += incl[-1]
    return out


def emulate(top_e: np.ndarray, e: int, cap: int,
            cluster_max: int = moe.MAX_CLUSTER) -> Out:
    top_e = np.asarray(top_e).reshape(-1)
    if len(top_e) <= moe.WARP_ENTRIES:
        return emulate_warp(top_e, e, cap)
    return emulate_cluster(top_e, e, cap, cluster_max)


def check_against_ref(top_e: np.ndarray, e: int, cap: int,
                      cluster_max: int = moe.MAX_CLUSTER) -> Out:
    got = emulate(top_e, e, cap, cluster_max)
    want = route_ref(torch.from_numpy(np.asarray(top_e, np.int32)), e, cap)
    for name in ("slot", "keep", "rows", "stats", "dropped"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name).numpy(), name)
    for name, w in got.writes.items():
        assert (w == 1).all(), f"{name}: places written {set(w.tolist())} times"
    return got


def _topk(seed: int, n: int, e: int, k: int, skew: float = 0.0) -> np.ndarray:
    """Router-like choices: k distinct experts a token, from logits with a
    ``skew`` toward the low experts (a collapsed router overflows them)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, e)) - skew * np.arange(e) / max(e - 1, 1)
    return np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32)


# (name, n, e, k, cap): each a case of the kernel's partition
CASES = [
    # qwen2-moe-a2.7b's prefill: 8192 entries, 16 shares of one tile each
    ("shares_whole_tiles", 2048, 60, 4, 176),
    # 16 shares of 523: a tile and a ragged one, the last share shorter
    ("shares_ragged", 2091, 32, 4, 80),
    # below the cluster's threads: one block (33) and four blocks (1800)
    ("one_block", 11, 8, 3, 2),
    ("few_blocks", 450, 12, 4, 40),
    # one expert; 64 experts at top-8; top-1
    ("one_expert", 700, 1, 1, 300),
    ("e64_top8", 1000, 64, 8, 40),
    ("top1", 3000, 16, 1, 200),
    # cap 1, and every expert over its capacity (a collapsed router)
    ("cap_one", 777, 24, 2, 1),
    ("all_overflow", 2048, 32, 8, 12),
]


@pytest.mark.parametrize("name,n,e,k,cap", CASES, ids=[c[0] for c in CASES])
def test_cluster_route_equals_the_plain_routing(name, n, e, k, cap):
    top_e = _topk(zlib.crc32(name.encode()), n, e, k, skew=3.0)
    got = check_against_ref(top_e, e, cap)
    nk = n * k
    g = moe.geometry("route", n, k, 8, e, cap, 2)
    assert g["cluster"] >= 1 and g["blocks"] * g["per_block"] >= nk
    if name == "shares_whole_tiles":
        assert (g["blocks"], g["per_block"]) == (16, 512)
    if name == "shares_ragged":
        assert nk % g["per_block"] and g["per_block"] > moe.ROUTE_THREADS
    if name == "all_overflow":
        assert (got.stats[:e] > cap).all()
    if name in ("one_block", "few_blocks"):
        assert g["blocks"] == -(-nk // moe.ROUTE_THREADS) < moe.MAX_CLUSTER


@pytest.mark.parametrize("nk_shape", [(1, 1), (4, 4), (4, 8)],
                         ids=["one_entry", "qwen2_moe_decode",
                              "granite_moe_decode"])
def test_warp_route_at_the_decode_shape(nk_shape):
    """N·k <= 32 (qwen2-moe-a2.7b's decode: 4 x 4, granite-moe-1b-a400m's:
    4 x 8) is the one-warp route; with a repeated expert, one out of range
    and a capacity that drops entries."""
    n, k = nk_shape
    for e, cap in ((60, 4), (32, 1), (1, 1)):
        top_e = _topk(n * k + e, n, max(e, k), k) % max(e, 1)
        top_e = top_e.reshape(-1)
        if len(top_e) > 2:
            top_e[1] = top_e[0]                       # a repeat
            top_e[-1] = e + 5                         # out of range
        assert moe.geometry("route", n, k, 8, e, cap, 2)["cluster"] == 0
        check_against_ref(top_e.reshape(n, k), e, cap)


def test_experts_out_of_range_and_the_cluster_size():
    """Negative and too-large experts drop into the last row, in entry
    order with the overflow; the result does not depend on how many blocks
    the card co-schedules (the kernel probes 16, 8, ...)."""
    rng = np.random.default_rng(5)
    top_e = rng.integers(-3, 40, size=(1500, 4)).astype(np.int32)
    outs = [check_against_ref(top_e, 36, 50, cm) for cm in (16, 8, 4, 1)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o.dropped, outs[0].dropped)
    assert outs[0].stats[-1] > ((top_e < 0) | (top_e >= 36)).sum()


def test_65536_entries_walk_their_shares_in_tiles():
    """The consistency prefill's 32 x 512 tokens of qwen2-moe-a2.7b: 65,536
    entries, 16 shares of 8 tiles, each block carrying its running counts
    from tile to tile; at capacity 1.25 and at a capacity that drops."""
    top_e = _topk(11, 16384, 60, 4, skew=1.0)
    g = moe.geometry("route", 16384, 4, 8, 60, 0, 2)
    assert g["per_block"] == 8 * moe.ROUTE_THREADS
    for cf in (1.25, 0.5):
        cap = moe.capacity(16384, 4, 60, cf)
        got = check_against_ref(top_e, 60, cap)
        assert got.stats[-1] > 0


def test_geometry_mirrors_the_kernels_launches():
    """The launches :func:`moe.geometry` gives at both MoE configs' serving
    shapes (the dispatch's rows in order) and training shape (the dispatch
    and combine_grad by token: 264 zero blocks, then the token blocks); the
    card tests hold it to the built library's."""
    g = moe.geometry
    assert g("route", 2048, 8, 1024, 32, 640, 2)["per_block"] == 1024
    assert g("route", 4, 8, 1024, 32, 4, 2)["threads"] == 32
    assert g("dispatch", 2048, 4, 2048, 60, 176, 2)["per_block"] == 2
    assert g("dispatch", 2048, 8, 1024, 32, 640, 2)["per_block"] == 4
    assert g("dispatch", 2048, 8, 1024, 32, 640, 2)["blocks"] == 5120
    for entry in ("dispatch", "combine_grad"):
        assert g(entry, 16384, 8, 1024, 32, 5120, 2) == {
            "blocks": 264 + 4096, "threads": 256, "cluster": 0,
            "per_block": 4}
        assert g(entry, 16384, 4, 2048, 60, 1368, 2)["blocks"] == 264 + 8192
    assert g("combine", 2048, 8, 1024, 32, 640, 2)["per_block"] == 2
    assert g("combine", 2048, 4, 2048, 60, 176, 4)["per_block"] == 1
    with pytest.raises(ValueError):
        g("sort", 1, 1, 8, 1, 1, 2)


def _round(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 values rounded to ``dtype`` (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        dtype).float().numpy()


def emulate_gate_grad(dout: torch.Tensor, ho: torch.Tensor, slot, keep,
                      k: int) -> np.ndarray:
    """``gate_grad_kernel``'s loop in numpy float32: warp i takes entry i;
    lane l takes windows l, l + 32, ... of 32 elements, each window's
    vectors' elements in order, each product and each add rounded to the
    compute dtype, into the warp's shared row; while more than 32 sums
    remain, lane u sums window u of them (the first ``pad // 2`` places
    before the row add nothing) and the warp writes them back; lane 0 sums
    the rest in order and writes +0 + sum · keep."""
    dt = dout.dtype
    d = dout.shape[1]
    assert d % 32 == 0
    a = dout.float().numpy()[np.arange(slot.numel()) // k]
    b = ho.float().numpy()[slot.numpy()]
    windows = d // 32
    row = np.zeros((a.shape[0], windows), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for lane in range(WARP):
            for w in range(lane, windows, WARP):
                acc = np.zeros(a.shape[0], np.float32)
                for c in range(32 * w, 32 * w + 32):
                    p = _round(a[:, c] * b[:, c], dt)
                    acc = _round(acc + p, dt)
                row[:, w] = acc
        n = windows
        while n > 32:
            pad = (32 - n % 32) % 32
            m = (n + pad) // 32
            nxt = np.zeros((a.shape[0], m), np.float32)
            for lane in range(m):
                acc = np.zeros(a.shape[0], np.float32)
                for j in range(32):
                    at = lane * 32 - pad // 2 + j
                    if 0 <= at < n:
                        acc = _round(acc + row[:, at], dt)
                nxt[:, lane] = acc
            row[:, :m] = nxt
            n = m
        acc = np.zeros(a.shape[0], np.float32)
        for j in range(n):
            acc = _round(acc + row[:, j], dt)
        return (np.float32(0) + acc * keep.numpy().astype(np.float32)
                ).astype(np.float32)


def test_gate_grad_and_combine_grad_emulations_equal_the_plain_versions():
    """The backward entries' arithmetic before the card: the gate_grad
    kernel's windows (:func:`emulate_gate_grad`) and the weighted dispatch
    of combine_grad (each kept row ``+0 + cdt(dout · cdt(gate))``, a
    dropped entry's slot NaN where its token's dout is not finite) against
    ``ref.gate_grad_ref`` and ``ref.combine_grad_ref`` bit for bit, in bf16
    and fp32, at D of 3 windows (fewer than a warp's lanes), 2 and 32
    windows (one sum of the window sums), 64 windows (a second level of
    windows, 2 of them) and 130 windows (a second level whose windows are
    padded: 5 windows, 15 and 15 zeros), with -0, inf and NaN among the
    values and entries dropped (+0 at a dropped finite entry)."""
    from repro_torch.kernels.moe import ref

    rng = np.random.default_rng(21)
    for dtype, d in ((torch.bfloat16, 96), (torch.float32, 64),
                     (torch.bfloat16, 1024), (torch.float32, 2048),
                     (torch.bfloat16, 4160)):
        n, e, k = 64, 8, 4
        top_e = torch.from_numpy(_topk(d, n, e, k, skew=2.0))
        cap = moe.capacity(n, k, e, 0.5)
        r = route_ref(top_e, e, cap)
        drop = r.dropped[r.dropped >= 0].long()
        assert drop.numel() > 0
        dout = torch.from_numpy(rng.normal(size=(n, d))).to(dtype)
        ho = torch.from_numpy(rng.normal(size=(e * cap, d))).to(dtype)
        dout[0, :5] = -0.0
        dout[drop[:2] // k, 3] = float("inf")
        ho[r.slot[drop[2:4]].long(), 1] = float("nan")
        gates = torch.from_numpy(rng.random((n, k))).float()
        got = torch.from_numpy(emulate_gate_grad(dout, ho, r.slot, r.keep, k))
        want = ref.gate_grad_ref(dout, ho, r).view(-1)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok].view(torch.int32), want[ok].view(torch.int32))
        assert bool(torch.isnan(want[drop[:4]]).all())
        finite = drop[4:][torch.isfinite(want[drop[4:]])]
        assert finite.numel() and not bool(torch.signbit(want[finite]).any())

        w = (gates.reshape(-1) * r.keep).to(dtype)
        buf = torch.zeros((e * cap, d), dtype=dtype)
        for row in range(e * cap):
            i = int(r.rows[row])
            if i >= 0:
                buf[row] = torch.zeros(d, dtype=dtype) + dout[i // k] * w[i]
        for i in drop.tolist():
            bad = ~torch.isfinite(dout[i // k])
            buf[int(r.slot[i]), bad] = float("nan")
        dho = ref.combine_grad_ref(dout, r, gates)
        assert torch.equal(torch.isnan(dho), torch.isnan(buf))
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        ok = ~torch.isnan(buf)
        assert torch.equal(dho[ok].view(bits), buf[ok].view(bits))
        assert not bool((dho.view(bits) == torch.tensor(-0.0, dtype=dtype)
                         .view(bits)).any())          # +0 + p: no -0
