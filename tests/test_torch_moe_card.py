"""The MoE dispatch/combine CUDA kernel and its backward entries against
their plain versions, on the card.

The kernel has no CPU mode, so every test here carries the ``card`` marker
and asks for the ``card`` fixture, which skips it without a card.  This
file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_moe_card.py

Each entry must equal its plain version (``kernels/moe/ref.py``, run on CPU
copies) bit for bit: route's integers, dispatch's copied rows, and the
combine's sums, which take the plain version's order and rounding, and
the backward's three cotangents (``dispatch_grad``, the combine with unit
gates; ``combine_grad``; ``gate_grad``): the bits of every value that is
not NaN are equal (so -0 and +0 differ), and NaN stands in the same places
(its payload is the card's own).  A full MoE layer's gradients through
the kernels equal those through the plain versions on the card.  The
route's edge shapes (``MOE_EDGE``, ``MOE_EDGE_WIDE``) and the backward
entries at both configs' training shape run in ``chip_smoke.py``
(``moe_edge_checks``, ``moe_backward_checks``), not here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.moe import moe  # noqa: E402
from repro_torch.kernels.moe import ref  # noqa: E402
from repro_torch.kernels.moe.ref import (combine_ref, dispatch_ref,  # noqa: E402
                                         route_ref)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
#: tokens of a prefill (2 batches of 4 prompts of 512 serve in batches of
#: 4: 2048 tokens) and of a decode step (4)
TOKENS = (2048, 4)
CAPACITY_FACTORS = (1.25, 0.5)


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _routing_inputs(seed, n, e, k):
    """Router-like top-k experts and renormalised gates for n tokens."""
    rng = np.random.default_rng(seed)
    probs = torch.softmax(torch.from_numpy(rng.normal(size=(n, e))).float(),
                          dim=-1)
    gates, top_e = torch.topk(probs, k, dim=-1)
    return top_e.int(), gates / gates.sum(-1, keepdim=True)


def _rows(seed, rows, d, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(rows, d))).float().to(dtype)


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _same(got, want):
    """Bit for bit where not NaN, NaN in the same places."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), "NaN in other places"
    bits = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got[~nan].view(bits), want[~nan].view(bits))


def _check_routing(r, want):
    for name in ("slot", "keep", "rows", "stats", "dropped"):
        assert torch.equal(getattr(r, name).cpu(), getattr(want, name)), name


def _cases():
    for arch in ARCHS:
        cfg = get_config(arch)
        for n in TOKENS:
            for cf in CAPACITY_FACTORS:
                yield (cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model, n, cf)
    # ragged and extreme shapes: one token one expert; 64 experts, top-8
    yield (1, 1, 64, 1, 1.25)
    yield (64, 8, 256, 1000, 0.5)


@pytest.mark.card
def test_kernel_equals_plain_at_the_serving_shapes(card):
    """route, dispatch and combine at both MoE configs' prefill and decode
    shapes, bf16 and fp32, capacity 1.25 and 0.5 (entries drop), against
    the plain versions on CPU copies, bit for bit (the decode shapes, where
    cap >= N, without the dispatch's non-finite pass); the counters count
    one launch an entry call."""
    moe.reset_launch_count()
    calls = 0
    for seed, (e, k, d, n, cf) in enumerate(_cases()):
        cap = moe.capacity(n, k, e, cf)
        top_e, gates = _routing_inputs(seed, n, e, k)
        want = route_ref(top_e, e, cap)
        r = moe.route(top_e.to(card), e, cap, distinct=True)
        _check_routing(r, want)
        assert r.may_drop == (cap < n)      # decode: no non-finite pass
        if cf == 0.5 and n == 2048:
            assert int(want.stats[-1]) > 0
        for dtype in (torch.bfloat16, torch.float32):
            x = _rows(seed + 100, n, d, dtype)
            _same(moe.dispatch(x.to(card), r), dispatch_ref(x, want))
            ho = _rows(seed + 200, e * cap, d, dtype)
            _same(moe.combine(ho.to(card), r, gates.to(card)),
                  combine_ref(ho, want, gates))
            calls += 1
        assert moe.launch_counts() == {"route": seed + 1,
                                       "dispatch": calls, "combine": calls,
                                       "combine_grad": 0, "gate_grad": 0}


@pytest.mark.card
def test_nan_reaches_the_output_through_dropped_entries(card):
    """A NaN in every row a dropped entry points at reaches the combine's
    output through the dropped entries' zero weights, and a NaN in a
    dropped token's x reaches its slot's row of the dispatch buffer, as in
    the plain version; out-of-range and repeated experts route alike."""
    e, k, d, n = 60, 4, 2048, 2048
    cap = moe.capacity(n, k, e, 0.5)
    top_e, gates = _routing_inputs(7, n, e, k)
    top_e[0, 0], top_e[1, :2] = e + 3, 5        # out of range; a repeat
    want = route_ref(top_e, e, cap)
    r = moe.route(top_e.to(card), e, cap)
    _check_routing(r, want)
    drop = want.dropped[want.dropped >= 0].long()
    assert drop.numel() > 0
    for dtype in (torch.bfloat16, torch.float32):
        ho = _rows(8, e * cap, d, dtype)
        ho[want.slot[drop].long(), 3] = float("nan")
        ho[e * cap - 1, 5] = float("inf")
        out_want = combine_ref(ho, want, gates)
        assert bool(torch.isnan(out_want[:, 3]).any())
        _same(moe.combine(ho.to(card), r, gates.to(card)), out_want)
        x = _rows(9, n, d, dtype)
        x[drop[:3] // k, 11] = float("nan")
        x[drop[3:5] // k, 12] = float("-inf")
        buf_want = dispatch_ref(x, want)
        assert bool(torch.isnan(buf_want[:, 11]).any())
        for _ in range(2):          # the routing's counters back at zero
            _same(moe.dispatch(x.to(card), r), buf_want)
            assert r.scratch.tolist() == [0, 0, 0]


def _same_backward(dout, dbuf, ho, gates, r, want):
    """The three backward entries on the card (inputs on CPU copies)
    against their plain versions on the routing ``want``."""
    dev = r.slot.device
    _same(moe.dispatch_grad(dbuf.to(dev), r),
          ref.dispatch_grad_ref(dbuf, want))
    _same(moe.combine_grad(dout.to(dev), r, gates.to(dev)),
          ref.combine_grad_ref(dout, want, gates))
    if dout.shape[1] % 32:          # XLA's padded windows: the plain only
        with pytest.raises(ValueError, match="multiple of 32"):
            moe.gate_grad(dout.to(dev), ho.to(dev), r)
        return
    _same(moe.gate_grad(dout.to(dev), ho.to(dev), r),
          ref.gate_grad_ref(dout, ho, want))


@pytest.mark.card
def test_autograd_runs_the_backward_entries(card):
    """``moe.dispatch`` and ``moe.combine`` record autograd on the card;
    the backward launches combine (the dispatch's cotangent), combine_grad
    and gate_grad once each, equal to the plain backward on CPU copies."""
    e, k, d, n = 8, 2, 64, 40
    top_e, gates = _routing_inputs(1, n, e, k)
    cap = moe.capacity(n, k, e, 0.5)
    want = route_ref(top_e, e, cap)
    r = moe.route(top_e.to(card), e, cap)
    x = _rows(2, n, d, torch.bfloat16).to(card).requires_grad_()
    ho = _rows(3, e * cap, d, torch.bfloat16).to(card).requires_grad_()
    g = gates.to(card).requires_grad_()
    dbuf = _rows(4, e * cap, d, torch.bfloat16)
    dout = _rows(5, n, d, torch.bfloat16)
    moe.reset_launch_count()
    (dx,) = torch.autograd.grad(moe.dispatch(x, r), x, dbuf.to(card))
    dho, dg = torch.autograd.grad(moe.combine(ho, r, g), (ho, g),
                                  dout.to(card))
    assert moe.launch_counts() == {"route": 0, "dispatch": 1, "combine": 2,
                                   "combine_grad": 1, "gate_grad": 1}
    _same(dx, ref.dispatch_grad_ref(dbuf, want))
    _same(dho, ref.combine_grad_ref(dout, want, gates))
    _same(dg, ref.gate_grad_ref(dout, ho.detach().cpu(), want))
    assert r.scratch.tolist() == [0, 0, 0]


@pytest.mark.card
def test_backward_entries_equal_plain_at_small_shapes(card):
    """dispatch_grad, combine_grad and gate_grad bit for bit to the plain
    versions at small shapes, bf16 and fp32, capacity 1.25 and 0.5;
    gate_grad's windows of 32 in one level (64), two (4096: 4 windows of
    window sums in bf16) and two padded ones (4160: 130 windows, 15 zeros
    in front), and refused at widths not a multiple of 32 (40, 8).  (Both
    MoE configs' training shape, 16,384 tokens, is ``chip_smoke.py``'s:
    ``moe_backward_checks``.)"""
    shapes = [(8, 4, 64, 96), (60, 4, 40, 33), (1, 1, 8, 1),
              (8, 2, 4096, 64), (4, 2, 4160, 24)]
    for seed, (e, k, d, n) in enumerate(shapes):
        for cf in CAPACITY_FACTORS:
            cap = moe.capacity(n, k, e, cf)
            top_e, gates = _routing_inputs(seed, n, e, k)
            want = route_ref(top_e, e, cap)
            r = moe.route(top_e.to(card), e, cap, distinct=True)
            for dtype in (torch.bfloat16, torch.float32):
                _same_backward(_rows(seed + 10, n, d, dtype),
                               _rows(seed + 20, e * cap, d, dtype),
                               _rows(seed + 30, e * cap, d, dtype), gates, r,
                               want)
            assert r.scratch.tolist() == [0, 0, 0]


@pytest.mark.card
def test_backward_keeps_nan_through_dropped_entries(card):
    """A non-finite dout at a token whose dropped entry's slot is a row
    turns that row's column of dho NaN; a NaN in ho under a dropped entry
    turns its gate's cotangent NaN; a NaN in dbuf at a dropped entry's
    slot reaches dx: each as the plain version, twice (the routing's
    counters back at zero)."""
    e, k, d, n = 60, 4, 2048, 2048
    cap = moe.capacity(n, k, e, 0.5)
    top_e, gates = _routing_inputs(7, n, e, k)
    want = route_ref(top_e, e, cap)
    r = moe.route(top_e.to(card), e, cap)
    drop = want.dropped[want.dropped >= 0].long()
    for dtype in (torch.bfloat16, torch.float32):
        dout = _rows(11, n, d, dtype)
        dout[drop[:3] // k, 5] = float("inf")
        dout[drop[3:5] // k, 6] = float("nan")
        ho = _rows(12, e * cap, d, dtype)
        ho[want.slot[drop[5:8]].long(), 7] = float("nan")
        dbuf = _rows(13, e * cap, d, dtype)
        dbuf[want.slot[drop[8:10]].long(), 9] = float("nan")
        assert bool(torch.isnan(ref.combine_grad_ref(dout, want, gates)[
            want.slot[drop[:3]].long(), 5]).all())
        for _ in range(2):
            _same_backward(dout, dbuf, ho, gates, r, want)
            assert r.scratch.tolist() == [0, 0, 0]


@pytest.mark.card
def test_moe_layer_gradients_equal_the_plain_path(card):
    """One MoE layer of each smoke config on the card, bf16 and fp32 at
    capacity 0.5: the gradients for x and every parameter (router,
    experts, shared) through the kernels equal those through the plain
    versions (``ref.dispatch`` / ``ref.combine``, differentiable) on the
    same card, bit for bit."""
    import types
    plain = types.SimpleNamespace(
        capacity=ref.capacity, dispatch=ref.dispatch, combine=ref.combine,
        route=lambda top_e, e, cap, distinct=False: route_ref(top_e.int(), e,
                                                              cap))
    for arch in ARCHS:
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                                      capacity_factor=0.5)
            blocks = TM.init_params(cfg, torch.Generator().manual_seed(0))[
                "blocks"]
            p = _tree(blocks["moe"], lambda v: v[0].to(card))
            x = _rows(3, 2 * 64, cfg.d_model, getattr(torch, dtype)).view(
                2, 64, -1).to(card)
            dy = _rows(4, 2 * 64, cfg.d_model, getattr(torch, dtype)).view(
                2, 64, -1).to(card)
            grads = []
            for ops in (moe, plain):
                kernel_ops, TL.moe_ops = TL.moe_ops, ops
                try:
                    xs = x.clone().requires_grad_()
                    flat = [xs] + [v.requires_grad_() for v in
                                   _leaves(p)]
                    y, routed = TL.moe_apply(cfg, p, xs)
                    aux = TL.moe_aux_loss(cfg, routed)
                    grads.append(torch.autograd.grad(
                        (y * dy).float().sum() + aux, flat))
                finally:
                    TL.moe_ops = kernel_ops
                    for v in _leaves(p):
                        v.requires_grad_(False)
            assert int(routed[1].stats[-1]) > 0
            for a, b in zip(*grads):
                _same(a, b)


def _leaves(tree):
    return [w for v in tree.values()
            for w in (_leaves(v) if isinstance(v, dict) else [v])]


@pytest.mark.card
def test_moe_apply_on_the_card_launches_each_entry_once(card):
    """The model's MoE layer on the card goes through the three kernels
    once each and agrees with the same layer on the CPU in float32 (the
    expert products are cuBLAS's: rtol 1e-4)."""
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        blocks = TM.init_params(cfg, torch.Generator().manual_seed(0))[
            "blocks"]
        p = _tree(blocks["moe"], lambda v: v[0])
        x = _rows(3, 2 * 64, cfg.d_model, torch.float32).view(2, 64, -1)
        want, routed = TL.moe_apply(cfg, p, x)
        want_aux = TL.moe_aux_loss(cfg, routed)
        pc = _tree(p, lambda v: v.to(card))
        moe.reset_launch_count()
        got, routed = TL.moe_apply(cfg, pc, x.to(card))
        aux = TL.moe_aux_loss(cfg, routed)
        assert moe.launch_counts() == {"route": 1, "dispatch": 1,
                                       "combine": 1, "combine_grad": 0,
                                       "gate_grad": 0}
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.card
def test_geometry_mirrors_the_library(card):
    """:func:`moe.geometry` (the emulations' partitions) is the built
    kernel's launch, at the card's probed route cluster (16 or 8 blocks),
    the dispatch's rows in order and by token (both training shapes, and
    x at ROWS_IN_L2 and one token past it: the shape rule's edge)."""
    cmax = moe.library_geometry("route", 16384, 4, 8, 60, 8, torch.bfloat16)[
        "cluster"]
    assert cmax in (8, 16)
    shapes = [(2048, 4, 2048, 60, 176), (2048, 8, 1024, 32, 640),
              (4, 4, 2048, 60, 4), (4, 8, 1024, 32, 4), (11, 3, 64, 8, 2),
              (16384, 4, 2048, 60, 88), (16384, 8, 1024, 32, 5120),
              (16384, 4, 2048, 60, 1368), (4096, 4, 2048, 60, 342),
              (4097, 4, 2048, 60, 342), (1, 1, 8, 1, 1)]
    for n, k, d, e, cap in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            for entry in moe.ENTRIES:
                want = moe.geometry(entry, n, k, d, e, cap,
                                    torch.empty((), dtype=dtype).element_size(),
                                    cmax)
                assert moe.library_geometry(entry, n, k, d, e, cap,
                                            dtype) == want, (entry, n, k, d)


@pytest.mark.card
def test_launch_floor_counts_no_launch(card):
    """The launch floor (an empty kernel launched as each entry launches)
    runs at both configs' shapes and leaves the entries' counters alone."""
    moe.reset_launch_count()
    for n, k, d, e, cap in ((2048, 4, 2048, 60, 176), (4, 8, 1024, 32, 4)):
        for entry in moe.ENTRIES:
            moe.launch_floor(entry, n, k, d, e, cap, torch.bfloat16,
                             device=card)
    torch.cuda.synchronize()
    assert moe.launch_count() == 0
