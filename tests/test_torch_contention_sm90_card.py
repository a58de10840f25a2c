"""The Hopper contention kernel ``csrc/contention_sm90.cu`` against its
plain version and the numpy emulations of its loop, on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_contention_sm90_card.py

The kernel must equal the plain version (``kernels/contention/ref.py``) bit
for bit, and its per-plan counts (rounds, events, filling rounds, replay
steps) those of the numpy emulation of the first port's loop
(``tests/contention_emulation.py::emulate``) and, with the merged rounds,
the emulation of its own (``emulate_sm90``): on random buckets on both
sides of the one-warp threshold and past 1024 transfers, on the campaign's
netbound grid, at the §6.1 fork-join's scale (1000 tasks), and on a bucket
with NaN inputs (NaN where the plain version has it).  The sweep path must
launch it once per group; a ``kernel=`` choice and oversize shapes raise;
the split variant and the chain probe run.
"""
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.network as TN  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.contention import contention as C  # noqa: E402
from repro_torch.sim.adapters import CommAwareHLPScheduler  # noqa: E402
from repro_torch.sim.scenarios import netbound_scenario  # noqa: E402

from contention_emulation import (emulate, emulate_sm90,  # noqa: E402
                                  random_bucket)

ITERS = TN.CONTENTION_ITERS
pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _netbound_groups(width=12, depth=5, n_scen=6):
    items = []
    for i in range(n_scen):
        sc = netbound_scenario(width=width, depth=depth, seed=300 + i)
        for mk in (lambda: T.make_scheduler("hlp_ols"),
                   lambda: CommAwareHLPScheduler(contention=True)):
            items.append((sc.graph, mk().allocate(sc.graph, sc.machine)))
    nets = [T.make_network("maxmin_fair")] * len(items)
    return items, nets, TB.contended_buckets(items, nets)[1]


def _both(cb, L, card, iters=ITERS, emulated=None):
    """The kernel's durations and counts, checked against the plain
    version and the first port's counts (its loop's numpy emulation) on
    ``emulated``, the bucket's first plans (all of them by default)."""
    args = [t.to(card) for t in cb.tensors()]
    got, counts = C.launch(*args, num_links=L, iters=iters)
    torch.cuda.synchronize()
    got, counts = got.cpu().numpy(), counts.cpu().numpy()
    want = C.contended_durations(*cb.tensors(), num_links=L,
                                 iters=iters).numpy()
    np.testing.assert_array_equal(got, want)
    emulated = cb if emulated is None else emulated
    np.testing.assert_array_equal(counts[:emulated.size.shape[0], :4],
                                  emulate(emulated, L, iters)[1])
    assert (counts[:, 4] <= counts[:, 1]).all()
    return counts


def test_sm90_equals_plain_and_block_on_random_buckets(card):
    """T_pad 31 (one warp), 64 and 100 (a thread a transfer), 600 (512
    threads, K = 2) and 2000 (256 threads, K = 8), and a one-link bucket
    and a 1e9 capacity, whose filling loops end on their round limit and on
    the guard."""
    rng = np.random.default_rng(11)
    for B, n, P, Tn, iters in ((3, 40, 4, 100, 4), (2, 64, 8, 600, 2),
                               (4, 33, 3, 31, 1), (2, 20, 40, 64, 4),
                               (2, 30, 3, 2000, 1)):
        cb = random_bucket(rng, B=B, n=n, P=P, T=Tn)
        counts = _both(cb, 4, card, iters)
        if Tn <= 128:
            np.testing.assert_array_equal(counts, emulate_sm90(cb, 4,
                                                               iters)[1])
    cb = random_bucket(np.random.default_rng(5), B=3, n=30, P=3, T=48)
    for bucket, L in ((dataclasses.replace(cb, up=torch.zeros_like(cb.up),
                                           dn=torch.zeros_like(cb.dn)), 1),
                      (dataclasses.replace(cb, size=cb.size * 1e9,
                                           capacity=cb.capacity * 1e9), 4)):
        counts = _both(bucket, L, card)
        np.testing.assert_array_equal(counts, emulate_sm90(bucket, L,
                                                           ITERS)[1])
        assert counts[:, 4].sum() < counts[:, 1].sum()


def test_sm90_equals_plain_on_the_campaign_netbound_grid(card):
    _, _, groups = _netbound_groups()
    froze = 0
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        counts = _both(cb, L, card)
        np.testing.assert_array_equal(counts, emulate_sm90(cb, L, ITERS)[1])
        froze += int((counts[:, 0] < ITERS).sum())
    assert froze >= 1


def test_sm90_equals_plain_at_the_fork_join_scale(card):
    """Seeds 300-301 at width 100, depth 10: 1000 tasks, T_pad 1024, on
    512 threads (K = 2); the first plan's counts against the emulation."""
    _, _, groups = _netbound_groups(width=100, depth=10, n_scen=2)
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        assert n_pad == 1024 and C.threads(cb.size.shape[1]) == 512
        first = dataclasses.replace(
            cb, **{f.name: getattr(cb, f.name)[:1]
                   for f in dataclasses.fields(cb)})
        counts = _both(cb, L, card, emulated=first)
        np.testing.assert_array_equal(counts[:1],
                                      emulate_sm90(first, L, ITERS)[1])


def test_both_kernels_keep_nan_where_the_plain_version_does(card):
    """A NaN task time in plan 0 and a NaN size in plan 1 (the bucket of
    ``tests/test_torch_contention.py``): NaN at the same places, every
    other value bit-equal."""
    cb = random_bucket(np.random.default_rng(9), B=3, n=24, P=3, T=32)
    times, size = cb.times.clone(), cb.size.clone()
    times[0, int(cb.src[0, 0])] = float("nan")
    size[1, int(cb.pred_tid[1][cb.pred_tid[1] >= 0][0])] = float("nan")
    cb = dataclasses.replace(cb, times=times, size=size)
    want = C.contended_durations(*cb.tensors(), num_links=4,
                                 iters=ITERS).numpy()
    assert np.isnan(want[0]).any() and np.isnan(want[1]).any()
    args = [t.to(card) for t in cb.tensors()]
    got = C.launch(*args, num_links=4, iters=ITERS)[0]
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_bucketed_path_launches_sm90_once_per_group(card):
    items, nets, groups = _netbound_groups(n_scen=3)
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   range(4)) for g, p in items]
    C.reset_launch_count()
    on_card = TB.bucketed_makespans(items, rows, networks=nets)
    assert C.launch_count() == len(groups)
    on_cpu = TB.bucketed_makespans(items, rows, networks=nets, device="cpu")
    assert C.launch_count() == len(groups)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a, b)


def test_launch_raises_on_unknown_kernels_and_oversize_shapes(card):
    cb = random_bucket(np.random.default_rng(5), B=2, n=16, P=4, T=32)
    args = [t.to(card) for t in cb.tensors()]
    for bad in ("block", "sm90"):
        with pytest.raises(TypeError, match="kernel"):
            C.launch(*args, num_links=4, iters=ITERS, kernel=bad)
        with pytest.raises(TypeError, match="kernel"):
            C.contended_durations(*args, num_links=4, iters=ITERS,
                                  kernel=bad)
    big = random_bucket(np.random.default_rng(5), B=1, n=4096, P=4, T=64)
    big = [t.to(card) for t in big.tensors()]
    with pytest.raises(ValueError, match=r"\(4096, 4, 64\) needs \d+ bytes"):
        C.launch(*big, num_links=4, iters=ITERS)
    wide = random_bucket(np.random.default_rng(5), B=1, n=8, P=2, T=4097)
    wide = [t.to(card) for t in wide.tensors()]
    with pytest.raises(ValueError, match="T_pad 4097: the kernel takes"):
        C.launch(*wide, num_links=4, iters=1)


def test_shared_memory_mirror_and_block_size(card):
    lib = build.load("contention_sm90")
    lib.contention_sm90_smem_bytes.restype = ctypes.c_longlong
    lib.contention_sm90_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.contention_sm90_threads.argtypes = [ctypes.c_int]
    for n, P, Tn in ((64, 4, 16), (64, 4, 64), (1024, 4, 1024),
                     (4096, 4, 64), (33, 3, 31), (20, 40, 700),
                     (30, 3, 2000)):
        assert lib.contention_sm90_smem_bytes(n, P, Tn) == C.smem_bytes(
            n, P, Tn)
        assert lib.contention_sm90_threads(Tn) == C.threads(Tn)


def test_split_variants_equal_the_launch(card):
    _, _, groups = _netbound_groups(n_scen=2)
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        args = [t.to(card) for t in cb.tensors()]
        out, counts = C.launch(*args, num_links=L, iters=ITERS)
        s_out, s_counts, cycles = C.launch_split(*args, num_links=L,
                                                 iters=ITERS)
        torch.cuda.synchronize()
        assert torch.equal(out, s_out) and torch.equal(counts, s_counts)
        assert cycles.shape == (cb.size.shape[0], len(C.PHASES))
        assert bool((cycles >= 0).all()) and bool((cycles[:, 0] > 0).all())


def test_chain_probe_runs(card):
    probe = build.load("contention_sm90").contention_sm90_chain_probe
    probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float64, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    assert probe(out.data_ptr(), 1000, 0, 16, stream) == 0
    torch.cuda.synchronize()
    assert out.item() == 1250.0
    # the warp path, a block at K = 1 and 2 (8-bit fields) and at K = 8
    for t_pad in (16, 64, 1024, 2048):
        assert probe(out.data_ptr(), 10, 1, t_pad, stream) == 0
        torch.cuda.synchronize()
        assert out.item() == 10.0, t_pad
    assert probe(out.data_ptr(), 10, 1, C.MAX_T_PAD + 1, stream) != 0
