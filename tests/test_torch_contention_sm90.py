"""The Hopper contention kernel's loop, emulated, against the plain version.

``csrc/contention_sm90.cu`` runs only on the card
(``tests/test_torch_contention_sm90_card.py``).  Here its loop is emulated
in numpy (``tests/contention_emulation.py::emulate_sm90``: K transfers a
thread, packed per-link counts, one reduction a filling round carrying the
event's min, the min-only round after the guard or the round limit, the
warp path at small T_pad) and held to the plain float64 version
(``kernels/contention/ref.py``) bit for bit, its per-plan counts to the
first kernel's emulation, on random buckets on both sides of the warp /
block threshold, one fluid solve a plan, the campaign's netbound groups and
a 1000-task plan.  The wrapper's kernel choice and its mirrors of the
kernel's block size and shared memory are checked too; nothing here
launches a kernel.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.network as TN  # noqa: E402
from repro_torch.kernels.contention import contention as C  # noqa: E402
from repro_torch.sim.adapters import CommAwareHLPScheduler  # noqa: E402
from repro_torch.sim.scenarios import netbound_scenario  # noqa: E402

from contention_emulation import (emulate, emulate_sm90,  # noqa: E402
                                  fluid_bucket, random_bucket,
                                  random_transfer_sets, sm90_threads)

ITERS = TN.CONTENTION_ITERS


def _plain(cb, L, iters=ITERS):
    return C.contended_durations(*cb.tensors(), num_links=L,
                                 iters=iters).numpy()


def _netbound_groups(width, depth, seeds, planners=("hlp_ols", "cahlp")):
    items = []
    for s in seeds:
        sc = netbound_scenario(width=width, depth=depth, seed=s)
        for name in planners:
            sched = (T.make_scheduler("hlp_ols") if name == "hlp_ols"
                     else CommAwareHLPScheduler(contention=True))
            items.append((sc.graph, sched.allocate(sc.graph, sc.machine)))
    nets = [T.make_network("maxmin_fair")] * len(items)
    return TB.contended_buckets(items, nets)[1]


def _check_counts(counts, cb, iters):
    """The sm90 counts' invariants: rounds in 1..iters, steps = rounds x
    n_pad, at most one merged round an event."""
    assert (counts[:, 0] >= 1).all() and (counts[:, 0] <= iters).all()
    np.testing.assert_array_equal(counts[:, 3],
                                  counts[:, 0] * cb.order.shape[1])
    assert (counts[:, 4] <= counts[:, 1]).all()


# T_pad 1 to 2048 on both sides of the one-warp threshold (32), at the
# kernel's block for each: the warp path, blocks of a thread a transfer (64,
# 128 and 160 threads), 512 threads at K = 2 and 256 at K = 8 (16-bit fields)
@pytest.mark.parametrize("n,P,T_pad,iters", [
    (8, 2, 1, 4), (20, 3, 32, 4), (30, 4, 64, 4), (40, 4, 128, 2),
    (40, 4, 160, 2), (64, 4, 1024, 1), (30, 4, 2048, 1)])
def test_emulation_matches_plain_on_random_buckets(n, P, T_pad, iters):
    cb = random_bucket(np.random.default_rng(T_pad), B=2, n=n, P=P, T=T_pad)
    want = _plain(cb, 4, iters)
    got, counts = emulate_sm90(cb, 4, iters)
    np.testing.assert_array_equal(got, want)
    _check_counts(counts, cb, iters)
    assert (sm90_threads(T_pad) == 32) == (T_pad <= 32)
    if T_pad <= 160:
        np.testing.assert_array_equal(counts[:, :4],
                                      emulate(cb, 4, iters)[1])


def test_emulation_matches_plain_on_fluid_buckets():
    """The random transfer sets of ``tests/test_network_kernel.py`` as one
    fluid solve a plan, over two types' four links and three types' six."""
    for cases, L in ((random_transfer_sets(), 4),
                     (random_transfer_sets(16, types=3, first_seed=100), 6)):
        cb = fluid_bucket(cases)
        got, counts = emulate_sm90(cb, L, ITERS)
        np.testing.assert_array_equal(got, _plain(cb, L))
        np.testing.assert_array_equal(counts[:, :4],
                                      emulate(cb, L, ITERS)[1])


def test_emulation_takes_every_exit_of_the_filling_loop():
    """All flows on one link (every filling loop ends on its round limit)
    and a capacity of 1e9 (rounding leaves ``used`` short of ``cap - EPS``,
    so the guard ends loops): both pay a min-only round, so fewer events
    merge than run; each at T_pad 32, 48 and 128 (the warp path and blocks
    of 64 and 128 threads), the counts equal to the first kernel's
    emulation."""
    for T_pad in (32, 48, 128):
        cb = random_bucket(np.random.default_rng(5), B=3, n=30, P=3, T=T_pad)
        one = dataclasses.replace(cb, up=torch.zeros_like(cb.up),
                                  dn=torch.zeros_like(cb.dn))
        big = dataclasses.replace(cb, size=cb.size * 1e9,
                                  capacity=cb.capacity * 1e9)
        for bucket, L in ((one, 1), (big, 4), (cb, 4)):
            got, counts = emulate_sm90(bucket, L, ITERS)
            np.testing.assert_array_equal(got, _plain(bucket, L))
            np.testing.assert_array_equal(counts[:, :4],
                                          emulate(bucket, L, ITERS)[1])
            if bucket is cb:
                np.testing.assert_array_equal(counts[:, 4], counts[:, 1])
            else:
                assert counts[:, 4].sum() < counts[:, 1].sum()


def test_emulation_matches_plain_on_the_campaign_netbound_groups():
    """Seeds 300-302 of the campaign's netbound generator, each planned by
    HLP-OLS and the contention-aware CAHLP: its (2, 64, 4, 16, 2) group on
    one warp and its (n, 64, 4, 64, 4) group on two."""
    groups = _netbound_groups(12, 5, range(300, 303))
    assert {T_pad for (_, _, cb) in groups.values()
            for T_pad in [cb.size.shape[1]]} <= {16, 32, 64}
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        got, counts = emulate_sm90(cb, L, ITERS)
        np.testing.assert_array_equal(got, _plain(cb, L),
                                      err_msg=f"{(n_pad, P_pad, L)}")
        np.testing.assert_array_equal(counts[:, :4],
                                      emulate(cb, L, ITERS)[1])
        _check_counts(counts, cb, ITERS)


def test_emulation_matches_plain_on_a_1000_task_plan():
    """Seed 300 at the §6.1 fork-join's scale (width 100, depth 10), planned
    by HLP-OLS: T_pad 1024 over a block of 512 threads, K = 2."""
    groups = _netbound_groups(100, 10, [300], planners=("hlp_ols",))
    ((n_pad, P_pad, L), (_, _, cb)), = groups.items()
    assert n_pad == 1024 and cb.size.shape[1] > 128
    got, counts = emulate_sm90(cb, L, ITERS)
    np.testing.assert_array_equal(got, _plain(cb, L))
    _check_counts(counts, cb, ITERS)
    assert counts[0, 1] > 1000


# ------------------------------------------------------------- wrapper
def test_kernel_choice_mirrors_and_no_launch_on_the_cpu():
    """One kernel is left (``csrc/contention_sm90.cu``): no ``kernel=``
    choice, its block and shared-memory mirrors, the plain version on CPU
    tensors and no launch off the card."""
    assert C.SOURCE == "contention_sm90" and not hasattr(C, "KERNELS")
    assert C.COUNT_NAMES == ("rounds", "events", "fills", "steps", "merged")
    # the block: one warp up to 32 transfers, a thread a transfer up to
    # 512, then 512 threads, and 256 past 1024 transfers
    for T_pad in (1, 16, 32, 33, 64, 128, 160, 512, 600, 1024, 1025, 4096):
        assert C.threads(T_pad) == sm90_threads(T_pad)
    assert [C.threads(t) for t in (16, 64, 600, 1024, 4096)] == [
        32, 64, 512, 512, 256]
    assert C.MAX_T_PAD == 4096
    # the layout keeps of the transfers only their durations
    assert C.smem_bytes(1024, 4, 1024) == (
        8 * (1025 + 1024 + 4096 + 1024 + 32) + 4 * (128 + 1024 + 2 * 4096))
    assert C.smem_bytes(4096, 4, 64) > C.SMEM_LIMIT
    rand = random_bucket(np.random.default_rng(3), B=2, n=16, P=4, T=32)
    args = list(rand.tensors())
    C.reset_launch_count()
    with pytest.raises(ValueError, match="needs the card"):
        C.launch(*args, num_links=4, iters=4)
    for call in (C.launch, C.contended_durations, C.launch_split):
        with pytest.raises(TypeError, match="kernel"):
            call(*args, num_links=4, iters=4, kernel="block")
    got = C.contended_durations(*args, num_links=4, iters=4)
    np.testing.assert_array_equal(got.numpy(), _plain(rand, 4, 4))
    TB.contended_bucket_delays(*_netbound_items(), device="cpu")
    assert C.launch_count() == 0


def _netbound_items():
    sc = netbound_scenario(width=8, depth=3, seed=300)
    items = [(sc.graph, T.make_scheduler("hlp_ols").allocate(sc.graph,
                                                             sc.machine))]
    return items, [T.make_network("maxmin_fair")]
