"""The pipelined campaign executor on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_pipeline_card.py

The pipelined sweep dispatches each bucket without waiting for the card:
its build and dispatch loop runs under
``torch.cuda.set_sync_debug_mode("error")``, which raises on any call that
synchronises the host with the card, and only the final drain waits.  Its
rows equal the serial route's bit for bit, on uncontended buckets, on the
campaign's netbound grid under ``maxmin_fair`` (whose pricing does wait
once a group: the durations go into the plan DAGs on the host), with
each bucket's plan axis split in two chunks on the one card, and split
over every visible card (one chunk a card).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.pipeline as TP  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels.contention import contention as C  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402
from repro_torch.sim.adapters import CommAwareHLPScheduler  # noqa: E402
from repro_torch.sim.scenarios import (comm_suite, default_suite,  # noqa: E402
                                       netbound_scenario)

pytestmark = pytest.mark.card
NOISE = T.NoiseModel("lognormal", 0.2)


@pytest.fixture
def card():
    """The card, for tests that launch the kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _entries():
    return [(sc.graph, sc.machine, T.make_scheduler(a))
            for sc in default_suite(seed=0) + comm_suite(seed=50, ccr=0.5)
            for a in ("hlp_ols", "heft", "cahlp_ols")]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_dispatch_does_not_wait_for_the_card(card, monkeypatch):
    """Every bucket dispatched with the sync debug mode at "error" (the
    drain turns it off before it waits): one launch per chunk dispatched
    (per bucket on one card; per card for a bucket of two or more plans
    on several), rows equal to the serial route's."""
    entries = _entries()
    serial = TB.sweep_suite_makespans(entries, noise=NOISE, seeds=range(16),
                                      device=card)
    drain = TP._drain

    def drain_after_dispatch(in_flight, out):
        torch.cuda.set_sync_debug_mode(0)
        drain(in_flight, out)

    monkeypatch.setattr(TP, "_drain", drain_after_dispatch)
    TP.clear_plan_cache()
    R.reset_launch_count()
    chunks0 = obs.counter_value("sim.replay.chunks")
    torch.cuda.set_sync_debug_mode("error")
    try:
        piped = TP.pipelined_sweep_makespans(entries, noise=NOISE,
                                             seeds=range(16), workers=2,
                                             device=card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stats = TP.last_pipeline_stats()
    chunks = obs.counter_value("sim.replay.chunks") - chunks0
    assert stats.buckets >= 2 and chunks >= stats.buckets
    assert R.launch_count() == chunks
    if torch.cuda.device_count() == 1:
        assert chunks == stats.buckets
    _same(serial, piped)


def test_sync_debug_mode_catches_a_wait(card):
    """The check above can fail: a copy to the host without
    ``non_blocking`` raises under the same mode."""
    x = torch.ones(4, device=card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchroniz"):
            x.cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_contended_pipeline_equals_serial_on_the_card(card):
    """The campaign's netbound grid (seeds 300-302, HLP-OLS and the
    contention-aware CAHLP under the three network models): pipelined on
    the card equals the serial route on the card and the pipelined sweep
    on the CPU; one contention launch per group priced."""
    nets = [T.make_network(n)
            for n in ("instant", "fixed_latency", "maxmin_fair")]
    entries, networks = [], []
    for i in range(3):
        sc = netbound_scenario(seed=300 + i)
        for mk in (lambda: T.make_scheduler("hlp_ols"),
                   lambda: CommAwareHLPScheduler(contention=True)):
            for net in nets:
                entries.append((sc.graph, sc.machine, mk()))
                networks.append(net)
    TP.clear_plan_cache()
    C.reset_launch_count()
    groups0 = obs.counter_value("sim.contended.groups")
    piped = TP.pipelined_sweep_makespans(entries, noise=NOISE, seeds=range(8),
                                         networks=networks, workers=2,
                                         device=card)
    groups = obs.counter_value("sim.contended.groups") - groups0
    assert groups >= 1 and C.launch_count() == groups
    on_cpu = TP.pipelined_sweep_makespans(entries, noise=NOISE,
                                          seeds=range(8), networks=networks,
                                          workers=2, device="cpu")
    _same(on_cpu, piped)
    for i, ((g, m, s), net) in enumerate(zip(entries, networks)):
        if i % 3 == 2:
            _same(TB.sweep_suite_makespans([(g, m, s)], noise=NOISE,
                                           seeds=range(8), network=net,
                                           device=card), [piped[i]])


def test_plan_axis_split_in_two_chunks_on_one_card(card):
    """``devices=[cuda, cuda]``: each bucket of two or more plans replays as
    two launches on the same card, gathered back in plan order."""
    entries = _entries()
    serial = TB.sweep_suite_makespans(entries, noise=NOISE, seeds=range(5),
                                      device=card)
    TP.clear_plan_cache()
    R.reset_launch_count()
    piped = TP.pipelined_sweep_makespans(entries, noise=NOISE,
                                         seeds=range(5), device=card,
                                         devices=[card, card])
    _same(serial, piped)
    sizes = {}
    for g, m, _ in entries:
        key = TB.search_envelope(g, m)
        sizes[key] = sizes.get(key, 0) + 1
    assert R.launch_count() == sum(2 if b >= 2 else 1 for b in sizes.values())


def test_plan_axis_split_over_every_visible_card(card):
    """The default device list, ``campaign_devices()``: every visible card
    (one chunk a card, each on its own side stream), equal bit for bit to
    the replay on the first card alone; a bucket of two or more plans
    launches once a card (its plan axis padded to a multiple of the cards
    by repeats of plan 0, as the reference pads its mesh).  On a one-card
    host the split is the identity."""
    cards = TB.campaign_devices(card)
    assert cards == [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
    entries = _entries()
    one = TB.sweep_suite_makespans(entries, noise=NOISE, seeds=range(6),
                                   device=card, devices=[cards[0]])
    for cache in (False, True):
        TP.clear_plan_cache()
        R.reset_launch_count()
        every = TB.sweep_suite_makespans(entries, noise=NOISE,
                                         seeds=range(6), workers=2,
                                         cache=cache, device=card)
        _same(one, every)
        sizes = {}
        for g, m, _ in entries:
            key = TB.search_envelope(g, m)
            sizes[key] = sizes.get(key, 0) + 1
        assert R.launch_count() == sum(len(cards) if b >= 2 else 1
                                       for b in sizes.values())
