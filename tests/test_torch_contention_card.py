"""The contention kernel ``csrc/contention.cu`` against its plain version,
on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_contention_card.py

The kernel must equal the plain version (``kernels/contention/ref.py``) bit
for bit: on the random transfer sets of ``tests/test_network_kernel.py``
(one fluid solve each, also within rtol 1e-6 of the numpy oracle), on
random buckets (strided threads past 512 transfers, a plan that freezes
early), and on the campaign's netbound sub-grid at its own size and at the
§6.1 fork-join's (1000 tasks).  Its per-plan counts must equal the numpy
emulation's (``tests/contention_emulation.py``); the launch counter, the
shared-memory limit, the argument checks and the chain probe are checked
too.
"""
import ctypes

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

from contention_emulation import (emulate, fluid_bucket,  # noqa: E402
                                  random_bucket, random_transfer_sets)

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


def _launch(cb, L, card, iters=ITERS):
    out, counts = C.launch(*(t.to(card) for t in cb.tensors()), num_links=L,
                           iters=iters)
    torch.cuda.synchronize()
    return out.cpu(), counts.cpu().numpy()


def _plain(cb, L, iters=ITERS):
    return C.contended_durations(*cb.tensors(), num_links=L, iters=iters)


def test_kernel_equals_plain_on_random_transfer_sets(card):
    """Two types' four links and three types' six."""
    links = [("up", 0), ("down", 0), ("up", 1), ("down", 1), ("up", 2),
             ("down", 2)]
    for cases, L in ((random_transfer_sets(), 4),
                     (random_transfer_sets(16, types=3, first_seed=100), 6)):
        cb = fluid_bucket(cases)
        got, counts = _launch(cb, L, card)
        assert torch.equal(got, _plain(cb, L))
        np.testing.assert_array_equal(counts, emulate(cb, L, ITERS)[1])
        for b, (cap, starts, sizes, up, dn) in enumerate(cases):
            want = TN._fluid_finishes(starts, sizes,
                                      [(links[u], links[d]) for u, d in
                                       zip(up, dn)], cap)
            np.testing.assert_allclose(got[b, :len(starts)].numpy() + starts,
                                       want, rtol=1e-6, atol=1e-9)


def test_kernel_equals_plain_and_emulation_on_random_buckets(card):
    rng = np.random.default_rng(11)
    for B, n, P, Tn, iters in ((3, 40, 4, 100, 4), (2, 64, 8, 600, 2),
                               (4, 33, 3, 31, 1), (2, 20, 40, 64, 4)):
        cb = random_bucket(rng, B=B, n=n, P=P, T=Tn)
        got, counts = _launch(cb, 4, card, iters)
        assert torch.equal(got, _plain(cb, 4, iters)), (B, n, P, Tn)
        np.testing.assert_array_equal(counts, emulate(cb, 4, iters)[1])


def test_kernel_equals_plain_on_the_campaign_netbound_grid(card):
    _, _, groups = _netbound_groups()
    assert len(groups) >= 1
    froze = 0
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        got, counts = _launch(cb, L, card)
        assert torch.equal(got, _plain(cb, L)), (n_pad, P_pad, L)
        np.testing.assert_array_equal(counts, emulate(cb, L, ITERS)[1])
        froze += int((counts[:, 0] < ITERS).sum())
    assert froze >= 1


def test_kernel_equals_plain_at_the_fork_join_scale(card):
    """Seeds 300-301 at width 100, depth 10: 1000 tasks, T_pad 1024."""
    _, _, groups = _netbound_groups(width=100, depth=10, n_scen=2)
    for (n_pad, P_pad, L), (_, _, cb) in groups.items():
        assert n_pad == 1024
        got, counts = _launch(cb, L, card)
        assert torch.equal(got, _plain(cb, L)), (n_pad, P_pad, L)
        assert (counts[:, 3] == counts[:, 0] * n_pad).all()


def test_bucketed_path_launches_once_per_group_and_matches_the_cpu(card):
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
    T.set_contention_kernel("numpy")
    try:
        TB.bucketed_makespans(items, rows, networks=nets)
    finally:
        T.set_contention_kernel("torch")
    assert C.launch_count() == len(groups)


def test_launch_raises_on_what_the_kernel_does_not_take(card):
    cb = random_bucket(np.random.default_rng(5), B=2, n=16, P=4, T=32)
    args = [t.to(card) for t in cb.tensors()]
    with pytest.raises(TypeError, match="times is torch.float32"):
        C.launch(*args[:4], args[4].float(), *args[5:], num_links=4,
                 iters=ITERS)
    with pytest.raises(ValueError, match="is on cpu"):
        C.launch(*args[:10], args[10].cpu(), num_links=4, iters=ITERS)
    with pytest.raises(ValueError, match="links"):
        C.launch(*args, num_links=C.MAX_LINKS + 1, iters=ITERS)
    with pytest.raises(ValueError, match="out of range"):
        C.contended_durations(*args[:5], args[5] + 1000, *args[6:],
                              num_links=4, iters=ITERS)
    big = random_bucket(np.random.default_rng(5), B=1, n=4096, P=4, T=64)
    big = [t.to(card) for t in big.tensors()]
    with pytest.raises(ValueError, match=r"\(4096, 4, 64\) needs \d+ bytes"):
        C.launch(*big, num_links=4, iters=ITERS)


def test_shared_memory_mirror_and_block_size(card):
    lib = build.load("contention")
    lib.contention_smem_bytes.restype = ctypes.c_longlong
    lib.contention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.contention_threads.argtypes = [ctypes.c_int]
    for n, P, Tn in ((64, 4, 32), (1024, 4, 1024), (4096, 4, 64), (33, 3, 31),
                     (20, 40, 700)):
        assert lib.contention_smem_bytes(n, P, Tn) == C.smem_bytes(n, P, Tn)
        assert lib.contention_threads(Tn) == C.threads(Tn)


def test_chain_probe_runs(card):
    probe = build.load("contention").contention_chain_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float64, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    assert probe(out.data_ptr(), 1000, 0, 32, stream) == 0
    torch.cuda.synchronize()
    assert out.item() == 1250.0
    assert probe(out.data_ptr(), 10, 1, 512, stream) == 0
    torch.cuda.synchronize()
    assert out.item() == 10.0
