"""The sm90 replay kernel's own cases, and NaN in the replay kernel, on
the card.

Like ``tests/test_torch_replay_card.py`` this file carries the ``card``
marker on every test, asks for the ``card`` fixture (which skips without a
card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_replay_sm90_card.py

The kernel must equal the plain version bit for bit; where an input holds
NaN, with NaN in the same lanes (``assert_array_equal`` treats NaNs in the
same places as equal).  The cases: the shared-memory boundaries where the
seeds a block takes step down (32 to 16 lanes, and 4 lanes at n_pad 8192),
stages cut by wide rows and a join of 700 predecessors, the walk stopped at
each item's own length and not where a skipped step would change a bit,
seed counts that leave a block's last lanes empty, and the chain probe
``chip_smoke.py`` times.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
from repro_torch.core.workloads import chameleon, fork_join  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_bucket(rng, B, n, P, S, full=False):
    """B random DAGs of n tasks in topological order, up to P preds each
    (all P where ``full``), nonzero floors on a third of the tasks."""
    order = np.zeros((B, n), np.int32)
    pred = np.full((B, n, P), -1, np.int32)
    delay = np.zeros((B, n, P))
    for b in range(B):
        perm = rng.permutation(n).astype(np.int32)
        order[b] = perm
        for i in range(1, n):
            k = min(i, P) if full else rng.integers(0, min(i, P) + 1)
            pred[b, perm[i], :k] = rng.choice(perm[:i], k, replace=False)
            delay[b, perm[i], :k] = rng.uniform(0, 3, k)
    floor = rng.uniform(0, 20, (B, n)) * (rng.random((B, n)) < 0.3)
    times = rng.lognormal(0, 0.5, (B, S, n))
    return (torch.from_numpy(order), torch.from_numpy(pred), TB._f32(delay),
            TB._f32(floor), TB._f32(times))


def _check(args, card):
    """The kernel against the plain version; NaN in the same lanes."""
    want = R.bucket_makespans_ref(*args).numpy()
    got = R.launch(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    return want


def _items():
    machine = T.Machine.hybrid(32, 4)
    graphs = [chameleon("potrf", 5, 320), chameleon("getrf", 10, 320),
              fork_join(300, 3)]
    return [(g, T.make_scheduler(a).allocate(g, machine))
            for g in graphs for a in ("hlp_est", "hlp_ols")]


def _bucket(items, seeds):
    bd = TB.BatchedPlanDag.from_plans(items)
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   seeds) for g, p in items]
    return bd, (bd.order, bd.pred, bd.pred_delay, bd.floor,
                TB.bucket_times(rows, bd.n_pad))


@pytest.mark.card
def test_sm90_at_the_shared_memory_boundaries(card):
    """n_pad 1026 and 1027 at P_pad 4 (32 lanes a block, then 16) and 8192
    (4 lanes); the library's shared-memory bytes equal the wrapper's."""
    rng = np.random.default_rng(10)
    bytes_of = build.load("replay_sm90").replay_sm90_smem_bytes
    bytes_of.argtypes = [ctypes.c_int] * 3
    bytes_of.restype = ctypes.c_longlong
    for n, lanes, S in ((1026, 32, 32), (1027, 16, 40), (8192, 4, 9)):
        assert R.lanes_per_block(n, 4, S) == lanes
        assert bytes_of(n, 4, lanes) == R.smem_bytes(n, 4, lanes)
        _check(_random_bucket(rng, 2, n, 4, S), card)
    for n, p, lanes in ((5011, 501, 8), (48815, 4, 1), (30, 3, 32)):
        assert bytes_of(n, p, lanes) == R.smem_bytes(n, p, lanes)


@pytest.mark.card
def test_sm90_cuts_stages_on_wide_rows_and_a_join_of_700(card):
    """Rows of 40 real slots (15 steps a stage), a join of 700 slots among
    one-slot tasks (a row counted past its first 8 slots by bisection),
    and a fork-join of width 300 planned by HLP-EST and HLP-OLS."""
    _check(_random_bucket(np.random.default_rng(11), 3, 700, 40, 33,
                          full=True), card)
    n = 900
    order = torch.arange(n, dtype=torch.int32)[None]
    pred = torch.full((1, n, 701), -1, dtype=torch.int32)
    pred[0, 1:701, 0] = 0
    pred[0, 701, :700] = torch.arange(1, 701)
    pred[0, 702:, 0] = torch.arange(701, n - 1)
    rng = np.random.default_rng(12)
    delay = TB._f32(rng.uniform(0, 2, (1, n, 701)))
    times = TB._f32(rng.lognormal(0, 0.5, (1, 20, n)))
    _check((order, pred, delay, torch.zeros((1, n)), times), card)
    _, args = _bucket(_items()[4:], range(32))
    _check(args, card)


@pytest.mark.card
def test_sm90_walks_each_items_own_length_and_no_shorter(card):
    """A bucket of mixed sizes, whose short items end in phantom steps;
    then the phantom task given a time in one lane, -0.0 or NaN, a floor of
    2, -0.0 or NaN, a real slot, or an earlier visit, where the walk must
    take the whole order."""
    items = _items()
    small, large = items[0], items[-1]
    assert small[0].n < large[0].n
    _, base = _bucket([small, large], range(32))
    n = small[0].n
    _check(base, card)
    for field, value in (("time", 0.5), ("time", -0.0),
                         ("time", float("nan")), ("floor", 2.0),
                         ("floor", -0.0), ("floor", float("nan")),
                         ("slot", 1.5), ("visit", None)):
        o, p, d, f, t = (x.clone() for x in base)
        if field == "time":
            t[0, 17, n] = value
        elif field == "floor":
            f[0, n] = value
        elif field == "slot":
            p[0, n, 0], d[0, n, 0] = 0, value
        else:
            first = int(o[0, 0])
            o[0, 0], o[0, n] = n, first
        want = _check((o, p, d, f, t), card)
        assert np.isnan(want).any() == (value != value), (field, value)


@pytest.mark.card
def test_both_kernels_keep_nan_where_the_plain_version_does(card):
    """One NaN in ``times``, in ``floor``, in a real slot's ``pred_delay``
    (each reaching some lanes) and in a masked slot's (reaching none)."""
    rng = np.random.default_rng(13)
    base = _random_bucket(rng, 3, 400, 5, 40)
    order, pred = base[0], base[1]
    j = int(order[1, 50])
    real = tuple(torch.nonzero(pred[2] >= 0)[0].tolist())
    masked = tuple(torch.nonzero(pred[0] < 0)[0].tolist())
    for which, at, reaches in (("times", (1, 7, j), True),
                               ("floor", (1, j), True),
                               ("delay", (2, *real), True),
                               ("delay", (0, *masked), False)):
        args = [x.clone() for x in base]
        args[{"delay": 2, "floor": 3, "times": 4}[which]][at] = float("nan")
        want = _check(tuple(args), card)
        nan = np.isnan(want)
        assert nan.any() == reaches and not nan.all(), (which, at)


@pytest.mark.card
def test_sm90_seed_counts_that_leave_lanes_empty(card):
    """S of 1, 5, 13, 33 and 70 at 32 lanes a block (300 tasks) and at 8
    (3000 tasks): the last block's spare lanes write nothing."""
    rng = np.random.default_rng(14)
    R.reset_launch_count()
    for n in (300, 3000):
        for S in (1, 5, 13, 33, 70):
            _check(_random_bucket(rng, 2, n, 4, S), card)
    assert R.launch_count() == 10


@pytest.mark.card
def test_chain_probe_walks_its_chain(card):
    """The probe ``chip_smoke.py`` times: each step is the last finish time
    + 0.25, max with 0, + 1, so 1000 steps end at 1250 exactly."""
    probe = build.load("replay_sm90").replay_sm90_chain_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(1, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    assert probe(out.data_ptr(), 1000, stream) == 0
    torch.cuda.synchronize()
    assert out.item() == 1250.0
