"""The replay CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so every test here carries the ``card`` marker
and asks for the ``card`` fixture, which skips it without a card.  This
file imports nothing of JAX, so it also runs on a host that has the card
but not the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_replay_card.py

Every operation of the replay is a float32 add, rounded once, or an exact
max, so the kernel (``csrc/replay_sm90.cu``) must equal the plain version
bit for bit (``torch.equal``); its cases that test its own design are in
``tests/test_torch_replay_sm90_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
from repro_torch.core.workloads import fork_join  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402
from repro_torch.sim.scenarios import comm_suite, default_suite  # noqa: E402


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_bucket(rng, B, n, P, S):
    """B random DAGs of n tasks in topological order, up to P preds each
    (filled from the left), nonzero floors on a third of the tasks."""
    order = np.zeros((B, n), np.int32)
    pred = np.full((B, n, P), -1, np.int32)
    delay = np.zeros((B, n, P))
    for b in range(B):
        perm = rng.permutation(n).astype(np.int32)
        order[b] = perm
        for i in range(1, n):
            k = rng.integers(0, min(i, P) + 1)
            pred[b, perm[i], :k] = rng.choice(perm[:i], k, replace=False)
            delay[b, perm[i], :k] = rng.uniform(0, 3, k)
    floor = rng.uniform(0, 20, (B, n)) * (rng.random((B, n)) < 0.3)
    times = rng.lognormal(0, 0.5, (B, S, n))
    return (torch.from_numpy(order), torch.from_numpy(pred), TB._f32(delay),
            TB._f32(floor), TB._f32(times))


def _check(args, card):
    want = R.bucket_makespans_ref(*args)
    got = R.launch(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got.cpu(), want), (got.cpu() - want).abs().max()


@pytest.mark.card
def test_kernel_equals_plain_on_random_dags(card):
    """S of 1, 31, 32, 33 and 64 (a masked tail, one and two blocks of
    seeds per plan), nonzero floors."""
    rng = np.random.default_rng(0)
    R.reset_launch_count()
    for i, S in enumerate((1, 31, 32, 33, 64)):
        _check(_random_bucket(rng, 3 + i, 200, 6, S), card)
    assert R.launch_count() == 5


@pytest.mark.card
def test_kernel_equals_plain_on_plan_buckets(card):
    """The campaign path on the card against the CPU: every bucket of two
    suites × two schedulers, with rollout floors and without, and one
    bucket whose largest item has no phantom slot."""
    items = []
    for sc in default_suite(seed=0) + comm_suite(seed=50, ccr=0.5):
        for alg in ("hlp_ols", "heft"):
            items.append((sc.graph, T.make_scheduler(alg).allocate(
                sc.graph, sc.machine)))
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   range(33)) for g, p in items]
    rng = np.random.default_rng(1)
    floors = [TB.rollout_floors(g, p, [rng.uniform(0, 9, 8),
                                       rng.uniform(0, 9, 2)], now=1.0)
              for g, p in items]
    for fl in (None, floors):
        R.reset_launch_count()
        got = TB.bucketed_makespans(items, rows, floors=fl, device=card)
        assert R.launch_count() == len(TB.bucket_plans(items))
        want = TB.bucketed_makespans(items, rows, floors=fl, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    bd = TB.BatchedPlanDag.from_plans(items[:4])
    assert max(g.n for g, _ in items[:4]) == bd.n_pad   # no phantom slot
    tt = TB.bucket_times(rows[:4], bd.n_pad)
    _check((bd.order, bd.pred, bd.pred_delay, bd.floor, tt), card)


@pytest.mark.card
def test_kernel_equals_plain_on_fork_join_of_width_500(card):
    """A join node of fan-in 500 plus its chain pred: P_pad 501, most
    tasks with one or two real slots."""
    g = fork_join(500, 2)
    machine = T.Machine.hybrid(32, 4)
    items = [(g, T.make_scheduler(a).allocate(g, machine))
             for a in ("hlp_est", "hlp_ols")]
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   range(32)) for g, p in items]
    bd = TB.BatchedPlanDag.from_plans(items)
    assert bd.pred.shape[2] >= 501
    tt = TB.bucket_times(rows, bd.n_pad)
    _check((bd.order, bd.pred, bd.pred_delay, bd.floor, tt), card)


@pytest.mark.card
def test_kernel_equals_plain_on_an_order_that_is_not_topological(card):
    """Reversed orders with one task visited twice: reads before writes see
    the zeros the plain version starts from, the max sees the last write."""
    order, pred, delay, floor, times = _random_bucket(
        np.random.default_rng(3), 4, 300, 5, 40)
    odd = order.flip(1).clone()
    odd[:, -1] = odd[:, 0]
    _check((odd, pred, delay, floor, times), card)


@pytest.mark.card
def test_launch_refuses_what_the_kernel_does_not_take(card):
    args = _random_bucket(np.random.default_rng(2), 2, 16, 3, 8)
    R.reset_launch_count()
    order, pred, delay, floor, times = (a.to(card) for a in args)
    with pytest.raises(ValueError, match="card"):
        R.launch(*args)
    with pytest.raises(ValueError, match="contiguous"):
        R.launch(order, pred, delay, floor,
                 times.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="kernel"):
        R.launch(order, pred, delay, floor, times, kernel="walk")
    holed = pred.clone()
    holed[0, 5, 0], holed[0, 5, 1] = -1, 0
    with pytest.raises(ValueError, match="after a -1"):
        R.bucket_makespans(order, holed, delay, floor, times)
    with pytest.raises(ValueError, match="out of range"):
        R.bucket_makespans(order + 16, pred, delay, floor, times)
    assert R.launch_count() == 0
