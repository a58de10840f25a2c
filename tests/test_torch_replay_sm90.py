"""The sm90 replay kernel's walk, emulated, and NaN in the plain versions.

``csrc/replay_sm90.cu`` runs only on the card
(``tests/test_torch_replay_sm90_card.py``).  Here its walk is emulated in
numpy float32 as the kernel runs it: L seeds a block (``lanes_per_block``),
stages of up to ``STEPS`` steps, each step's first four pred slots in its
record (a missing one read from a zero cell) and the rest packed in CSR
form, a stage cut where those would pass ``2 STEPS + P_pad`` words, the walk
stopped before a trailing run of steps that changes no bit, and every max
keeping NaN.  The emulation is held to the plain version
(``bucket_makespans_ref``) bit for bit on §6.1-style buckets (Chameleon and
fork-join graphs planned by HLP-EST and HLP-OLS), on an order that is not
topological and on inputs that must walk the whole order.

The plain replay and the plain (max, +) product are held against the JAX
package on NaN inputs: ``repro.sim.batch._bucket_makespans`` and
``maxplus_matmul`` in interpret mode, as the JAX package's tests run it.
Both sides must give NaN in the same lanes (``assert_array_equal`` treats
NaNs in the same places as equal) and equal values elsewhere.

Tests loop over their cases rather than being parametrized per case, for
the reason ``tests/test_torch_replay.py`` gives.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.sim.batch as JB  # noqa: E402
from repro.kernels.maxplus.maxplus import maxplus_matmul as jax_maxplus  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
from repro_torch.core.workloads import chameleon, fork_join  # noqa: E402
from repro_torch.kernels.maxplus import maxplus as mp  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402

F32 = np.float32
INLINE = 4          # slots a step's record holds (csrc/replay_sm90.cu)


def _walk_length(order, pred, floor, times):
    """Steps the kernel walks for one plan and a block's (L, n_pad) times:
    all but a trailing run of one task j* that no earlier step visits, with
    no real slot and a floor and every lane's time of +0.0."""
    n_pad = order.shape[0]
    jstar = order[-1]
    other = np.flatnonzero(order != jstar)
    last_other = int(other.max()) if other.size else -1
    first_star = int(np.flatnonzero(order == jstar).min())
    idle = (pred[jstar, 0] < 0 and floor[jstar:jstar + 1].view(np.uint32)[0] == 0
            and bool((times[:, jstar].view(np.uint32) == 0).all()))
    return last_other + 1 if idle and first_star > last_other else n_pad


def _row_count(row):
    """Real slots of a row filled from the left."""
    neg = np.flatnonzero(row < 0)
    return int(neg[0]) if neg.size else row.shape[0]


def _sm90_emulation(order, pred, delay, floor, times, steps=R.STEPS,
                    stats=None):
    """``replay_sm90_kernel`` in numpy float32: each step's first
    ``INLINE`` slots from its record (a missing one reads the zero cell with
    delay +0.0), the rest from the stage's CSR words, a stage cut where
    those pass ``2 steps + P_pad`` words, the max closed with the record's
    max(0, floor).  ``stats`` (a dict), when given,
    collects each block's walk length and stage sizes."""
    order, pred = order.numpy(), pred.numpy()
    delay, floor, times = delay.numpy(), floor.numpy(), times.numpy()
    B, n_pad, P = pred.shape
    S = times.shape[1]
    lanes = R.lanes_per_block(n_pad, P, S)
    words = 2 * steps + ((P + 3) & ~3)
    out = np.empty((B, S), F32)
    for b in range(B):
        for s0 in range(0, S, lanes):
            tl = times[b, s0:s0 + lanes]                       # (l, n_pad)
            walk = _walk_length(order[b], pred[b], floor[b], tl)
            fin = np.zeros((n_pad + 1, tl.shape[0]), F32)      # + zero cell
            i0 = 0
            while i0 < walk:
                js = order[b, i0:min(i0 + steps, walk)]
                cnt = np.array([_row_count(pred[b, j]) for j in js])
                more = np.maximum(cnt - INLINE, 0)
                incl = np.cumsum(more)
                taken = int((incl <= words).sum())
                assert taken >= 1 and incl[taken - 1] <= words
                for t in range(taken):
                    j, c = js[t], cnt[t]
                    slots = [pred[b, j, k] if k < c else n_pad
                             for k in range(INLINE)]
                    dls = [delay[b, j, k] if k < c else F32(0)
                           for k in range(INLINE)]
                    f = [fin[p] + d for p, d in zip(slots, dls)]
                    start = np.maximum(np.maximum(f[0], f[1]),
                                       np.maximum(f[2], f[3]))
                    for k in range(INLINE, c):
                        start = np.maximum(start, fin[pred[b, j, k]]
                                           + delay[b, j, k])
                    start = np.maximum(start, np.maximum(F32(0), floor[b, j]))
                    fin[j] = start + tl[:, j]
                if stats is not None:
                    stats.setdefault("stages", []).append(taken)
                i0 += taken
            if stats is not None:
                stats.setdefault("walks", []).append(walk)
            out[b, s0:s0 + lanes] = fin[:n_pad].max(axis=0)
    return out


@functools.cache
def _grid_items():
    """§6.1-style graphs, cut small: each Chameleon app at nb 5 and two
    block sizes, and fork-joins of widths 20-60, on a (8, 2) machine,
    planned by HLP-EST and HLP-OLS."""
    machine = T.Machine.hybrid(8, 2)
    graphs = [chameleon(app, 5, bs) for app in ("getrf", "posv", "potrf",
                                                "potri", "potrs")
              for bs in (64, 960)]
    graphs += [fork_join(w, ph) for w, ph in ((20, 2), (40, 3), (60, 2))]
    return [(g, T.make_scheduler(a).allocate(g, machine))
            for a in ("hlp_est", "hlp_ols") for g in graphs]


def _bucket_args(items, seeds, floors=None):
    bd = TB.BatchedPlanDag.from_plans(items, floors=floors)
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   seeds) for g, p in items]
    return bd, (bd.order, bd.pred, bd.pred_delay, bd.floor,
                TB.bucket_times(rows, bd.n_pad))


def _random_args(rng, B, n, P, S, full=False):
    """B random DAGs in topological order, up to P preds a task (all P
    where ``full``), floors on a third of the tasks."""
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


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ----------------------------------------------------------- the emulation
def test_emulation_equals_plain_on_grid_style_buckets():
    """Every bucket of the cut grid, with floors and without, at the
    kernel's stage size and at 8 steps a stage; and one bucket of mixed
    sizes, where each item walks its own length."""
    items = _grid_items()
    rng = np.random.default_rng(0)
    floors = [TB.rollout_floors(g, p, [rng.uniform(0, 9, 8),
                                       rng.uniform(0, 9, 2)], now=1.0)
              for g, p in items]
    for idxs in TB.bucket_plans(items).values():
        for fl in (None, [floors[i] for i in idxs]):
            _, args = _bucket_args([items[i] for i in idxs], range(5), fl)
            want = R.bucket_makespans_ref(*args).numpy()
            for steps in (R.STEPS, 8):
                _same(_sm90_emulation(*args, steps=steps), want)
    mixed = [items[i] for i in (0, 3, 10, 12)]
    bd, args = _bucket_args(mixed, range(3))
    stats = {}
    _same(_sm90_emulation(*args, stats=stats),
          R.bucket_makespans_ref(*args).numpy())
    assert stats["walks"] == [g.n for g, _ in mixed]
    assert max(g.n for g, _ in mixed) == bd.n_pad


def test_emulation_equals_plain_on_a_revisiting_order():
    """Reversed orders with one task visited twice, on a grid bucket and on
    random DAGs: the trailing task was visited before, so the whole order
    is walked."""
    items = _grid_items()
    _, (order, pred, delay, floor, times) = _bucket_args(items[:3], range(4))
    rnd = _random_args(np.random.default_rng(1), 3, 90, 5, 11)
    for order, pred, delay, floor, times in ((order, pred, delay, floor,
                                              times), rnd):
        odd = order.flip(1).clone()
        odd[:, -1] = odd[:, 0]
        args = (odd, pred, delay, floor, times)
        stats = {}
        _same(_sm90_emulation(*args, steps=16, stats=stats),
              R.bucket_makespans_ref(*args).numpy())
        assert set(stats["walks"]) == {order.shape[1]}


def test_emulation_cuts_stages_where_the_slots_pass_the_capacity():
    """Rows of 40 real slots at 8 steps a stage (56 words past the records'
    own 4): a stage holds one step; a join of 200 slots among one-slot
    tasks fits one stage."""
    args = _random_args(np.random.default_rng(2), 2, 120, 40, 9, full=True)
    stats = {}
    _same(_sm90_emulation(*args, steps=8, stats=stats),
          R.bucket_makespans_ref(*args).numpy())
    assert min(stats["stages"]) == 1 and max(stats["stages"]) == 8
    g = fork_join(200, 2)
    plan = T.make_scheduler("hlp_est").allocate(g, T.Machine.hybrid(8, 2))
    bd, args = _bucket_args([(g, plan)], range(6))
    assert bd.pred.shape[2] >= 200
    stats = {}
    _same(_sm90_emulation(*args, steps=8, stats=stats),
          R.bucket_makespans_ref(*args).numpy())
    assert sum(stats["stages"]) == g.n


def test_walk_stops_only_where_the_skipped_steps_change_no_bit():
    """A plan padded by phantom steps walks its own length; it walks the
    whole order where the phantom task has a time (in one lane) or a floor
    other than +0.0 (-0.0 and NaN among them), a real slot, or an earlier
    visit.  Each case against the plain version, NaN in the same lanes."""
    items = _grid_items()
    small, large = items[4], items[12]
    assert small[0].n < large[0].n
    _, base = _bucket_args([small, large], range(3))
    order, pred, delay, floor, times = base
    n = small[0].n
    stats = {}
    _sm90_emulation(*base, stats=stats)
    assert stats["walks"] == [n, large[0].n]

    def variant(**change):
        o, p, d, f, t = (x.clone() for x in base)
        if "time" in change:
            t[0, 1, n] = change["time"]
        if "floor" in change:
            f[0, n] = change["floor"]
        if "slot" in change:
            p[0, n, 0], d[0, n, 0] = 0, change["slot"]
        if "visit" in change:
            first = int(o[0, 0])
            o[0, 0], o[0, n] = n, first
        return o, p, d, f, t

    cases = [{"time": 0.5}, {"time": -0.0}, {"time": float("nan")},
             {"floor": 2.0}, {"floor": -0.0}, {"floor": float("nan")},
             {"slot": 1.5}, {"visit": True}]
    for change in cases:
        args = variant(**change)
        stats = {}
        got = _sm90_emulation(*args, stats=stats)
        _same(got, R.bucket_makespans_ref(*args).numpy())
        assert stats["walks"][0] == order.shape[1], change
    assert np.isnan(_sm90_emulation(*variant(floor=float("nan")))[0]).all()


def test_lanes_per_block_at_the_shared_memory_boundaries():
    """32 lanes up to the largest n_pad whose scratch and ring fit 227 KB,
    then 16; 8 at the §6.1 grid's 4011-5011 tasks; 4 at 8192; never more
    than S rounded up to a power of two; refused where one lane does not
    fit."""
    for p_pad, last32 in ((4, 1026), (501, 964)):
        assert R.lanes_per_block(last32, p_pad) == 32
        assert R.lanes_per_block(last32 + 1, p_pad) == 16
        assert R.smem_bytes(last32, p_pad, 32) <= R.SMEM_LIMIT
        assert R.smem_bytes(last32 + 1, p_pad, 32) > R.SMEM_LIMIT
    for n_pad, p_pad in ((4011, 501), (4620, 4), (5011, 501)):
        assert R.lanes_per_block(n_pad, p_pad) == 8
    assert R.lanes_per_block(8192, 512) == 4
    assert [R.lanes_per_block(30, 3, s) for s in (1, 2, 5, 13, 32, 33)] == \
        [1, 2, 8, 16, 32, 32]
    assert R.smem_bytes(48815, 4, 1) <= R.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        R.lanes_per_block(48816, 4)


# --------------------------------------------------------------- NaN kept
def test_plain_replay_keeps_nan_as_the_reference():
    """One NaN in ``times``, in ``floor`` or in a real slot's
    ``pred_delay`` gives NaN in the lanes it reaches in the JAX package's
    jitted replay, in the plain version and in the emulation; a NaN in a
    masked slot's delay reaches none."""
    rng = np.random.default_rng(5)
    B, n, P, S = 3, 14, 4, 6
    order, pred, delay, floor, times = (a.numpy().copy() for a in
                                        _random_args(rng, B, n, P, S))
    delay = delay.astype(np.float64)
    j = int(order[1, 5])
    real = np.argwhere(pred[2] >= 0)[0]
    masked = np.argwhere(pred[0] < 0)[0]
    cases = {"times": lambda a: a["times"].__setitem__((1, 2, j), np.nan),
             "floor": lambda a: a["floor"].__setitem__((1, j), np.nan),
             "delay": lambda a: a["delay"].__setitem__((2, *real), np.nan),
             "masked": lambda a: a["delay"].__setitem__((0, *masked), np.nan)}
    for name, poke in cases.items():
        arrs = {"times": times.astype(np.float64).copy(),
                "floor": floor.astype(np.float64).copy(),
                "delay": delay.copy()}
        poke(arrs)
        ref = np.asarray(JB._bucket_makespans(
            JB.BatchedPlanDag(order=jnp.asarray(order), pred=jnp.asarray(pred),
                              pred_mask=jnp.asarray(pred >= 0),
                              pred_delay=jnp.asarray(arrs["delay"]),
                              floor=jnp.asarray(arrs["floor"]),
                              width=jnp.ones((B, n), jnp.int32)),
            jnp.asarray(arrs["times"])))
        args = (torch.from_numpy(order), torch.from_numpy(pred),
                TB._f32(arrs["delay"]), TB._f32(arrs["floor"]),
                TB._f32(arrs["times"]))
        got = R.bucket_makespans_ref(*args).numpy()
        _same(got, ref)
        _same(_sm90_emulation(*args), ref)
        lanes = np.isnan(ref)
        if name == "masked":
            assert not lanes.any()
        else:
            assert lanes.any() and not lanes.all(), name


def test_plain_maxplus_keeps_nan_as_the_pallas_kernel():
    """A NaN in either operand: the Pallas kernel in interpret mode, the
    plain version and the wrapper on CPU tensors give NaN in the same row
    or column and equal values elsewhere."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(48, 32)).astype(F32)
    b = rng.normal(size=(32, 40)).astype(F32)
    for where in ("a", "b"):
        x, y = a.copy(), b.copy()
        if where == "a":
            x[7, 3] = np.nan
        else:
            y[11, 21] = np.nan
        ref = np.asarray(jax_maxplus(jnp.asarray(x), jnp.asarray(y),
                                     interpret=True))
        tx, ty = torch.from_numpy(x), torch.from_numpy(y)
        _same(mp.maxplus_matmul_ref(tx, ty).numpy(), ref)
        _same(mp.maxplus_matmul(tx, ty).numpy(), ref)
        nan = np.isnan(ref)
        assert nan.sum() == (40 if where == "a" else 48)


# ------------------------------------------------------------- the wrapper
def test_wrapper_names_both_kernels_and_takes_the_plain_version_on_cpu():
    """One kernel is left (``csrc/replay_sm90.cu``): no ``kernel=`` choice,
    the plain version on CPU tensors, no launch off the card."""
    args = _random_args(np.random.default_rng(7), 2, 20, 3, 5)
    R.reset_launch_count()
    want = R.bucket_makespans_ref(*args)
    assert R.SOURCE == "replay_sm90" and not hasattr(R, "KERNELS")
    assert torch.equal(R.bucket_makespans(*args), want)
    with pytest.raises(ValueError, match="card"):
        R.launch(*args)
    for call in (R.bucket_makespans, R.launch):
        with pytest.raises(TypeError, match="kernel"):
            call(*args, kernel="walk")
    assert R.launch_count() == 0
