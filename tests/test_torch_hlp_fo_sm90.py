"""The redesigned first-order LP kernel's design, on the CPU.

``csrc/hlp_fo_sm90.cu`` claims to compute what ``csrc/hlp_fo.cu`` (the
gather design) computes, bit for bit: its fused walk (the exact pass of a
step beside the next step's soft forward), its merged reductions and its
reverse walk, in which each task turns its own pred slots' stored weights
into edge adjoints and its predecessors sum them in the successor CSR's
order.  ``tests/hlp_fo_emulation.py`` follows both designs in float32, task
by task and in the kernels' reduction tree; held here:

* the two designs' gradients bit for bit on the Chameleon DAGs at small nb,
  on random DAGs with fan-outs of 1-40 at widths on both sides of one warp,
  and on choice grids with and without the edges' crossing delays;
* whole solves in both designs bit for bit (best x, λ, every step's
  gradient);
* the redesign's gradient against autograd (``kernels/hlp_fo/ref.py``) at
  rtol 1e-5;
* the wrapper: ``KERNELS`` and the bare launches' ``kernel=``, the
  per-kernel counters, the shared-memory mirror of both kernels and of the
  sm90 kernel's two layouts (its edge buffer one float an edge, so a join
  500 wide fits), and no launch on the CPU.

The kernels themselves run on the card: ``tests/test_torch_hlp_fo_sm90_card.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.dag as TD  # noqa: E402
import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.kernels.hlp_fo import hlp_fo as HF  # noqa: E402
from repro_torch.kernels.hlp_fo import ref as R  # noqa: E402

import hlp_fo_emulation as E  # noqa: E402

RTOL = 1e-5


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def fan_dag(seed: int, n: int, fan: int, layers: int = 6):
    """A DAG of ``layers`` levels of n / layers tasks, whose tasks each
    draw 1 to ``fan`` successors in the next level (and each task past the
    first level has a predecessor)."""
    rng = np.random.default_rng(seed)
    parts = np.array_split(np.arange(n), layers)
    edges = set()
    for a, b in zip(parts[:-1], parts[1:]):
        for u in a:
            k = min(len(b), int(rng.integers(1, fan + 1)))
            edges.update((int(u), int(v)) for v in rng.choice(b, k, False))
        fed = {v for _, v in edges}
        edges.update((int(rng.choice(a)), int(v)) for v in b if v not in fed)
    proc = rng.uniform(0.1, 10.0, size=(n, 2))
    return TD.TaskGraph.build(proc, sorted(edges))


def _hybrid(g, seed=0, scale=1.0, step=10, m=8, k=2):
    d = TH.PaddedDag.from_graph(g, "cpu")
    z = np.float32(0.01 * scale) * TH.reference_normal(seed, (g.n,))
    tau = float(max(d.pc.max(), d.pg.max()) * R.schedule(300)[step, 0])
    return d, z, tau, {"m": m, "k": k}


def _choice(g, machine, comm, rigid, seed=3, scale=50.0):
    prob = AllocationProblem.build(g, machine, comm_aware=comm, rigid=rigid)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [np.asarray(a, np.float32) for a in (
        p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
        1.0 / np.asarray(prob.counts, np.float64))]
    d = TH.PaddedDag.from_graph(g, "cpu")
    z = np.float32(0.01 * scale) * TH.reference_normal(seed, p_dev.shape)
    tau = float(np.float32(ins[0].max() * R.schedule(300)[10, 0].item()))
    kw = dict(p_choice=ins[0], area=ins[1], type_mask=ins[2],
              inv_counts=ins[3], use_comm=prob.comm_aware)
    return d, z, tau, kw


def _designs_agree(d, z, tau, kw, what):
    g0 = E.gradient(d, z, tau, **kw)
    g1 = E.gradient_sm90(d, z, tau, **kw)
    assert np.abs(g0).max() > 0, what
    _same(g1, g0, what)
    return g1


def test_designs_agree_bit_for_bit_on_the_chameleon_dags():
    for app, nb in (("potrf", 5), ("getrf", 4), ("potri", 4)):
        g = TW.chameleon(app, nb, 512)
        for step, scale in ((0, 1.0), (250, 100.0)):
            d, z, tau, kw = _hybrid(g, step=step, scale=scale, m=64, k=8)
            _designs_agree(d, z, tau, kw, f"{app}{nb} step {step}")


@pytest.mark.parametrize("width", [20, 90])
def test_designs_agree_bit_for_bit_on_random_fan_outs(width):
    """Fan-outs of 1 to 40 at a widest level under one warp (20 tasks a
    level, 32 threads) and above it (90, three warps), at the first
    step's τ and with pools large enough that the critical path, not the
    loads, carries the gradient (so the fan-in sums' order shows)."""
    for seed, fan in ((1, 1), (2, 3), (3, 12), (4, 40)):
        g = fan_dag(seed, 6 * width, fan)
        d, z, tau, kw = _hybrid(g, seed=seed, scale=30.0, step=0, m=64,
                                k=64)
        assert d.levels == 6 and d.max_width == width
        assert (HF.threads_for(d.max_width) == 32) == (width < 32)
        assert np.diff(d.succ_ptr.numpy()).max() >= min(fan, width)
        _designs_agree(d, z, tau, kw, f"fan {fan} width {width}")


def test_designs_agree_bit_for_bit_on_choice_grids():
    nb = TS.netbound_scenario(seed=300)
    wide = TS.netbound_scenario(width=40, depth=4, seed=3)
    mo = TS.moldable_suite(seed=400, num=1, ccr=2.0)[0]
    cases = [("netbound s300, comm", nb.graph, nb.counts, True, True),
             ("netbound width 40, comm", wide.graph, (8, 2), True, True),
             ("moldable, comm", mo.graph, mo.machine, True, False),
             ("moldable", mo.graph, mo.machine, False, False)]
    for name, g, machine, comm, rigid in cases:
        d, z, tau, kw = _choice(g, machine, comm, rigid)
        assert kw["use_comm"] == comm, name
        _designs_agree(d, z, tau, kw, name)


def test_whole_solves_agree_bit_for_bit_in_both_designs():
    """Best x, λ and every step's gradient: the exact pass fused into the
    next step's forward picks the same iterate as the gather design's own
    exact pass."""
    nb = TS.netbound_scenario(seed=301)
    cases = [_hybrid(TS.default_suite(seed=0)[1].graph),
             _hybrid(fan_dag(5, 240, 8), m=16, k=4),
             _choice(nb.graph, nb.counts, True, True, scale=1.0)]
    for iters in (0, 1, 12):
        sched = R.schedule(iters)
        for d, z, _, kw in cases:
            x0, v0, g0 = E.solve(d, z, iters, sched, design="gather", **kw)
            x1, v1, g1 = E.solve(d, z, iters, sched, design="sm90", **kw)
            _same(x1, x0, f"best x, {iters} iterations")
            _same(v1, v0, f"best λ, {iters} iterations")
            assert len(g0) == len(g1) == iters
            for i, (a, b) in enumerate(zip(g0, g1)):
                _same(b, a, f"gradient at step {i} of {iters}")


def test_redesigned_gradient_matches_autograd():
    sc = TS.default_suite(seed=0)[3]
    d, z, tau, kw = _hybrid(sc.graph, scale=50.0)
    zt = torch.tensor(z, requires_grad=True)
    want, = torch.autograd.grad(R.hybrid_loss(d, zt, torch.tensor(tau), 8, 2),
                                zt)
    got = E.gradient_sm90(d, z, tau, **kw)
    want = want.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())
    for comm in (True, False):
        mo = TS.moldable_suite(seed=400, num=1, ccr=2.0)[0]
        d, z, tau, kw = _choice(mo.graph, mo.machine, comm, False)
        zt = torch.tensor(z, requires_grad=True)
        want, = torch.autograd.grad(R.choice_loss(
            d, zt, torch.tensor(tau), *[torch.tensor(kw[k]) for k in (
                "p_choice", "area", "type_mask", "inv_counts")], comm), zt)
        want = want.numpy()
        np.testing.assert_allclose(E.gradient_sm90(d, z, tau, **kw), want,
                                   rtol=RTOL, atol=1e-6 * np.abs(want).max())


def test_wrapper_names_its_kernels_and_counts_each():
    """The bare launches take ``kernel=`` and refuse an unknown name; the
    public entries take none (the card path is sm90) and on the CPU take
    the plain version, launching nothing."""
    assert HF.KERNELS == ("sm90", "gather")
    assert set(HF.PHASES) == set(HF.KERNELS)
    g = TW.chameleon("potrf", 4, 512)
    d = TH.PaddedDag.from_graph(g, "cpu")
    z0 = torch.zeros(g.n)
    HF.reset_launch_count()
    x, v = HF.hybrid(d, z0, m=4, k=2, iters=3)
    rx, rv = R.hybrid_solve_ref(d, z0, m=4, k=2, iters=3)
    assert torch.equal(x, rx) and torch.equal(v, rv)
    assert HF.launch_counts() == {"sm90": 0, "gather": 0}
    assert HF.launch_count() == 0
    for call in (lambda: HF.launch_hybrid(d, z0, m=4, k=2, iters=3,
                                          kernel="sm80"),
                 lambda: HF.smem_bytes(10, 2, kernel="warp")):
        with pytest.raises(ValueError, match="no first-order LP kernel"):
            call()
    with pytest.raises(TypeError, match="kernel"):
        HF.hybrid(d, z0, m=4, k=2, iters=3, kernel="gather")
    with pytest.raises(TypeError, match="task_cycles"):
        HF.launch_choice(d, torch.zeros((g.n, 1)), *[torch.ones(1)] * 4,
                         iters=3, use_comm=False, task_cycles=None)
    # the bare launches need the card, whichever kernel
    for k in HF.KERNELS:
        with pytest.raises(ValueError, match="card"):
            HF.launch_hybrid(d, z0, m=4, k=2, iters=3, kernel=k)
    with pytest.raises(ValueError, match="gather kernel's reverse split"):
        HF._launch("sm90", "hybrid", d, [], [], 1, g.n, z0, None,
                   torch.zeros((g.n, 3), dtype=torch.int64))


def fork_join(width: int, joins: int, seed: int = 1):
    """``joins`` fork-joins in a row, each of ``width`` parallel tasks
    between a fork and a join: the join's pred row is ``width`` wide."""
    rng = np.random.default_rng(seed)
    edges, prev, t = [], 0, 1
    for _ in range(joins):
        mid = range(t, t + width)
        edges += [(prev, m) for m in mid] + [(m, t + width) for m in mid]
        prev, t = t + width, t + width + 1
    return TD.TaskGraph.build(rng.uniform(0.1, 10.0, (t, 2)), edges)


def test_shared_memory_mirror_of_both_layouts():
    """``smem_bytes`` against the two kernels' layouts counted here, the
    sm90 kernel's choice of layout, and the largest problem each layout
    takes at P = 3 (the Chameleon DAGs' pred width)."""
    tail = {"sm90": 16 * 18, "gather": 16 * 17}

    def sm90(n, L, c, q, comm, e, layout):
        per_task = n * c + 4 * n + e + (n * q if comm else 0)
        return 4 * ((per_task if layout == "shared" else 0) + q * c + q
                    + L + 1 + tail["sm90"])

    def gather(n, L, c, q, comm):
        return 4 * (n * c + 3 * n + (n * q if comm else 0) + q * c + q + L
                    + 1 + tail["gather"])
    for n, L, c, q, comm, e in ((4620, 60, 1, 0, False, 12840),
                                (60, 5, 2, 2, True, 90),
                                (20, 7, 8, 2, False, 40),
                                (1003, 5, 1, 0, False, 2000)):
        for layout in HF.LAYOUTS:
            assert HF.smem_bytes(n, L, c, q, comm, e=e, layout=layout) == \
                sm90(n, L, c, q, comm, e, layout)
        assert HF.smem_bytes(n, L, c, q, comm, e=e, kernel="gather") == \
            gather(n, L, c, q, comm)
    with pytest.raises(ValueError, match="no layout"):
        HF.smem_bytes(10, 2, layout="texture")
    # the edge buffer holds one float an edge, whatever the widest join:
    # fork-joins of width 500 (a pred row 500 wide) fit the shared layout
    g = fork_join(500, 2)
    d = TH.PaddedDag.from_graph(g, "cpu")
    E = int(d.succ_task.shape[0])
    assert d.pred.shape[1] == 500 and E == 2000
    assert HF.layout_for(g.n, d.levels, e=E) == "shared"
    assert HF._check_size(d, 1, 0, False) == 0
    # at P = 3 and 60 levels (3 edges a task): the shared layout takes
    # 7220 tasks (8 floats a task), the gather kernel 14444 (4); past
    # them the sm90 kernel takes the global layout, whose shared part is
    # the tail alone, until the level offsets fill shared memory
    assert HF.layout_for(4620, 60, e=3 * 4620) == "shared"
    assert HF.layout_for(7220, 60, e=3 * 7220) == "shared"
    assert HF.layout_for(7221, 60, e=3 * 7221) == "global"
    assert HF.layout_for(10 ** 6, 60, e=3 * 10 ** 6) == "global"
    assert HF.smem_bytes(14444, 60, kernel="gather") <= HF.SMEM_LIMIT
    assert HF.smem_bytes(14445, 60, kernel="gather") > HF.SMEM_LIMIT
    most = HF.SMEM_LIMIT // 4 - tail["sm90"] - 1
    assert HF.layout_for(100, most, e=99) == "global"
    with pytest.raises(ValueError, match=f"global layout, more than the "
                                         f"{HF.SMEM_LIMIT}"):
        HF.layout_for(100, most + 1, e=99)
    # the launch's scratch: 0 in the shared layout, the per-task arrays in
    # the global one; past the gather kernel's layout, it raises
    big = TH.PaddedDag.from_graph(TW.chameleon("potri", 20, 512), "cpu")
    E = int(big.succ_task.shape[0])
    assert HF._check_size(big, 1, 0, False) == 0
    assert HF._check_size(big, 1, 0, False, "gather") == 0
    assert HF._check_size(big, 8, 2, True) == big.n * (8 + 4 + 2) + E
    with pytest.raises(ValueError, match=f"gather kernel, more than the "
                                         f"{HF.SMEM_LIMIT}"):
        HF._check_size(big, 8, 2, True, "gather")
