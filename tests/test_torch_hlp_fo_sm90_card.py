"""The redesigned first-order LP kernel ``csrc/hlp_fo_sm90.cu`` against the
first design ``csrc/hlp_fo.cu``, bit for bit, on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_hlp_fo_sm90_card.py

Both kernels keep every float operation's operands and rounding and every
sum's order, so their best x and λ are the same bits: on random DAGs at
widths on both sides of one warp, on the lp phase's Chameleon instances,
on the choice grids with and without edge delays, at the edges of the
redesign's two layouts (shared memory, and a scratch buffer past it) and
on a join 500 wide.  Also: concurrent solves from threads equal serial
ones, each kernel's counter, the unknown-kernel and oversize errors, and
the library's shared-memory mirror.
"""
import concurrent.futures
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.dag as TD  # noqa: E402
import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.kernels.hlp_fo import hlp_fo as HF  # noqa: E402

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    """The card, for tests that launch the kernels; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def layered_dag(seed: int, width: int, levels: int, fan: int):
    """``levels`` levels of ``width`` tasks; each task draws 1 to ``fan``
    successors in the next level, and each task past the first has a
    predecessor."""
    rng = np.random.default_rng(seed)
    parts = np.arange(width * levels).reshape(levels, width)
    edges = set()
    for a, b in zip(parts[:-1], parts[1:]):
        for u in a:
            k = int(rng.integers(1, min(fan, width) + 1))
            edges.update((int(u), int(v)) for v in rng.choice(b, k, False))
        fed = {v for _, v in edges}
        edges.update((int(rng.choice(a)), int(v)) for v in b if v not in fed)
    proc = rng.uniform(0.1, 10.0, size=(width * levels, 2))
    return TD.TaskGraph.build(proc, sorted(edges))


def _bits(t):
    return t.float().cpu().numpy().view(np.int32)


def _same(a, b, what):
    (ax, av), (bx, bv) = a, b
    np.testing.assert_array_equal(_bits(ax), _bits(bx), err_msg=what)
    assert _bits(av) == _bits(bv), (what, float(av), float(bv))


def _hybrid_both(g, m, k, iters=300):
    d = TH.PaddedDag.from_graph(g, "cuda")
    z0 = torch.tensor(np.float32(0.01) * TH.reference_normal(0, (g.n,)),
                      device="cuda")
    return [HF.launch_hybrid(d, z0, m=m, k=k, iters=iters, kernel=kern)
            for kern in HF.KERNELS]


def _choice_inputs(g, machine, comm, rigid):
    prob = AllocationProblem.build(g, machine, comm_aware=comm, rigid=rigid)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [torch.tensor(np.asarray(a, np.float32), device="cuda") for a in (
        p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
        1.0 / np.asarray(prob.counts, np.float64))]
    z0 = torch.tensor(np.float32(0.01) * TH.reference_normal(0, p_dev.shape),
                      device="cuda")
    return TH.PaddedDag.from_graph(g, "cuda"), z0, ins, prob.comm_aware


def test_kernels_agree_bit_for_bit_on_random_dags(card):
    HF.reset_launch_count()
    cases = [(20, 6, 1), (20, 6, 40), (90, 8, 3), (90, 8, 40), (300, 5, 12)]
    for seed, (width, levels, fan) in enumerate(cases):
        g = layered_dag(seed, width, levels, fan)
        a, b = _hybrid_both(g, 64, 64, iters=120)
        _same(a, b, f"width {width}, fan {fan}")
    assert HF.launch_counts() == {"sm90": len(cases), "gather": len(cases)}


def test_kernels_agree_bit_for_bit_on_the_lp_instances(card):
    for app, nb in (("potrf", 10), ("getrf", 10), ("potri", 20)):
        a, b = _hybrid_both(TW.chameleon(app, nb, 512), 64, 8)
        _same(a, b, f"{app}{nb}")
    for sc in TS.default_suite(seed=0) + TS.default_suite(seed=100,
                                                         counts=(16, 4)):
        a, b = _hybrid_both(sc.graph, *sc.counts)
        _same(a, b, sc.name)


def test_kernels_agree_bit_for_bit_on_choice_grids(card):
    nb = TS.netbound_scenario(seed=300)
    wide = TS.netbound_scenario(width=40, depth=5, seed=3)
    mo = TS.moldable_suite(seed=400, num=1, ccr=2.0)[0]
    cases = [(nb.graph, nb.counts, True, True),
             (wide.graph, (8, 2), True, True),
             (mo.graph, mo.machine, True, False),
             (mo.graph, mo.machine, False, False)]
    for g, machine, comm, rigid in cases:
        d, z0, ins, use_comm = _choice_inputs(g, machine, comm, rigid)
        assert use_comm == comm
        a, b = [HF.launch_choice(d, z0, *ins, iters=300, use_comm=use_comm,
                                 kernel=kern) for kern in HF.KERNELS]
        _same(a, b, f"n={g.n} comm={comm}")
        np.testing.assert_allclose(a[0].sum(1).cpu().numpy(), 1, rtol=1e-5)


def test_concurrent_solves_from_threads_equal_serial_ones(card):
    graphs = [sc.graph for sc in TS.default_suite(seed=0)
              + TS.comm_suite(seed=50)]

    def solve(g):
        return TH.solve_hlp_jax(g, 8, 2, iters=100, device="cuda")

    serial = [solve(g) for g in graphs]
    HF.reset_launch_count()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(solve, graphs))
    assert HF.launch_counts() == {"sm90": len(graphs), "gather": 0}
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a.x_frac, b.x_frac)
        assert a.lp_value == b.lp_value


def test_both_layouts_agree_at_their_edges_and_on_a_wide_join(card):
    """At P = 3 and 60 levels (three preds a task past the first level),
    the largest problem of the shared layout and one task more, which
    takes the global layout, both equal the gather kernel bit for bit.
    Past the gather kernel's limit (14444 tasks) the sm90 kernel still
    runs, held to the plain version.  A fork-join of width 500 (a pred row
    500 wide) fits the shared layout, its edge buffer one float an edge,
    and equals the gather kernel."""
    rng = np.random.default_rng(7)

    def edges(n):
        return 3 * (n - -(-n // 60))

    def dag(n):
        levels = np.array_split(np.arange(n), 60)
        es = [(int(u), int(v)) for a, b in zip(levels[:-1], levels[1:])
              for v in b for u in rng.choice(a, 3, replace=False)]
        return TD.TaskGraph.build(rng.uniform(0.1, 10.0, (n, 2)), es)

    def layout(d):
        return HF.layout_for(d.n, d.levels, e=int(d.succ_task.shape[0]))
    edge = max(n for n in range(6000, 9000)
               if HF.layout_for(n, 60, e=edges(n)) == "shared")
    for n, want in ((edge, "shared"), (edge + 1, "global")):
        d = TH.PaddedDag.from_graph(dag(n), "cuda")
        assert d.pred.shape[1] == 3 and d.levels == 60
        assert int(d.succ_task.shape[0]) == edges(n) and layout(d) == want
        z0 = torch.zeros(n, device="cuda")
        a, b = [HF.launch_hybrid(d, z0, m=64, k=8, iters=20, kernel=kern)
                for kern in HF.KERNELS]
        _same(a, b, f"{n} tasks, {want} layout")
    g = dag(14445)
    d = TH.PaddedDag.from_graph(g, "cuda")
    assert layout(d) == "global"
    z0 = torch.zeros(g.n, device="cuda")
    with pytest.raises(ValueError, match=f"gather kernel, more than the "
                                         f"{HF.SMEM_LIMIT}"):
        HF.launch_hybrid(d, z0, m=64, k=8, iters=20, kernel="gather")
    x, v = HF.launch_hybrid(d, z0, m=64, k=8, iters=20)
    rx, rv = HF.hybrid(TH.PaddedDag.from_graph(g, "cpu"), z0.cpu(), m=64,
                       k=8, iters=20)
    np.testing.assert_allclose(float(v), float(rv), rtol=1e-5)
    assert bool(torch.isfinite(x).all())
    rng2 = np.random.default_rng(1)
    fj_edges, prev, t = [], 0, 1
    for _ in range(2):
        mid = range(t, t + 500)
        fj_edges += [(prev, m) for m in mid] + [(m, t + 500) for m in mid]
        prev, t = t + 500, t + 501
    fj = TD.TaskGraph.build(rng2.uniform(0.1, 10.0, (t, 2)), fj_edges)
    d = TH.PaddedDag.from_graph(fj, "cuda")
    assert d.pred.shape[1] == 500 and layout(d) == "shared"
    a, b = _hybrid_both(fj, 8, 2)
    _same(a, b, "fork-join of width 500")


def test_errors_and_the_librarys_mirror(card):
    from repro_torch.kernels import build
    lib = build.load("hlp_fo_sm90")
    lib.hlp_fo_sm90_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.hlp_fo_sm90_smem_bytes.restype = ctypes.c_longlong
    for n, L, c, q, e, comm in ((4620, 60, 1, 0, 12840, 0),
                                (60, 5, 2, 2, 90, 1), (20, 7, 8, 2, 40, 0),
                                (1003, 5, 1, 0, 2000, 0),
                                (7221, 60, 1, 0, 21663, 0)):
        for shared, layout in ((1, "shared"), (0, "global")):
            assert lib.hlp_fo_sm90_smem_bytes(n, L, c, q, e, comm,
                                              shared) == \
                HF.smem_bytes(n, L, c, q, bool(comm), e=e, layout=layout)
    g = TW.chameleon("potrf", 6, 512)
    d = TH.PaddedDag.from_graph(g, "cuda")
    z0 = torch.zeros(g.n, device="cuda")
    HF.reset_launch_count()
    with pytest.raises(ValueError, match="no first-order LP kernel"):
        HF.launch_hybrid(d, z0, m=4, k=2, iters=3, kernel="fma")
    with pytest.raises(ValueError, match="gather kernel's reverse split"):
        HF.launch_hybrid(d, z0, m=4, k=2, iters=3,
                         task_cycles=torch.zeros((g.n, 3), dtype=torch.int64,
                                                 device="cuda"))
    assert HF.launch_count() == 0
    # the phase splits and the gather kernel's reverse split
    for kern in HF.KERNELS:
        cycles = torch.zeros(len(HF.PHASES[kern]), dtype=torch.int64,
                             device="cuda")
        HF.launch_hybrid(d, z0, m=4, k=2, iters=3, kernel=kern,
                         cycles=cycles)
        assert bool((cycles > 0).all()), kern
    split = torch.zeros((g.n, len(HF.REVERSE_PARTS)), dtype=torch.int64,
                        device="cuda")
    x1, v1 = HF.launch_hybrid(d, z0, m=4, k=2, iters=3, kernel="gather",
                              task_cycles=split)
    x2, v2 = HF.launch_hybrid(d, z0, m=4, k=2, iters=3)
    _same((x1, v1), (x2, v2), "split launch")
    assert bool((split[:, 0] > 0).all()) and bool((split[:, 2] > 0).all())
    assert HF.launch_counts() == {"sm90": 2, "gather": 2}
