"""The first-order LP kernel ``csrc/hlp_fo_sm90.cu`` in its two layouts,
bit for bit, on the card.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_hlp_fo_sm90_card.py

The shared layout (the per-task arrays and the edge buffer in shared
memory) and the global one (the same arrays in a scratch buffer, which
``layout="global"`` forces) run the same float operations in the same
order, so their best x and λ are the same bits: on random DAGs at widths on
both sides of one warp, on the lp phase's Chameleon instances, on the
choice grids with and without edge delays, at the edge of the shared
layout and on a join 500 wide.  On netbound seed 300 (ROADMAP C6, closed)
the choice entry takes XLA:CPU's own exp and log (``csrc/xla_math.cuh``,
whose card build ``hlp_fo.transcendental`` equals the plain version's
twins bit for bit), is the plain version bit for bit, and its best x is
the reference's pinned one (``tests/torch_hlp_fo_netbound_pin.json``) at
160, 250 and 300 iterations, λ within ``NETBOUND_REF_RTOL``.  Past the
shared layout and past the first
design's limit (14444 tasks, ``csrc/hlp_fo.cu``, since deleted) the kernel
is held to the plain version.  Also: concurrent solves from threads equal
serial ones, the counter, the phase split and the library's
shared-memory mirror.
"""
import concurrent.futures
import ctypes
import json
from pathlib import Path

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

#: the kernel against the plain version on netbound seed 300, as
#: ``chip_smoke.py``'s ``LP_NETBOUND_RTOL``: both take XLA's exp and log, so
#: bit for bit (with the card's expf / logf it was 4e-5: 3.79e-5 at 300
#: iterations on the H100)
NETBOUND_RTOL = 0.0
#: the kernel against the reference's pinned best x on netbound seed 300,
#: as ``chip_smoke.py``'s ``LP_NETBOUND_REF_RTOL`` (was 5e-5: 6.0e-7 /
#: 2.43e-5 / 4.87e-5 at 160 / 250 / 300 iterations on the H100 with the
#: card's expf / logf; the plain version now gives the pin's x bit for bit)
NETBOUND_REF_RTOL = 0.0
NETBOUND_PIN = Path(__file__).resolve().parent / "torch_hlp_fo_netbound_pin.json"
MOLDABLE_PIN = Path(__file__).resolve().parent / "torch_hlp_fo_moldable_pin.json"
#: the hybrid entry's best x (SHA-256 of its float32 bytes) and λ on the
#: H100 (:func:`test_hybrid_solves_keep_their_pinned_bits`)
HYBRID_PIN = Path(__file__).resolve().parent / "torch_hlp_fo_hybrid_pin.json"


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
    """The solve in the shared and in the global layout."""
    d = TH.PaddedDag.from_graph(g, "cuda")
    z0 = torch.tensor(np.float32(0.01) * TH.reference_normal(0, (g.n,)),
                      device="cuda")
    return [HF.launch_hybrid(d, z0, m=m, k=k, iters=iters, layout=layout)
            for layout in HF.LAYOUTS]


def _choice_inputs(g, machine, comm, rigid):
    prob = AllocationProblem.build(g, machine, comm_aware=comm, rigid=rigid)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [torch.tensor(np.asarray(a, np.float32), device="cuda") for a in (
        p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
        1.0 / np.asarray(prob.counts, np.float64))]
    z0 = torch.tensor(np.float32(0.01) * TH.reference_normal(0, p_dev.shape),
                      device="cuda")
    return TH.PaddedDag.from_graph(g, "cuda"), z0, ins, prob.comm_aware


def test_layouts_agree_bit_for_bit_on_random_dags(card):
    HF.reset_launch_count()
    cases = [(20, 6, 1), (20, 6, 40), (90, 8, 3), (90, 8, 40), (300, 5, 12)]
    for seed, (width, levels, fan) in enumerate(cases):
        g = layered_dag(seed, width, levels, fan)
        a, b = _hybrid_both(g, 64, 64, iters=120)
        _same(a, b, f"width {width}, fan {fan}")
    assert HF.launch_count() == 2 * len(cases)


def test_layouts_agree_bit_for_bit_on_the_lp_instances(card):
    for app, nb in (("potrf", 10), ("getrf", 10), ("potri", 20)):
        a, b = _hybrid_both(TW.chameleon(app, nb, 512), 64, 8)
        _same(a, b, f"{app}{nb}")
    for sc in TS.default_suite(seed=0) + TS.default_suite(seed=100,
                                                         counts=(16, 4)):
        a, b = _hybrid_both(sc.graph, *sc.counts)
        _same(a, b, sc.name)


def test_layouts_agree_bit_for_bit_on_choice_grids(card):
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
                                 layout=layout) for layout in HF.LAYOUTS]
        _same(a, b, f"n={g.n} comm={comm}")
        np.testing.assert_allclose(a[0].sum(1).cpu().numpy(), 1, rtol=1e-5)


def test_choice_kernel_holds_the_plain_version_on_netbound_s300(card):
    """The ill-conditioned instance of ROADMAP C6: the choice entry runs
    the program XLA compiles for the reference's solve in the kernel and in
    the plain version (``ref.choice_solve_ref``), its exp and log
    included, so on netbound seed 300 the kernel's λ lies within
    ``NETBOUND_RTOL`` (0) of the plain version's at 160, 250 and 300
    iterations, its best x the plain version's bit for bit and the two
    layouts bit for bit."""
    from repro_torch.kernels.hlp_fo import ref as R
    nb = TS.netbound_scenario(seed=300)
    d, z0, ins, use_comm = _choice_inputs(nb.graph, nb.counts, True, True)
    dc = TH.PaddedDag.from_graph(nb.graph, "cpu")
    for iters in (160, 250, 300):
        a, b = [HF.launch_choice(d, z0, *ins, iters=iters, use_comm=use_comm,
                                 layout=layout) for layout in HF.LAYOUTS]
        _same(a, b, f"netbound s300, {iters} iterations")
        rx, rv = R.choice_solve_ref(dc, z0.cpu(), *[t.cpu() for t in ins],
                                    iters=iters, use_comm=use_comm)
        kx, kv = a[0].cpu(), float(a[1])
        print(f"{iters} iterations: λ kernel {kv!r}, plain {float(rv)!r}, "
              f"rel {abs(kv / float(rv) - 1):.3e}")
        assert abs(kv / float(rv) - 1) <= NETBOUND_RTOL, iters
        _same(a, (rx, rv), f"kernel and plain version, {iters} iterations")


def test_choice_kernel_is_the_plain_version_given_the_cards_transcendentals(card):
    """The choice kernel's transcendentals on the card
    (``hlp_fo.transcendental``, ``csrc/xla_math.cuh``) equal the plain
    version's twins of XLA's exp and log bit for bit (a NaN's payload
    aside) on 2^22 random bit patterns and the solve's ranges; so
    ``choice_solve_ref`` gives the kernel's best x and λ bit for bit at
    160, 250 and 300 iterations on netbound seed 300, and against the
    reference's pinned best x the kernel's λ (``frac_objective`` of x
    normalised) lies within ``NETBOUND_REF_RTOL`` of the pinned x's λ taken
    on the same host, its x the pin's bit for bit."""
    from repro_torch.core.allocation import frac_objective
    from repro_torch.kernels.hlp_fo import ref as R
    nb = TS.netbound_scenario(seed=300)
    d, z0, ins, use_comm = _choice_inputs(nb.graph, nb.counts, True, True)
    dc = TH.PaddedDag.from_graph(nb.graph, "cpu")
    prob = AllocationProblem.build(nb.graph, nb.counts, comm_aware=True,
                                   rigid=True)
    pin = json.loads(NETBOUND_PIN.read_text())

    from repro_torch.kernels.hlp_fo.xla_math import xla_exp_f32, xla_log_f32
    bits = np.random.default_rng(3).integers(0, 2 ** 32, 2 ** 22,
                                             dtype=np.uint64)
    sweep = torch.from_numpy(np.concatenate([
        bits.astype(np.uint32).view(np.float32),
        np.linspace(-90, 90, 2 ** 20, dtype=np.float32),
        np.geomspace(1e-30, 1e4, 2 ** 20).astype(np.float32)]))
    for op, twin in (("exp", xla_exp_f32), ("log", xla_log_f32)):
        got, want = HF.transcendental(sweep.to(card), op).cpu(), twin(sweep)
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            got.isnan() & want.isnan())
        assert bool(same.all()), (op, int((~same).sum()))

    def lam(x):
        x = np.asarray(x, np.float64)
        return frac_objective(prob, x / x.sum(axis=1, keepdims=True))
    for iters in (160, 250, 300):
        kx, kv = HF.launch_choice(d, z0, *ins, iters=iters,
                                  use_comm=use_comm)
        wx, wv = R.choice_solve_ref(dc, z0.cpu(), *[t.cpu() for t in ins],
                                    iters=iters, use_comm=use_comm)
        _same((kx, kv), (wx, wv), f"netbound s300, {iters} iterations")
        ref = pin[str(iters)]
        gap = abs(lam(kx.cpu().numpy()) / lam(ref["x"]) - 1)
        print(f"{iters} iterations: kernel λ rel to the reference {gap:.3e}")
        assert gap <= NETBOUND_REF_RTOL, (iters, gap)
        np.testing.assert_array_equal(
            kx.cpu().numpy().view(np.int32),
            np.asarray(ref["x"], np.float32).view(np.int32))


def test_choice_kernel_gives_the_references_moldable_x(card):
    """ROADMAP C6's moldable half, closed: on moldable_suite seed 400 (20
    tasks, 8 choices, 3 pred slots), with and without the crossing delays,
    from the pinned z0 of the reference's own program, the kernel's best x
    and λ equal the plain version's (``ref.choice_solve_ref``) bit for bit
    and its best x the reference's pinned one at 160, 250 and 300
    iterations (``tests/torch_hlp_fo_moldable_pin.json``)."""
    from repro_torch.kernels.hlp_fo import ref as R
    mo = TS.moldable_suite(seed=400, num=1, ccr=2.0)[0]
    dc = TH.PaddedDag.from_graph(mo.graph, "cpu")
    pins = json.loads(MOLDABLE_PIN.read_text())
    for comm in (True, False):
        d, _, ins, use_comm = _choice_inputs(mo.graph, mo.machine, comm,
                                             False)
        pin = pins["comm" if comm else "no_comm"]
        z0 = torch.tensor(np.asarray(pin["z0"], np.float32), device=card)
        for iters in (160, 250, 300):
            kx, kv = HF.launch_choice(d, z0, *ins, iters=iters,
                                      use_comm=use_comm)
            wx, wv = R.choice_solve_ref(dc, z0.cpu(), *[t.cpu() for t in ins],
                                        iters=iters, use_comm=use_comm)
            _same((kx, kv), (wx, wv), f"moldable comm={comm}, {iters}")
            np.testing.assert_array_equal(
                kx.cpu().numpy().view(np.int32),
                np.asarray(pin[str(iters)]["x"], np.float32).view(np.int32))


def test_hybrid_solves_keep_their_pinned_bits(card):
    """The hybrid entry keeps the card's expf / logf (only the choice entry
    takes XLA's), so its best x and λ on the lp phase's instances and on
    the full grid's largest ``hlp_jax_ols`` graph are the bits pinned in
    ``tests/torch_hlp_fo_hybrid_pin.json`` (an H100 run of the kernel
    before the choice entry changed), in both layouts.  (Held to its
    plain version only at rtol 1e-5 elsewhere, a change to the hybrid's
    transcendentals would pass unseen.)"""
    import hashlib
    pin = json.loads(HYBRID_PIN.read_text())["instances"]
    graphs = {f"{a}{nb}": TW.chameleon(a, nb, 512)
              for a, nb in (("potrf", 10), ("getrf", 10), ("potri", 20))}
    graphs["campaign"] = max(TS.default_suite(seed=0) + TS.comm_suite(seed=50),
                             key=lambda sc: sc.graph.n).graph
    assert set(graphs) == set(pin)
    for name, g in graphs.items():
        z0 = torch.tensor(np.float32(0.01) * TH.reference_normal(0, (g.n,)),
                          device=card)
        d = TH.PaddedDag.from_graph(g, card)
        for layout in HF.LAYOUTS:
            x, lam = HF.launch_hybrid(d, z0, m=64, k=8, iters=300,
                                      layout=layout)
            digest = hashlib.sha256(
                x.cpu().numpy().astype(np.float32).tobytes()).hexdigest()
            assert digest == pin[name]["x_sha256"], (name, layout)
            assert float(lam) == pin[name]["lam"], (name, layout)


def test_concurrent_solves_from_threads_equal_serial_ones(card):
    graphs = [sc.graph for sc in TS.default_suite(seed=0)
              + TS.comm_suite(seed=50)]

    def solve(g):
        return TH.solve_hlp_jax(g, 8, 2, iters=100, device="cuda")

    serial = [solve(g) for g in graphs]
    HF.reset_launch_count()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(solve, graphs))
    assert HF.launch_count() == len(graphs)
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a.x_frac, b.x_frac)
        assert a.lp_value == b.lp_value


def test_both_layouts_agree_at_their_edges_and_on_a_wide_join(card):
    """At P = 3 and 60 levels (three preds a task past the first level),
    the largest problem of the shared layout equals its global-layout
    solve bit for bit, and one task more takes the global layout.  Past
    the first design's limit (14444 tasks) the kernel still runs, held to
    the plain version.  A fork-join of width 500 (a pred row 500 wide)
    fits the shared layout, its edge buffer one float an edge, and equals
    its global-layout solve."""
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
    d = TH.PaddedDag.from_graph(dag(edge), "cuda")
    assert d.pred.shape[1] == 3 and d.levels == 60
    assert int(d.succ_task.shape[0]) == edges(edge)
    assert layout(d) == "shared"
    z0 = torch.zeros(edge, device="cuda")
    a, b = [HF.launch_hybrid(d, z0, m=64, k=8, iters=20, layout=lay)
            for lay in HF.LAYOUTS]
    _same(a, b, f"{edge} tasks in both layouts")
    with pytest.raises(ValueError, match="takes the global layout"):
        HF.launch_hybrid(TH.PaddedDag.from_graph(dag(edge + 1), "cuda"),
                         torch.zeros(edge + 1, device="cuda"), m=64, k=8,
                         iters=20, layout="shared")
    for n in (edge + 1, 14445):
        g = dag(n)
        d = TH.PaddedDag.from_graph(g, "cuda")
        assert layout(d) == "global"
        z0 = torch.zeros(g.n, device="cuda")
        x, v = HF.launch_hybrid(d, z0, m=64, k=8, iters=20)
        rx, rv = HF.hybrid(TH.PaddedDag.from_graph(g, "cpu"), z0.cpu(),
                           m=64, k=8, iters=20)
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
    with pytest.raises(TypeError, match="kernel"):
        HF.launch_hybrid(d, z0, m=4, k=2, iters=3, kernel="gather")
    assert HF.launch_count() == 0
    # the phase split
    cycles = torch.zeros(len(HF.PHASES), dtype=torch.int64,
                         device="cuda")
    x1, v1 = HF.launch_hybrid(d, z0, m=4, k=2, iters=3, cycles=cycles)
    assert bool((cycles > 0).all())
    x2, v2 = HF.launch_hybrid(d, z0, m=4, k=2, iters=3)
    _same((x1, v1), (x2, v2), "split launch")
    assert HF.launch_count() == 2
