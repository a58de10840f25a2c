"""The first-order LP's kernel (``csrc/hlp_fo_sm90.cu``) against its plain
version, on the card; its two layouts against each other bit for bit:
``tests/test_torch_hlp_fo_sm90_card.py``.

Every test carries the ``card`` marker, asks for the ``card`` fixture
(which skips without a card) and imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_hlp_fo_card.py

Both entry points run the same problems as the plain version
(``kernels/hlp_fo/ref.py``) on CPU copies, from the same starting logits:
best λ at rtol 1e-5 (the kernel's gradient is hand-written, autograd's
agrees with it to rounding) and identical rounded allocations.  Also: one
launch a solve, concurrent solves from threads, the ``hlp_jax_ols``
adapter's golden cell through the kernel, the layout past 227 KB, the
argument checks, the chain probe and the split launch.
"""
import concurrent.futures
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.kernels.hlp_fo import hlp_fo as HF  # noqa: E402

pytestmark = pytest.mark.card
RTOL = 1e-5
GOLDEN = Path(__file__).resolve().parent / "golden_width1.json"


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _hybrid_pair(g, m, k, iters=300):
    z0 = np.float32(0.01) * TH.reference_normal(0, (g.n,))
    out = []
    for dev in ("cpu", "cuda"):
        d = TH.PaddedDag.from_graph(g, dev)
        x, v = HF.hybrid(d, torch.tensor(z0, device=dev), m=m, k=k,
                         iters=iters)
        out.append((x.cpu().numpy(), float(v)))
    return out


def _choice_pair(g, machine, comm, rigid, iters=300):
    prob = AllocationProblem.build(g, machine, comm_aware=comm, rigid=rigid)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
           1.0 / np.asarray(prob.counts, dtype=np.float64)]
    z0 = np.float32(0.01) * TH.reference_normal(0, p_dev.shape)
    out = []
    for dev in ("cpu", "cuda"):
        d = TH.PaddedDag.from_graph(g, dev)
        t = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in ins]
        x, v = HF.choice(d, torch.tensor(z0, device=dev), *t, iters=iters,
                         use_comm=prob.comm_aware)
        out.append((x.cpu().numpy(), float(v)))
    return out


def test_hybrid_kernel_matches_the_plain_version(card):
    cases = [(sc.graph, 8, 2) for sc in TS.default_suite(seed=0)]
    cases += [(TW.chameleon(app, 10, 512), 64, 8) for app in ("potrf",
                                                              "getrf")]
    HF.reset_launch_count()
    for g, m, k in cases:
        (rx, rv), (kx, kv) = _hybrid_pair(g, m, k)
        assert kv == pytest.approx(rv, rel=RTOL), g.n
        np.testing.assert_array_equal(kx >= 0.5, rx >= 0.5)
        assert ((kx >= 0) & (kx <= 1)).all()
    assert HF.launch_count() == len(cases)


def test_choice_kernel_matches_the_plain_version(card):
    cases = [(sc.graph, (8, 2), True, True)
             for sc in TS.comm_suite(seed=50)[:3]]
    for sc in TS.moldable_suite(seed=400, num=2, ccr=2.0):
        cases += [(sc.graph, sc.machine, True, False),
                  (sc.graph, sc.machine, False, False)]
    HF.reset_launch_count()
    for g, machine, comm, rigid in cases:
        (rx, rv), (kx, kv) = _choice_pair(g, machine, comm, rigid)
        assert kv == pytest.approx(rv, rel=RTOL), (g.n, comm)
        np.testing.assert_array_equal(kx.argmax(1), rx.argmax(1))
        np.testing.assert_allclose(kx.sum(1), 1, rtol=1e-5)
    assert HF.launch_count() == len(cases)


def test_concurrent_solves_from_threads_equal_serial_ones(card):
    graphs = [sc.graph for sc in TS.default_suite(seed=0)
              + TS.default_suite(seed=100, counts=(16, 4))]

    def solve(g):
        return TH.solve_hlp_jax(g, 8, 2, iters=100, device="cuda")

    serial = [solve(g) for g in graphs]
    HF.reset_launch_count()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(solve, graphs))
    assert HF.launch_count() == len(graphs)
    for a, b in zip(serial, threaded):
        np.testing.assert_array_equal(a.alloc, b.alloc)
        assert a.lp_value == b.lp_value


def _sched_hash(s) -> str:
    h = hashlib.sha256()
    for a in (np.asarray(s.alloc, np.int64), np.asarray(s.proc, np.int64),
              np.asarray(s.start, np.float64),
              np.asarray(s.finish, np.float64)):
        h.update(a.tobytes())
    return h.hexdigest()


def test_the_adapter_replays_its_golden_cell_through_the_kernel(card):
    exp = json.loads(GOLDEN.read_text())["random_n9_s7"]["hlp_jax_ols"]
    sc = TS.random_scenario(n=9, seed=7, counts=(3, 2))
    g = sc.graph.with_speedup(np.ones((sc.graph.n, 1)))
    HF.reset_launch_count()
    r0 = T.simulate(g, sc.machine, T.make_scheduler("hlp_jax_ols"),
                    seed=sc.seed)
    r1 = T.simulate(g, sc.machine, T.make_scheduler("hlp_jax_ols"),
                    noise=T.NoiseModel("lognormal", 0.2), seed=sc.seed)
    assert HF.launch_count() == 2
    assert (r0.makespan, r1.makespan) == (exp["clean"], exp["noisy"])
    assert _sched_hash(r0.schedule) == exp["hash_clean"]
    assert _sched_hash(r1.schedule) == exp["hash_noisy"]


def test_layout_limits_and_checks(card):
    g = TW.chameleon("potri", 20, 512)
    d = TH.PaddedDag.from_graph(g, "cuda")
    C, Q = 8, 2
    big = [torch.ones((g.n, C), device="cuda"),
           torch.ones((g.n, C), device="cuda"),
           torch.ones((Q, C), device="cuda"), torch.ones(Q, device="cuda")]
    # past 227 KB the kernel takes it in its global layout
    with pytest.raises(ValueError, match="takes the global layout"):
        HF.launch_choice(d, torch.zeros((g.n, C), device="cuda"), *big,
                         iters=1, use_comm=True, layout="shared")
    x, v = HF.launch_choice(d, torch.zeros((g.n, C), device="cuda"), *big,
                            iters=1, use_comm=True)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(v))
    with pytest.raises(ValueError, match="card"):
        HF.launch_hybrid(TH.PaddedDag.from_graph(g, "cpu"), torch.zeros(g.n),
                         m=64, k=8, iters=1)
    with pytest.raises(ValueError, match="z0"):
        HF.hybrid(d, torch.zeros(g.n), m=64, k=8, iters=1)
    out = HF.chain_probe(1000, 224)
    torch.cuda.synchronize()
    assert out.item() == 0.0
    # the split launch returns the same solve and each phase's cycles
    cycles = torch.zeros(len(HF.PHASES), dtype=torch.int64,
                         device="cuda")
    z0 = torch.zeros(g.n, device="cuda")
    x1, v1 = HF.launch_hybrid(d, z0, m=64, k=8, iters=3, cycles=cycles)
    x2, v2 = HF.launch_hybrid(d, z0, m=64, k=8, iters=3)
    assert float(v1) == float(v2) and torch.equal(x1, x2)
    assert bool((cycles > 0).all())
