"""The (max, +) CUDA kernel against its plain version, on the card.

The kernel has no CPU mode, so every test here carries the ``card`` marker
and asks for the ``card`` fixture, which skips it without a card.  This file imports nothing of JAX, so it
also runs on a host that has the card but not the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_maxplus_card.py

Each pair costs one float32 add, rounded once, and the max is exact, so the
kernel must equal the plain version bit for bit (``torch.equal``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.workloads import chameleon, fork_join  # noqa: E402
from repro_torch.kernels.maxplus import maxplus as mp  # noqa: E402
from repro_torch.kernels.maxplus import ops  # noqa: E402
from repro_torch.kernels.maxplus.ref import maxplus_matmul_ref  # noqa: E402


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shape_a, shape_b):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_a).astype(np.float32),
            rng.normal(size=shape_b).astype(np.float32))


def _graph_inputs(g, pad_to=128):
    adj = ops.dense_adjacency(g.n, g.edges, pad_to=pad_to)
    times = np.zeros((g.num_types, adj.shape[0]), np.float32)
    times[:, :g.n] = g.proc.T
    return torch.from_numpy(adj), torch.from_numpy(times)


@pytest.mark.card
def test_kernel_equals_plain_on_the_card(card):
    """On the card: the kernel against its plain version, exactly, at the
    sweep's shapes, a ragged one and a batch; the ranks of one graph."""
    mp.reset_launch_count()
    cases = [((128, 128), (128, 128)), ((256, 128), (128, 384)),
             ((100, 37), (37, 200)), ((3, 130, 129), (3, 129, 131))]
    for i, (sa, sb) in enumerate(cases):
        a, b = (torch.from_numpy(x).to(card) for x in _inputs(i, sa, sb))
        assert torch.equal(mp.maxplus_matmul(a, b), maxplus_matmul_ref(a, b))
    assert mp.launch_count() == len(cases)
    adj, times = _graph_inputs(chameleon("potrf", 5, 320))
    ranks = ops.batched_ranks(adj.to(card).expand(2, -1, -1), times.to(card))
    want = ops.batched_ranks(adj.expand(2, -1, -1), times)
    assert torch.equal(ranks.cpu(), want)
    assert mp.launch_count() == len(cases) + ops.squarings(adj.shape[0])


@pytest.mark.card
def test_kernel_equals_plain_on_closure_inputs(card):
    """The closure's own squarings, mostly NEG_INF: sums reach -2e30 and
    the NEG_INF floor decides most outputs.  Every squaring of a Chameleon
    graph's 2 lanes and of a fork-join graph against the plain version."""
    for g in (chameleon("potrs", 10, 320), fork_join(300, 5)):
        adj, times = _graph_inputs(g)
        c = ops.closure_input(adj.expand(2, -1, -1).transpose(-1, -2), times)
        c = c.to(card)
        assert bool((c == mp.NEG_INF).any())
        for step in range(ops.squarings(adj.shape[0])):
            got = mp.maxplus_matmul(c, c)
            assert torch.equal(got, maxplus_matmul_ref(c, c)), step
            c = got
