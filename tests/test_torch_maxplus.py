"""The port's (max, +) product, closure and ranks against the JAX package.

Here on the CPU the port's wrappers take their plain versions (the CUDA
kernel runs only on the card, where ``chip_smoke.py`` and
``tests/test_torch_maxplus_card.py`` hold it against the same plain
version); the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` does.  Inputs
come from numpy with a seed.

Each pair costs one float32 add, rounded once, and the max is exact and
independent of order, so the port must equal the JAX functions bit for bit
(``assert_array_equal``).  Against the float64 ``TaskGraph`` the tolerance
is rtol 1e-5, that of ``tests/test_kernels.py``: the closure rounds each
path sum in float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.maxplus import ops as jax_ops  # noqa: E402
from repro.kernels.maxplus.maxplus import maxplus_matmul as jax_maxplus  # noqa: E402
from repro_torch.core.workloads import chameleon  # noqa: E402
from repro_torch.kernels.maxplus import maxplus as mp  # noqa: E402
from repro_torch.kernels.maxplus import ops  # noqa: E402
from repro_torch.kernels.maxplus.ref import (CHUNK_ELEMENTS,  # noqa: E402
                                             longest_path_ref,
                                             maxplus_matmul_ref)

GRAPHS = [("potrf", 5, 320), ("potrs", 10, 320)]


def _inputs(seed, shape_a, shape_b, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_a).astype(dtype),
            rng.normal(size=shape_b).astype(dtype))


def _graph_inputs(app, nb, bs, pad_to=128):
    g = chameleon(app, nb, bs)
    adj = ops.dense_adjacency(g.n, g.edges, pad_to=pad_to)
    times = np.zeros((g.num_types, adj.shape[0]), np.float32)
    times[:, :g.n] = g.proc.T
    return g, adj, times


# Each test below loops over its cases rather than being parametrized per
# case: a file of many short items changes the order in which pytest-xdist
# hands whole files to its workers, and some of the JAX package's tests
# count XLA compiles in a process whose other files share its jit cache.


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_maxplus_equals_jax(dtype):
    """``tests/test_kernels.py``'s sweep of (m, k, n)."""
    for m, k, n in [(128, 128, 128), (256, 128, 384), (128, 256, 128),
                    (512, 512, 256)]:
        a, b = _inputs(m + k + n, (m, k), (k, n), dtype)
        want = np.asarray(jax_maxplus(jnp.asarray(a), jnp.asarray(b)))
        got = mp.maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{m, k, n}")


def test_maxplus_equals_jax_block_shapes():
    """The Pallas kernel's tiles change no bit of its result, and the
    port (which has no tile arguments) equals it at each."""
    a, b = _inputs(0, (256, 128), (128, 256))
    got = mp.maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    for bm, bn, bk in [(64, 64, 64), (128, 128, 64)]:
        want = np.asarray(jax_maxplus(jnp.asarray(a), jnp.asarray(b),
                                      bm=bm, bn=bn, bk=bk))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{bm, bn, bk}")


def test_batched_maxplus_is_the_product_of_each_lane():
    a, b = _inputs(3, (3, 64, 96), (3, 96, 80))
    got = mp.maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    for z in range(3):
        want = np.asarray(jax_maxplus(jnp.asarray(a[z]), jnp.asarray(b[z]),
                                      bm=64, bn=80, bk=96))
        np.testing.assert_array_equal(got[z].numpy(), want)


def test_chunked_reference_changes_no_bit(monkeypatch):
    """The plain version's chunking over k (it never holds the whole
    (m, k, n) broadcast) gives the unchunked result exactly."""
    a, b = _inputs(4, (2, 40, 300), (2, 300, 50))
    whole = maxplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    monkeypatch.setattr("repro_torch.kernels.maxplus.ref.CHUNK_ELEMENTS",
                        2 * 40 * 50 * 7)
    chunked = maxplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert CHUNK_ELEMENTS > 2 * 40 * 300 * 50
    assert torch.equal(whole, chunked)


def test_dense_adjacency_equals_jax():
    for (app, nb, bs) in GRAPHS:
        g = chameleon(app, nb, bs)
        for pad_to in (64, 128):
            got = ops.dense_adjacency(g.n, g.edges, pad_to=pad_to)
            want = jax_ops.dense_adjacency(g.n, g.edges, pad_to=pad_to)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{app} {pad_to}")


@pytest.mark.parametrize("app,nb,bs", GRAPHS)
def test_closure_and_ranks_equal_jax(app, nb, bs):
    _, adj, times = _graph_inputs(app, nb, bs)
    want = np.asarray(jax_ops.longest_path_closure(jnp.asarray(adj),
                                                   jnp.asarray(times[0])))
    got = ops.longest_path_closure(torch.from_numpy(adj),
                                   torch.from_numpy(times[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    adjs = np.stack([adj] * len(times))
    want = np.asarray(jax_ops.batched_ranks(jnp.asarray(adjs),
                                            jnp.asarray(times)))
    got = ops.batched_ranks(torch.from_numpy(adj).expand(len(times), -1, -1),
                            torch.from_numpy(times))
    np.testing.assert_array_equal(got.numpy(), want)


def test_closure_and_ranks_match_taskgraph():
    for (app, nb, bs) in GRAPHS:
        g, adj, times = _graph_inputs(app, nb, bs, pad_to=64)
        fin = ops.longest_path_closure(torch.from_numpy(adj),
                                       torch.from_numpy(times[0]))
        assert float(fin[:g.n].max()) == pytest.approx(
            g.critical_path(g.proc[:, 0]), rel=1e-5), app
        ranks = ops.batched_ranks(torch.from_numpy(adj).expand(2, -1, -1),
                                  torch.from_numpy(times))
        for q in range(2):
            np.testing.assert_allclose(ranks[q, :g.n].numpy(),
                                       g.upward_rank(g.proc[:, q]), rtol=1e-5,
                                       err_msg=f"{app} type {q}")


def test_closure_matches_relaxation_reference():
    """The closure and the plain n-round relaxation agree."""
    g, adj, times = _graph_inputs("potrf", 5, 64)
    fin = ops.longest_path_closure(torch.from_numpy(adj),
                                   torch.from_numpy(times[1]))
    ref = longest_path_ref(torch.from_numpy(adj), torch.from_numpy(times[1]))
    np.testing.assert_allclose(fin[:g.n].numpy(), ref[:g.n].numpy(), rtol=1e-6)


def test_squarings_is_ceil_log2():
    for p in (1, 2, 3, 128, 129, 2944, 5120):
        assert ops.squarings(p) == int(np.ceil(np.log2(max(p, 2)))), p


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    mp.reset_launch_count()
    _, adj, times = _graph_inputs("potrs", 5, 320)
    ops.batched_ranks(torch.from_numpy(adj).expand(2, -1, -1),
                      torch.from_numpy(times))
    ops.longest_path_closure(torch.from_numpy(adj), torch.from_numpy(times[0]))
    a, b = _inputs(1, (64, 64), (64, 64))
    mp.maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert mp.launch_count() == 0


def test_kernel_launch_refuses_what_it_does_not_take():
    a = torch.zeros(1, 128, 128)
    with pytest.raises(ValueError, match="card"):
        mp.launch(a, a)
    with pytest.raises(ValueError, match="launch takes"):
        mp.launch(a[0], a[0])
    assert mp.launch_count() == 0


def test_wrappers_reject_bad_inputs():
    for shape_a, shape_b, dtype, err in [
            ((4, 5), (6, 7), torch.float32, ValueError),        # k does not chain
            ((2, 4, 5), (3, 5, 7), torch.float32, ValueError),  # lanes differ
            ((4, 5), (2, 5, 7), torch.float32, ValueError),     # ranks differ
            ((4,), (4,), torch.float32, ValueError),            # not a matrix
            ((4, 5), (5, 7), torch.float64, TypeError),
            ((4, 5), (5, 7), torch.int32, TypeError)]:
        with pytest.raises(err):
            mp.maxplus_matmul(torch.zeros(shape_a, dtype=dtype),
                              torch.zeros(shape_b, dtype=dtype))
    with pytest.raises(ValueError, match="does not match"):
        ops.longest_path_closure(torch.zeros(128, 128), torch.zeros(127))
    with pytest.raises(ValueError, match="B, p, p"):
        ops.batched_ranks(torch.zeros(128, 128), torch.zeros(128))

