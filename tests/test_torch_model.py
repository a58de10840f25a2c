"""The port's dense model against the JAX package's, on carried-over weights.

float32 smoke configs of the dense family's four: qwen2-1.5b (QKV bias,
head_dim 8), granite-3-2b (GQA 8:2), olmo-1b (the non-parametric LayerNorm,
whose parameter groups are empty dicts, tied embeddings) and granite-34b
(LayerNorm with bias, MQA 8:1).  The JAX parameters of ``init_params(PRNGKey(0))`` go to the port
through ``params_from_jax``; both sides then take the same token ids.
Tolerance: atol = rtol = 1e-4, because the two frameworks sum the same
float32 products in another order (einsum contraction, softmax and norm
reductions), which moves the last bits through two layers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = ["qwen2-1.5b", "granite-3-2b", "olmo-1b", "granite-34b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(cfg, **kw):
    return dataclasses.replace(cfg, dtype="float32", remat="none", **kw)


def _pair(arch):
    """(jax cfg, port cfg, jax params, port params) at float32."""
    jcfg = _f32(jax_smoke(arch))
    tcfg = _f32(get_smoke_config(arch))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    B, S, MAX = 2, 16, 24
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    jl, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                        JM.init_cache(jcfg, B, MAX))
    tl, tc = TM.prefill(tcfg, tparams, torch.as_tensor(toks),
                        TM.init_cache(tcfg, B, MAX, "cpu"))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   _np(jc["layers"][key]), **TOL)
    np.testing.assert_array_equal(_np(tc["pos"]), _np(jc["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_decode_steps_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    B, S, MAX = 2, 12, 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    _, jc = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                       JM.init_cache(jcfg, B, MAX))
    _, tc = TM.prefill(tcfg, tparams, torch.as_tensor(toks),
                       TM.init_cache(tcfg, B, MAX, "cpu"))
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
        jl, jc = JM.decode_step(jcfg, jparams, jc, jnp.asarray(nxt, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tparams, tc, torch.as_tensor(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   _np(jc["layers"][key]), **TOL)
    if tcfg.padded_vocab > tcfg.vocab_size:
        assert float(tl[:, tcfg.vocab_size:].max()) < -1e20


def test_kernel_attention_path_matches_jax_pallas_path():
    """``use_kernels=True`` attention (the plain kernel version here, on the
    CPU) against JAX ``use_pallas=True`` (Pallas in interpret mode) at
    S=128, the gate's threshold — the counterpart of
    ``tests/test_kernels.py::test_flash_matches_model_attention_path``."""
    jcfg = _f32(jax_smoke("granite-3-2b"), use_pallas=True)
    tcfg = _f32(get_smoke_config("granite-3-2b"), use_kernels=True)
    jp = JL.attn_init(jcfg, jax.random.PRNGKey(0))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = 0.1 * np.random.default_rng(3).normal(
        size=(2, 128, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(128), (2, 1))
    y_jax = JL.attn_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    fa.reset_launch_count()
    y_port = TL.attn_apply(tcfg, tp, torch.as_tensor(x), torch.as_tensor(pos))
    assert fa.launch_count() == 0          # CPU tensors take the plain version
    np.testing.assert_allclose(_np(y_port), _np(y_jax), **TOL)


def test_serving_params_cast_matrices_and_keep_norms():
    cfg = get_smoke_config("qwen2-1.5b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))
    served = TM.serving_params(cfg, params)
    assert served["embed"].dtype == torch.bfloat16
    assert served["blocks"]["attn"]["bq"].dtype == torch.bfloat16
    assert served["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert served["final_norm"]["scale"].dtype == torch.float32
    # casting once equals the per-use cast of the JAX package bit for bit
    assert torch.equal(served["blocks"]["mlp"]["w_up"],
                       params["blocks"]["mlp"]["w_up"].to(torch.bfloat16))


def test_params_from_jax_rejects_wrong_shapes():
    jcfg, tcfg, jparams, _ = _pair("qwen2-1.5b")
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tcfg, tree)
    del tree["blocks"]["attn"]["wq"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tcfg, tree)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "np_layernorm"])
def test_norm_apply_matches_jax(norm):
    jcfg = dataclasses.replace(jax_smoke("qwen2-1.5b"), norm=norm)
    tcfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"), norm=norm)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    p = {"scale": rng.normal(size=jcfg.d_model).astype(np.float32),
         "bias": rng.normal(size=jcfg.d_model).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    if norm == "np_layernorm":
        p = {}
    want = JL.norm_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = TL.norm_apply(tcfg, {k: torch.tensor(v) for k, v in p.items()},
                        torch.tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax_across_chunks(causal):
    """Three query chunks of 8 over a 24-long sequence, GQA 6:2."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(2, 24, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    want = JL._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_chunk=8)
    got = TL._sdpa_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal=causal, q_chunk=8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert TL.best_chunk(24, 10) == JL.best_chunk(24, 10) == 8
