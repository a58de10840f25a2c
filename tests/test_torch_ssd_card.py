"""``ssd_sm90.cu`` (the chunked SSD scan, its backward and the decode step)
against its plain versions, on the card.

At the smoke configs' shapes (mamba2-130m and jamba-v0.1-52b: 8 heads of
16, state 16, chunk 8), at a chunk of 13, one that divides no tile (lc 80,
state 72, two output tiles) and one at the tensor-core products' edges
(hd 12, ns 20, lc 24: none a multiple of 16), and one of 20 chunks (the
state kernel takes the cumsums 8 chunks at a time): ``scan`` and ``scan_grad``
within 1e-5 (forward) and 1e-4 (backward) of each tensor's largest
magnitude in fp32 and 2e-2 in bf16 (``chip_smoke.FLASH_TOL``), twice bit
for bit;
``step``'s state and conv window bit for bit, its readout at the same
tolerance.  Then the hybrid smoke config's fp32 gradients, the kernel path
against the plain path (``layers.ssd_ops`` and ``layers.moe_ops`` bound to
the plain versions), with the launches counted; and its serving through
``scan`` and ``step``.  This file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_ssd_card.py
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd import ref, ssd  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from test_torch_ssm_card import _plain_moe_ops  # noqa: E402

FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (b, s, nh, hd, ns, lc): the smoke configs' SSM shape, a chunk of 13, a
#: padded-width case with two tiles a chunk, hd, ns and lc that are no
#: multiple of 16 (the tensor-core products' k steps and fragments), and
#: one whose bf16 operands TMA's boxes fit (hd and lc multiples of 32, ns of
#: 8: the products take them by TMA, hd and ns narrower than a tile), and
#: the same at 20 chunks (the state kernel's cumsum windows of 8 chunks, the
#: last one part full)
SHAPES = [(2, 16, 8, 16, 16, 8), (2, 26, 4, 16, 16, 13),
          (1, 160, 2, 16, 72, 80), (1, 48, 3, 12, 20, 24),
          (2, 128, 3, 32, 16, 64), (1, 640, 2, 32, 16, 32)]


@pytest.fixture
def card():
    """The card, for tests that launch the kernel; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed):
    b, s, nh, hd, ns, _ = shape
    g = np.random.default_rng(seed)
    dt = torch.tensor(np.log1p(np.exp(g.normal(size=(b, s, nh)) - 1)),
                      dtype=torch.float32, device=dev)
    xh = torch.tensor(g.normal(size=(b, s, nh, hd)), device=dev).to(dtype)
    B = torch.tensor(g.normal(size=(b, s, ns)), device=dev).to(dtype)
    C = torch.tensor(g.normal(size=(b, s, ns)), device=dev).to(dtype)
    A = -torch.tensor(np.exp(0.5 * g.normal(size=(nh,))), dtype=torch.float32,
                      device=dev)
    return dt, xh, B, C, A


def _close(got, want, tol, what):
    err = ((got.float() - want.float()).abs().max()
           / want.float().abs().max().clamp_min(1e-30)).item()
    assert err <= tol, f"{what}: {err} of the largest magnitude (limit {tol})"


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_and_scan_grad_against_the_plain_versions(card, dtype):
    for n, shape in enumerate(SHAPES):
        lc = shape[-1]
        dt, xh, B, C, A = _inputs(shape, dtype, card, n)
        ssd.reset_launch_count()
        got = ssd._forward_scan(dt, xh, B, C, A, lc)
        again = ssd._forward_scan(dt, xh, B, C, A, lc)
        want = ref.scan_ref(dt, xh, B, C, A, lc)
        for name, g, a, w in zip(("y", "final", "states"), got, again, want):
            _close(g, w, FWD_TOL[dtype], f"{shape} {name}")
            assert torch.equal(_bits(g), _bits(a)), name
        gen = np.random.default_rng(9)
        dy = torch.tensor(gen.normal(size=xh.shape), device=card).to(dtype)
        dfin = torch.tensor(gen.normal(size=got[1].shape), device=card)
        for dfinal in (dfin.to(dtype), None):
            states = want[2]
            grads = ssd.scan_grad(dt, xh, B, C, A, lc, states, dy, dfinal)
            twice = ssd.scan_grad(dt, xh, B, C, A, lc, states, dy, dfinal)
            plain = ref.scan_grad_ref(dt, xh, B, C, A, lc, states, dy, dfinal)
            for name, g, a, w in zip(("dxh", "ddt", "dB", "dC", "dA"), grads,
                                     twice, plain):
                _close(g, w, BWD_TOL[dtype], f"{shape} {name}")
                assert torch.equal(_bits(g), _bits(a)), name
        assert ssd.launch_counts() == {"scan": 2, "scan_grad": 4, "step": 0}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_is_its_plain_version_bit_for_bit(card, dtype):
    # the last: a conv window under one 16-byte vector and ns 5, no whole
    # vector: the scalar path
    for b, nh, hd, ns, width in ((2, 8, 16, 16, 160), (4, 24, 64, 128, 1792),
                                 (1, 2, 3, 5, 1)):
        g = np.random.default_rng(hd)
        cw = 4

        def t(*shape):
            return torch.tensor(g.normal(size=shape), device=card).to(dtype)

        state, conv, window = t(b, nh, hd, ns), t(b, cw - 1, width), \
            t(b, cw, width)
        xh, Bv, Cv = t(b, nh, hd), t(b, ns), t(b, ns)
        dtv = torch.tensor(np.abs(g.normal(size=(b, nh))), dtype=torch.float32,
                           device=card)
        A = -torch.tensor(np.exp(g.normal(size=(nh,))), dtype=torch.float32,
                          device=card)
        s1, c1, s2, c2 = state.clone(), conv.clone(), state.clone(), conv.clone()
        ssd.reset_launch_count()
        y = ssd.step(s1, c1, window, xh, dtv, A, Bv, Cv)
        want = ref.step_ref(s2, c2, window, xh, dtv, A, Bv, Cv)
        assert ssd.launch_counts()["step"] == 1
        assert torch.equal(_bits(s1), _bits(s2))
        assert torch.equal(_bits(c1), _bits(c2))
        _close(y, want, FWD_TOL[dtype], "step y")


@pytest.mark.card
def test_launch_floor_is_no_launch(card):
    """Each entry's launch floor runs and counts as no launch; step's at
    both decode shapes, its conv window's rows and width as ``s`` and
    ``lc`` (its grid: blocks of rows of each head, then the shift's)."""
    ssd.reset_launch_count()
    for entry in ssd.ENTRIES:
        ssd.launch_floor(entry, 2, 16, 8, 16, 16, 8, torch.bfloat16, card)
    for b, nh, hd, ns, width in ((4, 24, 64, 128, 1792),
                                 (4, 128, 64, 16, 8224)):
        for dtype in (torch.bfloat16, torch.float32):
            ssd.launch_floor("step", b, 3, nh, hd, ns, width, dtype, card)
    torch.cuda.synchronize()
    assert ssd.launch_count() == 0


def _plain_ops():
    """The MoE's and the SSD's plain versions, as ``layers.moe_ops`` and
    ``layers.ssd_ops`` take them."""
    return (_plain_moe_ops(),
            types.SimpleNamespace(scan=ref.scan, step=ref.step_ref))


def _ssm_layers(cfg):
    return sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))


@pytest.mark.card
def test_hybrid_gradients_kernel_path_against_the_plain_path(card):
    """jamba-v0.1-52b's smoke config, fp32 (no top-k choice flips between
    the two paths), remat full: the loss and every gradient through
    ``ssd_sm90.cu`` and ``moe_sm90.cu`` within 1e-4 of each leaf's largest
    magnitude of those through the plain versions; scan launches 2 a SSM
    layer (the forward and remat's recompute), scan_grad 1."""
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              dtype="float32", remat="full")
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    g = torch.Generator(device=card).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g, device=card)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1),
             "loss_mask": torch.ones(toks.shape, device=card)}
    ssd.reset_launch_count()
    loss_k, _, grads_k = TS.loss_and_grads(cfg, params, batch)
    n = _ssm_layers(cfg)
    assert ssd.launch_counts() == {"scan": 2 * n, "scan_grad": n, "step": 0}
    kernel = TL.moe_ops, TL.ssd_ops
    TL.moe_ops, TL.ssd_ops = _plain_ops()
    try:
        loss_p, _, grads_p = TS.loss_and_grads(cfg, params, batch)
    finally:
        TL.moe_ops, TL.ssd_ops = kernel
    _close(loss_k, loss_p, BWD_TOL[torch.float32], "loss")
    for i, (a, b) in enumerate(zip(leaves(grads_k), leaves(grads_p))):
        assert torch.isfinite(a).all(), i
        _close(a, b, BWD_TOL[torch.float32], f"gradient leaf {i}")


@pytest.mark.card
def test_hybrid_serves_through_scan_and_step(card):
    """jamba-v0.1-52b's smoke config served in fp32 with the kernels on: a
    prefill of 2 x 24 tokens and three decode steps, scan launched once a
    SSM layer and step once a SSM layer a step; the logits and the SSM
    caches within 1e-4 of the plain path's."""
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              dtype="float32", use_kernels=True)
    params = TM.init_serving_params(cfg, torch.Generator(device=card)
                                    .manual_seed(0))
    gen = torch.Generator(device=card).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=card,
                         generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (2, 3), device=card, generator=gen)

    def serve():
        cache = TM.init_cache(cfg, 2, 28, card)
        logits, cache = TM.prefill(cfg, params, toks, cache)
        out = [logits]
        for k in range(3):
            logits, cache = TM.decode_step(cfg, params, cache, nxt[:, k:k + 1])
            out.append(logits)
        return out, cache

    ssd.reset_launch_count()
    got, cache_k = serve()
    n = _ssm_layers(cfg)
    assert ssd.launch_counts() == {"scan": n, "scan_grad": 0, "step": 3 * n}
    kernel = TL.moe_ops, TL.ssd_ops
    TL.moe_ops, TL.ssd_ops = _plain_ops()
    try:
        want, cache_p = serve()
    finally:
        TL.moe_ops, TL.ssd_ops = kernel
    for a, b in zip(got, want):
        _close(a, b, 1e-4, "logits")
    for sub, leaves_ in cache_k["layers"].items():
        for key, t in leaves_.items():
            _close(t, cache_p["layers"][sub][key], 1e-4, f"{sub} {key}")
