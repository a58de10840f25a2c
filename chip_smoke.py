#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. card    — the card's name and power limit, from ``nvidia-smi``;
2. build   — every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
             ``sm_90a``, all sources at once, from the checkout alone;
3. kernels — each kernel against its plain PyTorch version on the card at
             the serving shape, the JAX kernel tests' sweep and a ragged
             length; times of the kernel, the plain version and one PyTorch
             library call at the serving shape (CUDA events, after warm-up);
4. serve   — ``repro_torch.launch.serve.main`` on qwen2-1.5b at its full
             published width and depth (random weights from a seed): every
             launch counter set to 0 just before, read just after, and each
             kernel of the path launched the expected number of times; then
             prefill/decode consistency at full width with the kernels on.

The line before the last is the card's name and power limit, the one before
it a JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits with code 1 and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# The published peaks of one H100 SXM (NVIDIA's data sheet), for bounds.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12

# The serving run: qwen2-1.5b at full width, 2 batches of 4 prompts of 512.
SERVE_ARGS = ["--arch", "qwen2-1.5b", "--requests", "8", "--batch", "4",
              "--prompt", "512", "--gen", "32"]
SERVE_BATCHES = 2

# Flash attention cases: (B, S, H, Hkv, D).  The serving shape first, then
# tests/test_kernels.py's sweep (B=2), then a length that divides no tile.
FLASH_SLICE = (4, 512, 12, 2, 128)
FLASH_SWEEP = [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64), (2, 256, 8, 1, 128),
               (2, 384, 6, 2, 64), (2, 200, 4, 2, 64)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX kernel tests'

# Prefill/decode consistency at full width: decode of token S-1 after a
# prefill of S-1 against the last logits of a prefill of S.  float32 holds
# the algorithm (only summation order differs) at the atol of the JAX
# package's smoke test (tests/test_arch_smoke.py); bfloat16 is the serving
# dtype, where every matmul output is rounded to 8 bits of mantissa on two
# different paths (the kernel's fp32 P.V against decode's bf16 weights)
# through 28 residual layers, on logits of standard deviation about 0.8.
CONSIST_TOL = {"float32": 2e-3, "bfloat16": 0.25}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_all(build) -> float:
    """Build every CUDA source at once (one nvcc each); returns seconds."""
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    check(bool(sources), f"no CUDA sources under {build.CSRC}")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for path in pool.map(lambda n: build.build(n, verbose=True), sources):
            print(f"built {path.relative_to(ROOT)}")
    return time.perf_counter() - t0


def flash_inputs(torch, case, dtype, seed):
    b, s, h, hkv, d = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


def flash_phase(torch) -> dict:
    """Every flash case against the plain version; times at the slice shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    slice_err = 0.0
    for i, case in enumerate([FLASH_SLICE] + FLASH_SWEEP):
        for dtype_name, tol in FLASH_TOL.items():
            dtype = getattr(torch, dtype_name)
            q, k, v = flash_inputs(torch, case, dtype, seed=i)
            for causal in (True, False):
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ops.flash_attention_ref(q, k, v, causal=causal)
                diff = (got.float() - want.float()).abs()
                err = diff.max().item()
                ok = bool((diff <= tol + tol * want.float().abs()).all())
                print(f"flash B,S,H,Hkv,D={case} {dtype_name} causal={causal}: "
                      f"max|err| {err:.3e} (atol = rtol = {tol})")
                check(ok, f"flash attention disagrees at {case} {dtype_name} "
                      f"causal={causal}: max|err| {err}")
                if case == FLASH_SLICE and dtype_name == "bfloat16" and causal:
                    slice_err = err
    # the (BH, S, D) wrapper once, against attention_ref
    q, k, v = flash_inputs(torch, (1, 256, 8, 8, 64), torch.float32, seed=99)
    fold = [x[0].transpose(0, 1).contiguous() for x in (q, k, v)]
    got, want = fa.flash_attention_bhsd(*fold), fa.attention_ref(*fold)
    check(bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()),
          "flash_attention_bhsd disagrees with attention_ref")

    b, s, h, hkv, d = FLASH_SLICE
    q, k, v = flash_inputs(torch, FLASH_SLICE, torch.bfloat16, seed=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ops.flash_attention_ref(q, k, v, causal=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elem = q.element_size()
    moved = elem * (2 * b * s * h * d + 2 * b * s * hkv * d)
    flops = 4 * b * h * d * (s * (s + 1) // 2)      # QK^T and P.V, causal
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    print(f"flash at B,S,H,Hkv,D={FLASH_SLICE} bf16 causal: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops) * 1e3:.2f} us ({moved / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); kernel at fp32 FMA peak "
          f"{flops / FP32_FLOP_PER_S * 1e6:.1f} us")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:62",
            "max_abs_err": slice_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def consistency(torch, dtype: str) -> float:
    """max |decode(S-1 | prefill S-1) - prefill(S)| at full width."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), dtype=dtype,
                              use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = M.serving_params(cfg, M.init_params(cfg, gen))
    b, s = 2, 512
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    logits_p, _ = M.prefill(cfg, params, toks, M.init_cache(cfg, b, s, "cuda"))
    cache = M.init_cache(cfg, b, s, "cuda")
    _, cache = M.prefill(cfg, params, toks[:, :s - 1], cache)
    logits_d, _ = M.decode_step(cfg, params, cache, toks[:, s - 1:])
    v = cfg.vocab_size
    check(bool(torch.isfinite(logits_p[:, :v]).all()), "non-finite prefill logits")
    check(float(logits_d[:, v:].max()) < -1e20, "padded vocab rows not masked")
    err = (logits_d[:, :v] - logits_p[:, :v]).abs().max().item()
    same = (logits_d[:, :v].argmax(-1) == logits_p[:, :v].argmax(-1)).all().item()
    print(f"prefill/decode consistency {dtype}: max|diff| {err:.3e} "
          f"(limit {CONSIST_TOL[dtype]}), logits std "
          f"{logits_p[:, :v].std().item():.3f}, same argmax {same}")
    check(err <= CONSIST_TOL[dtype], f"prefill/decode disagree in {dtype}: {err}")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import serve

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"build: {build_all(build):.1f} s")

    t0 = time.perf_counter()
    flash = flash_phase(torch)
    print(f"kernels: {time.perf_counter() - t0:.1f} s")

    # the main path: counters at 0 just before, read just after
    fa.reset_launch_count()
    summary = serve.main(SERVE_ARGS)
    launches = fa.launch_count()
    torch.cuda.synchronize()
    layers = 28
    check(launches == layers * SERVE_BATCHES,
          f"flash attention launched {launches} times, expected "
          f"{layers * SERVE_BATCHES}")
    check(summary["flash_launches"] == launches, "serve summary count differs")
    check(summary["logits_finite"], "non-finite logits while serving")
    check(summary["tokens"] == 8 * 32, f"served {summary['tokens']} tokens")
    print(f"serve qwen2-1.5b full width on {card}: {summary['tok_per_s']:.1f} "
          f"tok/s, prefill {summary['prefill_s']:.3f} s, decode "
          f"{summary['decode_s']:.3f} s, wall {summary['wall_s']:.3f} s, "
          f"makespan {summary['makespan']:.3f} s, flash launches {launches}")
    flash["launches"] = launches

    for dtype in ("float32", "bfloat16"):
        consistency(torch, dtype)
        torch.cuda.empty_cache()

    print(f"serve summary: {json.dumps(summary)}")
    print(json.dumps({"kernels": [flash]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
