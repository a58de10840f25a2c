#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code not 0):

1. card    — the card's name and power limit, from ``nvidia-smi``;
2. build   — every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
             ``sm_90a``, all sources at once, from the checkout alone;
3. kernels — flash attention against its plain PyTorch version on the
             card at the serving shape, the JAX kernel tests' sweep and a
             ragged length, bf16 through the bf16 tensor-core kernel and
             fp32 through the 3xTF32 tensor-core kernel (each call's kernel
             read from the per-kernel counters), and the FMA kernel on the
             same cases in both dtypes (``kernel="fma"``); times in both
             dtypes at the serving shape and at a long prompt (S = 8192):
             the kernel and ``scaled_dot_product_attention`` in turns,
             eagerly (CUDA events) and replayed from a CUDA graph (device
             time), beside the FMA kernel on the same inputs, the plain
             version (serving shape only), the bound and the achieved rate;
4. serve   — ``repro_torch.launch.serve.main`` on qwen2-1.5b at its full
             published width and depth (random weights from a seed): every
             launch counter set to 0 just before, read just after, and each
             kernel of the path launched the expected number of times (all
             56 flash launches by the bf16 kernel); then prefill/decode
             consistency at full width with the kernels on, in fp32 (the
             3xTF32 kernel's path, 56 launches) and bf16;
5. maxplus — the (max, +) kernel against its plain version on the card at
             the JAX kernel tests' sweep (fp32 and fp16 inputs) and at
             12 lanes of p = 512 and p = 2944, at exact equality; times of
             both at the two batched shapes beside the bound;
6. ranks   — the paper's §6.1 campaign grid at full size (5 Chameleon apps
             x nb (5, 10, 20) x 6 block sizes, fork-join of width 100-500
             and 2, 5 or 10 phases; up to 5011 tasks, padded to p = 5120):
             upward ranks of every (graph, type) lane through
             ``batched_ranks`` on the card, each held against
             ``TaskGraph.upward_rank`` (rtol 1e-5), one critical path per
             graph through ``longest_path_closure`` held against
             ``TaskGraph.critical_path``; the launch counter set to 0 just
             before and required to equal the sum of ``ceil(log2 p)`` over
             the calls just after.  The path's host time (graph generation,
             adjacency, copies, the calls up to their results on the host)
             and the float64 checks' time are read apart, and each call's
             device time from one CUDA event pair around it.  Then the
             kernel against its plain version, exactly, on the closure's own
             inputs (mostly NEG_INF, where the floor decides most outputs):
             the first two squarings of the largest call of each lane count.
7. replay  — the same grid's 105 graphs on a (32 CPUs, 4 GPUs) machine,
             planned by HLP-EST and HLP-OLS, replayed under 32 seeds of
             lognormal noise through ``repro_torch.sim.batch``'s
             ``sweep_suite_makespans`` on the card (HEFT left out for host
             time): the replay launch counter set to 0 just before, and just
             after required to equal the number of shape buckets; planning
             and the replay path timed apart on the host clock.  Then the
             same entries through the pipelined executor
             (``workers=os.cpu_count()``, ``cache=True``), with the process
             pool still to start and again with it running: its rows bit
             for bit the serial rows, the replay launches the buckets it
             dispatched (``last_pipeline_stats().buckets``), no broken
             process pool (``plan_pool.broken`` 0); planning at one worker
             and at N (with the longest single solve), the pipelined wall,
             ``overlap_frac`` and the drain's wait.  Then each bucket of the serial sweep through the kernel
             (``replay_sm90.cu``), held bit for bit against the plain
             version on CPU copies and against the sweep's rows and timed
             from a CUDA graph of 5 launches, twice, beside its byte bound,
             its longest chain and the chain floor: that chain times one
             dependent add + max step through shared memory, as the probe
             ``replay_sm90_chain_probe`` measures it first; the smallest and
             largest plan of each scheduler against the float64 engine at
             rtol 1e-5.
8. contention — ``benchmarks/campaign.py::sim_sweep(full=True)``'s network
             sub-grid (netbound seeds 300-305, 60 tasks, planned by hlp_ols
             and the contention-aware CAHLP) replayed under ``instant``,
             ``fixed_latency`` and ``maxmin_fair`` with 32 seeds through
             ``sweep_suite_makespans`` on the card, then the same generator
             at width 100 and depth 10 (1000 tasks) under ``maxmin_fair``:
             the contention and replay launch counters and
             ``trace_count("contended")`` set to 0 just before each sweep,
             and just after the contention kernel's launches and the trace
             count required to equal the number of (n_pad, P_pad, L) groups
             under ``maxmin_fair`` (0 under the other two), and the replay
             kernel's the number of buckets.  Then each group through the
             contention kernel (``contention_sm90.cu``) against its plain
             version bit for bit, the per-edge delays against
             ``contended_plan_delays`` (rtol 1e-6, atol 1e-9; every plan of
             the campaign grid, seed 300's two at the large scale), timed
             from CUDA graphs of 3 launches, twice, beside the plain
             version's and the oracle's host time; the kernel's split
             variant (the clock cycles of each phase of the slowest plan's
             chain) and chain floor: the per-plan counts of replay steps and
             of reductions (filling rounds + events - merged rounds), each
             times the link its probe (``contention_sm90_chain_probe``)
             measures at the group's block size.
9. lp      — the first-order LP (``repro_torch.core.hlp_jax``) on the
             solver target's instances (Chameleon potrf and getrf nb=10,
             potri nb=20, block 512, on (64, 8), 300 iterations) through
             ``solve_hlp_jax`` on the card: the ``hlp_fo`` counters set to
             0 just before and required, just after, to show one launch a
             solve, all of the default kernel (``hlp_fo_sm90.cu``) and
             none of the first design (``hlp_fo.cu``, ``kernel="gather"``).
             Then the first design's reverse pass split with clock64 on
             potri nb=20 (successor gather, chain rule, Adam's loads and
             stores; the slowest level and the chain of every level's
             slowest task), and each instance through both kernels' bare
             launches and the plain version on CPU copies from the same
             starting logits: the two kernels' best x and λ bit for bit,
             λ at rtol 1e-5 of the plain version and identical threshold
             allocations; one comm-aware netbound instance and one moldable
             instance through the choice entry the same way (λ at 1e-3 on
             the netbound one: see ``LP_NETBOUND_RTOL``); and one
             campaign-sized solve (the full grid's largest ``hlp_jax_ols``
             graph, 43 tasks, one warp).  Each kernel timed from CUDA
             events in turns (sm90, gather, gather, sm90) beside its chain
             floor (2 level steps a level a step for sm90, 3 for gather,
             each as ``hlp_fo_sm90_chain_probe`` measures it) and the
             split of its chain's clock cycles over the phases of a step;
             the bound, the plain version's host time and HiGHS's
             (``solve_hlp``) beside them.
10. campaign — ``python -m repro_torch.launch.campaign --bench-json X`` on
             the card in a fresh process (the ``sim`` and ``search``
             targets, their replay, contention and first-order LP launches
             counted from 0 by the process itself), then the JAX package's
             gate ``python -m benchmarks.render_tables --check-bench X
             benchmarks/BENCH_pinned.json``: both must exit 0, every pinned
             metric must lie within rtol 1e-6 of its pin and every count of
             ``CHECK_COUNTS`` equal it; the replay launches must equal the
             chunks the run dispatched (the ``sim`` buckets), the
             contention launches the groups it priced, the first-order LP's
             none.  Then ``--full --only sim`` (the reference's full grid,
             ``hlp_jax_ols`` among its static adapters) the same way against
             ``tests/torch_sim_full_pin.json``, the reference's own
             trajectory of that grid: the first-order LP's launches must
             equal the ``hlp_jax_ols`` solves (one a static-suite
             scenario), every one of the sm90 kernel.

The tests that launch a kernel run apart, on the same card:

    PYTHONPATH=src python -m pytest -q --noconftest -m card \
        tests/test_torch_flash_card.py tests/test_torch_maxplus_card.py \
        tests/test_torch_replay_card.py tests/test_torch_replay_sm90_card.py \
        tests/test_torch_contention_card.py \
        tests/test_torch_contention_sm90_card.py \
        tests/test_torch_pipeline_card.py tests/test_torch_hlp_fo_card.py \
        tests/test_torch_hlp_fo_sm90_card.py

The line before the last is the card's name and power limit, the one before
it a JSON object of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits with code 1 and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
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
TF32_FLOP_PER_S = 495e12
# fp32-accurate products on the tensor cores are 3 TF32 products each
# (hi hi' + hi lo' + lo hi'): the fp32 tensor-core kernel's bound
TF32_PRODUCTS = 3
# A (max, +) pair is two instructions on the CUDA cores, FADD and FMNMX.
# 132 SMs x 128 FP32 lanes x 1.98 GHz issue 33.5e12 FADD/s (the FMA rate
# counted once, not as two flops); FMNMX runs at 64 per clock per SM on
# compute capability 9.0 (the CUDA programming guide's throughput table,
# "compare, minimum, maximum"), and a scheduler issues one warp instruction
# per clock: each caps the product at 2 instructions / 33.5e12 per pair.
MAXPLUS_INSTR_PER_S = FP32_FLOP_PER_S / 2

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
# the kernel each dtype must go through (flash_attention.KERNELS)
FLASH_KERNEL = {"float32": "sm90_fp32", "bfloat16": "sm90_bf16"}
# a long prompt: qwen2-1.5b's heads at S = 8192, one sequence
FLASH_LONG = (1, 8192, 12, 2, 128)

# Prefill/decode consistency at full width: decode of token S-1 after a
# prefill of S-1 against the last logits of a prefill of S.  float32 holds
# the algorithm (only summation order differs) at the atol of the JAX
# package's smoke test (tests/test_arch_smoke.py); bfloat16 is the serving
# dtype, where every matmul output is rounded to 8 bits of mantissa on two
# different paths (the kernel's fp32 P.V against decode's bf16 weights)
# through 28 residual layers, on logits of standard deviation about 0.8.
CONSIST_TOL = {"float32": 2e-3, "bfloat16": 0.25}

# (m, k, n) of tests/test_kernels.py's sweep, each in fp32 and fp16; then
# the batched closure shapes: 12 lanes (6 block sizes x 2 types) at p = 512
# (potrs nb=20) and p = 2944 (getrf nb=20).
MAXPLUS_SWEEP = [(128, 128, 128), (256, 128, 384), (128, 256, 128),
                 (512, 512, 256)]
MAXPLUS_BATCHED = [(12, 512), (12, 2944)]

# The §6.1 full grid (benchmarks/campaign.py::instances, full=True).
NB_BLOCKS = (5, 10, 20)
BLOCK_SIZES = (64, 128, 320, 512, 768, 960)
FJ_WIDTHS = (100, 200, 300, 400, 500)
FJ_PHASES = (2, 5, 10)
RANK_RTOL = 1e-5                       # as tests/test_kernels.py

# The replay phase: the same grid on the (32 CPUs, 4 GPUs) platform of
# OFFLINE_CONFIGS_2, planned by HLP-EST and HLP-OLS, each plan replayed
# under benchmarks/campaign.py::sim_sweep(full=True)'s noise and 32 seeds.
REPLAY_MACHINE = (32, 4)
REPLAY_SCHEDULERS = ("hlp_est", "hlp_ols")
REPLAY_NOISE = ("lognormal", 0.2)
REPLAY_SEEDS = range(32)
REPLAY_RTOL = 1e-5     # against the float64 engine, as tests/test_sim_comm.py

# The contention phase: benchmarks/campaign.py::sim_sweep(full=True)'s
# network sub-grid (netbound_scenario seeds 300-305 at the generator's
# width 12 and depth 5, each planned by hlp_ols and by the contention-aware
# CAHLP, replayed under the three network models with the sweep's noise and
# 32 seeds), then the same generator at the §6.1 fork-join's scale (width
# 100, depth 10: 1000 tasks) under maxmin_fair.
NET_SEEDS = range(300, 306)
NET_MODELS = ("instant", "fixed_latency", "maxmin_fair")
NET_SCALE = (100, 10)
NET_ORACLE_SEEDS = (300,)   # the oracle at the large scale: 1-80+ s a plan
NET_RTOL, NET_ATOL = 1e-6, 1e-9   # against the numpy oracle, as the reference
# fp64 outside the tensor cores on one H100 SXM (NVIDIA's data sheet)
FP64_FLOP_PER_S = 34e12
CARD = "cuda"

# The campaign phase: the pins the JAX package's gate holds the port to,
# and the tolerance beyond the gate's 5% (the port replays bit for bit);
# the full grid (--full --only sim) against the reference's own trajectory.
PINNED = ROOT / "benchmarks" / "BENCH_pinned.json"
FULL_PIN = ROOT / "tests" / "torch_sim_full_pin.json"
CAMPAIGN_RTOL = 1e-6
# the counts render_tables.CHECK_COUNTS holds exactly
CAMPAIGN_COUNTS = ("plans", "evals", "runs", "scenarios", "compiles",
                   "contended_compiles", "buckets", "cells",
                   "plan_cache_hits", "plan_cache_misses")

# The lp phase: the first-order LP on benchmarks/run.py::bench_solver's
# instances at full=True (Chameleon potrf and getrf nb=10, potri nb=20, at
# block 512 on (64, 8), 300 iterations), then the choice entry on the
# campaign network sub-grid's first instance (netbound seed 300, the rigid
# comm-aware Q=2 grid) and on a moldable instance (moldable_suite seed 400
# at CCR 2, its comm-aware (type, width) grid).  λ of the kernel against
# the plain version at rtol 1e-5, allocations identical; on the netbound
# instance λ at 1e-3: there the reference and the plain version themselves
# differ by 2.9e-4 on the CPU (tests/test_torch_hlp_fo.py holds it under
# 1e-3 and names the first value that differs: softmax's exp, ROADMAP C6),
# and the trajectory moves with any change of rounding.  The two kernels
# are held to each other bit for bit everywhere.
LP_SOLVER = (("potrf", 10), ("getrf", 10), ("potri", 20))
LP_MACHINE = (64, 8)
LP_ITERS = 300
LP_RTOL = 1e-5
LP_NETBOUND_RTOL = 1e-3


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


def graph_ms(fn, iters: int = 50) -> float:
    """Device time of one of ``iters`` back-to-back calls of ``fn``,
    captured in a CUDA graph and replayed, so the host's launch cost is
    not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def flash_bound_ms(case, elem: int, flop_per_s: float,
                   products: int = 1) -> tuple[float, str]:
    """The least time of causal attention at ``case``, and its limit, with
    ``products`` tensor-core products for each product of the function."""
    b, s, h, hkv, d = case
    moved = elem * (2 * b * s * h * d + 2 * b * s * hkv * d)
    flops = 4 * b * h * d * (s * (s + 1) // 2)      # QK^T and P.V, causal
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = products * flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_times(torch, case, dtype, *, plain: bool) -> dict:
    """Times of the dtype's kernel, SDPA and the FMA kernel on the same
    inputs, causal.  The kernel and SDPA are timed in turns (kernel, SDPA,
    SDPA, kernel), each turn twice: eagerly (CUDA events over back-to-back
    calls from Python, the host's launch cost included) and as device time
    (the same calls replayed from a CUDA graph).  The FMA kernel's own
    bound (fp32 FMA peak) is beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    b, s, h, hkv, d = case
    q, k, v = flash_inputs(torch, case, dtype, seed=0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    long = s > 1024
    fp32 = dtype == torch.float32
    iters = (5 if fp32 else 20) if long else 50

    def kernel():
        return ops.flash_attention(q, k, v, causal=True)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    turns = {"kernel": [], "sdpa": [], "kernel_eager": [], "sdpa_eager": []}
    for name, fn in (("kernel", kernel), ("sdpa", sdpa), ("sdpa", sdpa),
                     ("kernel", kernel)):
        turns[name + "_eager"].append(time_ms(fn, iters))
        turns[name].append(graph_ms(fn, iters))
    out = {key: sum(val) / len(val) for key, val in turns.items()}
    out["turns"] = turns
    out["fma"] = time_ms(lambda: fa.launch_bshd(q, k, v, causal=True,
                                                kernel="fma"),
                         iters=3 if long else 20, warmup=1)
    out["plain"] = (time_ms(lambda: ops.flash_attention_ref(q, k, v,
                                                            causal=True))
                    if plain else None)
    # the fp32 kernel's pre-pass alone (its time is inside the kernel's)
    out["pre_pass"] = (graph_ms(lambda: fa.split_kv_tf32(k, v), iters)
                       if fp32 else None)
    if fp32:
        out["bound"], out["bound_by"] = flash_bound_ms(
            case, 4, TF32_FLOP_PER_S, TF32_PRODUCTS)
    else:
        out["bound"], out["bound_by"] = flash_bound_ms(case, 2, BF16_FLOP_PER_S)
    out["fma_bound"], out["fma_bound_by"] = flash_bound_ms(
        case, q.element_size(), FP32_FLOP_PER_S)
    flops = 4 * b * h * d * (s * (s + 1) // 2)
    out["tflops"] = flops / out["kernel"] / 1e9
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    fma = (f", FMA kernel {out['fma']:.4f} ms (bound "
           f"{out['fma_bound'] * 1e3:.2f} us, {out['fma_bound_by']}, "
           f"{out['fma_bound'] / out['fma']:.1%} of it)")
    plain_txt = f", plain {out['plain']:.4f} ms" if plain else ""
    if fp32:
        plain_txt += f", its pre-pass alone {out['pre_pass']:.4f} ms"
    print(f"flash times at B,S,H,Hkv,D={case} {name} causal: kernel "
          f"{out['kernel']:.4f} ms on the card (turns "
          f"{turns['kernel'][0]:.4f} / {turns['kernel'][1]:.4f}; eager "
          f"{out['kernel_eager']:.4f}), SDPA {out['sdpa']:.4f} ms (turns "
          f"{turns['sdpa'][0]:.4f} / {turns['sdpa'][1]:.4f}; eager "
          f"{out['sdpa_eager']:.4f}){fma}{plain_txt}; bound "
          f"{out['bound'] * 1e3:.2f} us ({out['bound_by']}"
          f"{', 3xTF32' if fp32 else ''}), kernel at "
          f"{out['bound'] / out['kernel']:.1%} of it, {out['tflops']:.1f} "
          f"TFLOP/s of the function; kernel "
          f"{'no slower' if out['kernel'] <= out['sdpa'] else 'SLOWER'}"
          f" than SDPA on the card")
    return out


def flash_phase(torch) -> tuple[dict, dict, dict]:
    """Every flash case against the plain version, each through the kernel
    of its dtype, then through the FMA kernel when asked; times at the
    serving and the long shape.  Returns the rows of the bf16 and the fp32
    tensor-core kernels and of the FMA kernel."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops

    errs, fma_err = {}, 0.0
    for i, case in enumerate([FLASH_SLICE] + FLASH_SWEEP):
        for dtype_name, tol in FLASH_TOL.items():
            dtype = getattr(torch, dtype_name)
            q, k, v = flash_inputs(torch, case, dtype, seed=i)
            for causal in (True, False):
                want = ops.flash_attention_ref(q, k, v, causal=causal)
                for kernel in (None, "fma"):
                    before = fa.launch_counts()
                    got = (ops.flash_attention(q, k, v, causal=causal)
                           if kernel is None else
                           fa.launch_bshd(q, k, v, causal=causal, kernel=kernel))
                    ran = [n for n, c in fa.launch_counts().items()
                           if c != before[n]]
                    diff = (got.float() - want.float()).abs()
                    err = diff.max().item()
                    ok = bool((diff <= tol + tol * want.float().abs()).all())
                    expected = kernel or FLASH_KERNEL[dtype_name]
                    print(f"flash B,S,H,Hkv,D={case} {dtype_name} "
                          f"causal={causal}: kernel {'+'.join(ran)}, max|err| "
                          f"{err:.3e} (atol = rtol = {tol})")
                    check(ran == [expected], f"flash attention {dtype_name} "
                          f"ran {ran}, expected {expected}")
                    check(ok, f"flash attention ({expected}) disagrees at "
                          f"{case} {dtype_name} causal={causal}: max|err| {err}")
                    if kernel == "fma" and dtype_name == "float32":
                        fma_err = max(fma_err, err)
                    if kernel is None and case == FLASH_SLICE and causal:
                        errs[dtype_name] = err
    # the (BH, S, D) wrapper once, against attention_ref
    q, k, v = flash_inputs(torch, (1, 256, 8, 8, 64), torch.float32, seed=99)
    fold = [x[0].transpose(0, 1).contiguous() for x in (q, k, v)]
    got, want = fa.flash_attention_bhsd(*fold), fa.attention_ref(*fold)
    check(bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()),
          "flash_attention_bhsd disagrees with attention_ref")

    times = {(dt, shape): flash_times(torch, case, getattr(torch, dt),
                                      plain=shape == "serving")
             for dt in ("bfloat16", "float32")
             for shape, case in (("serving", FLASH_SLICE), ("long", FLASH_LONG))}

    def row(name, source, dt, err):
        serving, long = times[dt, "serving"], times[dt, "long"]
        return {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention/flash_attention.py:62",
            "shape": list(FLASH_SLICE), "max_abs_err": err,
            "ms": serving["kernel"], "plain_ms": serving["plain"],
            "bound_ms": serving["bound"], "bound_by": serving["bound_by"],
            "library_ms": serving["sdpa"], "eager_ms": serving["kernel_eager"],
            "library_eager_ms": serving["sdpa_eager"],
            "fma_ms": serving["fma"], "pre_pass_ms": serving["pre_pass"],
            "long": {
                "shape": list(FLASH_LONG), "ms": long["kernel"],
                "pre_pass_ms": long["pre_pass"],
                "eager_ms": long["kernel_eager"], "library_ms": long["sdpa"],
                "fma_ms": long["fma"], "bound_ms": long["bound"],
                "bound_by": long["bound_by"], "tflops": long["tflops"]}}

    bf16_row = row("flash_attention_sm90_bf16", "flash_attention_sm90.cu",
                   "bfloat16", errs["bfloat16"])
    fp32_row = row("flash_attention_sm90_fp32", "flash_attention_sm90_fp32.cu",
                   "float32", errs["float32"])
    fp32, fp32_long = times["float32", "serving"], times["float32", "long"]
    fma_row = {
        "name": "flash_attention_fma", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:62",
        "shape": list(FLASH_SLICE), "dtype": "float32",
        "max_abs_err": fma_err, "ms": fp32["fma"], "plain_ms": fp32["plain"],
        "bound_ms": fp32["fma_bound"], "bound_by": fp32["fma_bound_by"],
        "library_ms": fp32["sdpa"], "launches": 0, "long": {
            "shape": list(FLASH_LONG), "ms": fp32_long["fma"],
            "bf16_ms": times["bfloat16", "long"]["fma"],
            "bound_ms": fp32_long["fma_bound"],
            "bound_by": fp32_long["fma_bound_by"]}}
    return bf16_row, fp32_row, fma_row


def maxplus_bound_ms(lanes: int, m: int, k: int, n: int) -> tuple[float, str]:
    """The least time of one (B, m, k) x (B, k, n) product, and its limit."""
    t_ops = 2 * lanes * m * k * n / MAXPLUS_INSTR_PER_S * 1e3
    t_bytes = 4 * lanes * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def maxplus_phase(torch) -> dict:
    """The kernel against its plain version, at exact equality; times."""
    from repro_torch.kernels.maxplus import maxplus as mp

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [((m, k), (k, n), dt) for m, k, n in MAXPLUS_SWEEP
             for dt in (torch.float32, torch.float16)]
    cases += [((lanes, p, p), (lanes, p, p), torch.float32)
              for lanes, p in MAXPLUS_BATCHED]
    worst = 0.0
    for shape_a, shape_b, dtype in cases:
        a = torch.randn(shape_a, generator=gen, device="cuda").to(dtype)
        b = torch.randn(shape_b, generator=gen, device="cuda").to(dtype)
        got = mp.maxplus_matmul(a, b)
        want = mp.maxplus_matmul_ref(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"maxplus {shape_a} x {shape_b} {dtype}: max|err| {err:.3e} "
              "(exact equality required)")
        check(got.dtype == torch.float32 and got.shape == want.shape,
              f"maxplus returned {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, want), f"maxplus disagrees with its plain "
              f"version at {shape_a} x {shape_b} {dtype}: max|err| {err}")
        worst = max(worst, err)
        del a, b, got, want

    row = {}
    for lanes, p in MAXPLUS_BATCHED:
        a = torch.randn((lanes, p, p), generator=gen, device="cuda")
        ms = time_ms(lambda: mp.maxplus_matmul(a, a), iters=10, warmup=2)
        plain_ms = time_ms(lambda: mp.maxplus_matmul_ref(a, a), iters=1,
                           warmup=1)
        bound, by = maxplus_bound_ms(lanes, p, p, p)
        print(f"maxplus B={lanes} p={p}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), kernel at "
              f"{bound / ms:.1%} of the bound; "
              f"{lanes * p ** 3 / ms / 1e9:.3f} Tpairs/s")
        row = {"name": "maxplus_matmul", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/maxplus.cu",
               "replaces": "src/repro/kernels/maxplus/maxplus.py:42",
               "shape": [lanes, p, p, p], "max_abs_err": worst, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": None}
        del a
    return row          # the last shape, p = 2944, is the row's


def rank_grid():
    """(label, graphs) of the §6.1 grid: the graphs of one label share
    their edges (a Chameleon (app, nb) at its 6 block sizes, or one
    fork-join graph), so they share one adjacency."""
    from repro_torch.core.workloads import CHAMELEON_APPS, chameleon, fork_join

    for app in CHAMELEON_APPS:
        for nb in NB_BLOCKS:
            yield f"{app}_n{nb}", [chameleon(app, nb, bs) for bs in BLOCK_SIZES]
    for w in FJ_WIDTHS:
        for ph in FJ_PHASES:
            yield f"forkjoin_w{w}_p{ph}", [fork_join(w, ph)]


def ranks_phase(torch) -> dict:
    """Upward ranks and critical paths of the whole grid (the main path),
    then the kernel against its plain version on the closure's inputs."""
    import numpy as np
    from repro_torch.kernels.maxplus import maxplus as mp
    from repro_torch.kernels.maxplus import ops

    events = []       # ((lanes, p), start, end): one event pair per call
    largest = {}      # lanes -> (p, label, adjs, times) of the largest call

    def timed(key, fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        events.append((key, start, end))
        return out

    expected, worst = 0, (0.0, "", 0)
    path_s = check_s = 0.0
    mp.reset_launch_count()
    t0 = mark = time.perf_counter()
    # path time runs from ``mark`` to the results on the host, so it holds
    # the generator's next(), which builds the label's graphs
    for label, graphs in rank_grid():
        g0 = graphs[0]
        adj = torch.as_tensor(ops.dense_adjacency(g0.n, g0.edges),
                              device="cuda")
        p = adj.shape[0]
        lanes = [(g, g.proc[:, q]) for g in graphs for q in range(g.num_types)]
        times = torch.zeros((len(lanes), p), dtype=torch.float32)
        for i, (_, w) in enumerate(lanes):
            times[i, :g0.n] = torch.as_tensor(w, dtype=torch.float32)
        times = times.to("cuda")
        adjs = adj.expand(len(lanes), p, p)
        ranks = timed((len(lanes), p), ops.batched_ranks, adjs, times)
        finish = timed((1, p), ops.longest_path_closure, adj, times[0])
        expected += 2 * ops.squarings(p)
        ranks, finish = ranks.cpu().numpy(), finish.cpu().numpy()
        path_s += time.perf_counter() - mark
        mark = time.perf_counter()

        if p > largest.get(len(lanes), (0,))[0]:
            largest[len(lanes)] = (p, label, adjs, times)
        for g in graphs[1:]:
            check(np.array_equal(g.edges, g0.edges),
                  f"{label}: block sizes do not share their edges")
        check(bool(np.isfinite(ranks).all()) and ranks.shape
              == (len(lanes), p), f"{label}: ranks {ranks.shape} not finite")
        for i, (g, w) in enumerate(lanes):
            want = g.upward_rank(w)
            rel = float(np.max(np.abs(ranks[i, :g.n] - want) / want))
            if rel > worst[0]:
                depth = int(round(g.critical_path(np.ones(g.n))))
                worst = (rel, f"{label} lane {i}", depth)
            check(rel <= RANK_RTOL, f"{label} lane {i}: ranks off by rtol "
                  f"{rel:.3e} (depth {g.critical_path(np.ones(g.n)):.0f})")
        cp = g0.critical_path(lanes[0][1])
        rel_cp = abs(float(finish[:g0.n].max()) - cp) / cp
        check(rel_cp <= RANK_RTOL, f"{label}: critical path "
              f"{finish[:g0.n].max()} against {cp}")
        print(f"ranks {label}: n {g0.n}, p {p}, {len(lanes)} lanes, "
              f"critical path {cp:.6g} (rel err {rel_cp:.2e})")
        check_s += time.perf_counter() - mark
        mark = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = mp.launch_count()
    check(launches == expected, f"maxplus launched {launches} times in "
          f"the ranks phase, expected {expected}")

    classes = {}
    for key, start, end in events:
        n_, t_ = classes.get(key, (0, 0.0))
        classes[key] = (n_ + 1, t_ + start.elapsed_time(end))
    device_ms = bound_total = 0.0
    for (lanes, p), (n_, t_) in sorted(classes.items(), key=lambda kv: kv[0][1]):
        bound = maxplus_bound_ms(lanes, p, p, p)[0] * n_ * ops.squarings(p)
        device_ms += t_
        bound_total += bound
        print(f"ranks call class B={lanes} p={p}: {n_} calls, "
              f"{n_ * ops.squarings(p)} launches, {t_:.3f} ms, bound "
              f"{bound:.3f} ms ({bound / t_:.1%})")
    print(f"ranks phase: wall {wall:.3f} s = path {path_s:.3f} s (graph "
          f"generation, adjacency, copies, the calls up to their results on "
          f"the host) + TaskGraph checks {check_s:.3f} s + "
          f"{wall - path_s - check_s:.3f} s; calls {device_ms:.3f} ms on the "
          f"card over {launches} launches (bound {bound_total:.3f} ms); "
          f"worst rank rtol {worst[0]:.3e} at {worst[1]} (depth {worst[2]})")

    # The closure's own inputs: mostly NEG_INF, so sums reach -2e30 and the
    # NEG_INF floor decides most outputs.  These launches are not the path's.
    t_exact = time.perf_counter()
    for n_lanes, (p, label, adjs, times) in sorted(largest.items()):
        c = ops.closure_input(adjs.transpose(-1, -2), times)
        for step in (1, 2):
            got = mp.maxplus_matmul(c, c)
            want = mp.maxplus_matmul_ref(c, c)
            floor = (want == mp.NEG_INF).double().mean().item()
            err = (got - want).abs().max().item()
            print(f"ranks exact {label} B={n_lanes} p={p} squaring {step}: "
                  f"max|err| {err:.3e} (exact equality required), "
                  f"{floor:.1%} of outputs at the NEG_INF floor")
            check(torch.equal(got, want), f"maxplus disagrees with its plain "
                  f"version on {label}'s squaring {step}: max|err| {err}")
            c = got
            del want
        del c, got
    print(f"ranks exact checks: {time.perf_counter() - t_exact:.1f} s")
    return {"launches": launches, "wall_s": wall, "path_s": path_s,
            "check_s": check_s, "device_ms": device_ms,
            "bound_ms": bound_total, "worst_rtol": worst[0]}


class _Planner:
    """A scheduler that logs each plan it makes and the seconds it took, so
    the replay phase can read planning apart from the rest of its path."""

    def __init__(self, name: str, log: list, inner=None):
        from repro_torch.sim import make_scheduler
        self.name, self.log, self.seconds = name, log, 0.0
        self._inner = make_scheduler(name) if inner is None else inner

    def allocate(self, g, machine):
        t0 = time.perf_counter()
        plan = self._inner.allocate(g, machine)
        self.seconds += time.perf_counter() - t0
        self.log.append((self.name, g, plan))
        return plan


def replay_bound_ms(bd, ns, S: int) -> tuple[float, str, int]:
    """The least time of one bucket's replay, its limit, and its bytes,
    from each item's own size n (``ns``): its order, floor and S time
    entries over its n tasks and the one phantom its spare order slots
    point at (none where it fills the bucket), its real pred slots (index
    and delay), each read once, and the (B, S) output written once; against
    one FADD + one FMNMX per real slot and lane and three instructions per
    real step and lane."""
    B, n_pad = bd.order.shape
    real = int(bd.pred_mask.sum())
    read = sum(min(n + 1, n_pad) for n in ns)
    moved = 4 * (read * (2 + S) + 2 * real + B * S)
    instr = S * (2 * real + 3 * sum(ns))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = instr / MAXPLUS_INSTR_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), moved


def chain_probe_ns(torch, steps: int = 200_000) -> float:
    """ns of one dependent replay step through shared memory (a load of the
    last finish time, an add, a max with 0 and with a floor, an add and a
    store), from ``replay_sm90_chain_probe``: the difference of a walk of
    2 ``steps`` and one of ``steps``, each the least of three, so the
    launch's own cost drops out."""
    import ctypes
    from repro_torch.kernels import build

    probe = build.load("replay_sm90").replay_sm90_chain_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(1, device=CARD)
    stream = torch.cuda.current_stream().cuda_stream

    def walk_ms(n: int) -> float:
        best = float("inf")
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            check(probe(out.data_ptr(), n, stream) == 0, "chain probe failed")
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        return best

    walk_ms(1000)
    check(out.item() == 1250.0, f"chain probe returned {out.item()}")
    one, two = walk_ms(steps), walk_ms(2 * steps)
    ns = (two - one) / steps * 1e6
    print(f"replay chain probe: {ns:.2f} ns a dependent step through shared "
          f"memory ({steps} steps {one:.4f} ms, {2 * steps} steps "
          f"{two:.4f} ms)")
    return ns


def pipelined_replay(graphs, machine, noise, serial_rows, planning_s
                     ) -> dict:
    """The replay phase's entries again through the pipelined executor on
    the card (``workers=os.cpu_count()``, ``cache=True``): the LP planners
    in the persistent process pool, buckets dispatched without waiting;
    twice, the first with the pool still to start (as a campaign process
    meets it) and the second with it running.  Each time its rows must
    equal ``serial_rows`` bit for bit, its replay launches the buckets it
    dispatched, and no worker pool may have broken."""
    import numpy as np
    from repro_torch.kernels.replay import replay as R
    from repro_torch.obs import registry as obs
    from repro_torch.sim import make_scheduler
    from repro_torch.sim import batch as TB
    from repro_torch.sim import pipeline as TP

    workers = os.cpu_count() or 1
    entries = [(g, machine, make_scheduler(name))
               for name in REPLAY_SCHEDULERS for g in graphs]
    out = {"workers": workers, "planning_s_1": planning_s}
    for pool in ("cold", "warm"):
        TP.clear_plan_cache()
        broken0 = obs.counter_value("plan_pool.broken")
        R.reset_launch_count()
        t0 = time.perf_counter()
        rows = TB.sweep_suite_makespans(entries, noise=noise,
                                        seeds=REPLAY_SEEDS, workers=workers,
                                        cache=True, device=CARD)
        wall = time.perf_counter() - t0
        launches = R.launch_count()
        st = TP.last_pipeline_stats()
        broken = obs.counter_value("plan_pool.broken") - broken0
        check(launches == st.buckets, f"the pipelined sweep ({pool} pool) "
              f"launched the replay {launches} times for {st.buckets} "
              "buckets")
        check(broken == 0, f"the planning pool broke {broken} times")
        check(len(rows) == len(serial_rows) and all(
            np.array_equal(a, b) for a, b in zip(rows, serial_rows)),
            f"the pipelined sweep's rows ({pool} pool) differ from the "
            "serial sweep's")
        print(f"replay pipelined, {pool} pool: {len(entries)} plans on "
              f"{workers} workers (os.cpu_count() {os.cpu_count()}) in "
              f"{st.buckets} envelope buckets, {launches} launches, "
              f"plan_pool.broken {broken}; wall {wall:.3f} s; planning "
              f"{planning_s:.3f} s at 1 worker, {st.build_wall_s:.3f} s at "
              f"{workers} ({st.plan_build_s:.3f} s of solver time summed "
              f"over the workers, the longest solve {st.solve_max_s:.3f} s);"
              f" dispatch {st.dispatch_s:.3f} s, drain (the wait for the "
              f"card) {st.drain_s:.4f} s, overlap_frac "
              f"{st.overlap_frac:.4f}; rows bit-equal to the serial sweep")
        out[pool] = {"wall_s": wall, "launches": launches,
                     "buckets": st.buckets, "planning_s": st.build_wall_s,
                     "solver_s": st.plan_build_s,
                     "solve_max_s": st.solve_max_s,
                     "dispatch_s": st.dispatch_s, "drain_s": st.drain_s,
                     "overlap_frac": st.overlap_frac, "broken": broken}
    # what the pool's start pays once: the forkserver is a fresh
    # interpreter that imports the planners (torch with them)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import repro_torch.sim.adapters"],
                   env={**os.environ, "PYTHONPATH": str(SRC)}, check=True,
                   timeout=300)
    out["planner_import_s"] = time.perf_counter() - t0
    print(f"replay pipelined: a fresh interpreter imports the planners in "
          f"{out['planner_import_s']:.3f} s; the pool's start cost "
          f"{out['cold']['planning_s'] - out['warm']['planning_s']:.3f} s "
          "(cold planning less warm)")
    return out


def replay_phase(torch) -> dict:
    """The §6.1 grid replayed at full size (the main path), serially and
    through the pipelined executor, then each bucket through the replay
    kernel against the plain version and the float64 engine.

    105 graphs (``rank_grid``) on a (32, 4) machine, planned by HLP-EST and
    HLP-OLS (210 plans), each replayed under 32 seeds of lognormal noise
    (6720 lanes) through ``repro_torch.sim.batch.sweep_suite_makespans`` on
    the card.  HEFT, a static planner of ``sim_sweep``, is left out for host
    time alone: it plans one 4620-task graph in about 7 s.  The replay
    launch counter is 0 just before the sweep; just after, it must equal
    the number of buckets.  Then the same entries through the pipelined
    executor (``pipelined_replay``).  Then, outside the counted runs, each
    bucket is rebuilt and launched on the card, held bit for bit against
    the plain version on CPU copies and against the sweep's own rows, and
    timed: the device time of a launch from a CUDA graph of 5, twice, the
    wrapper's host time apart; the smallest and largest plan of each
    scheduler at seeds 0 and 1 against ``simulate`` (rtol 1e-5)."""
    import numpy as np
    from repro_torch.kernels.replay import replay as R
    from repro_torch.sim import (FrozenPlanScheduler, Machine, NoiseModel,
                                 simulate)
    from repro_torch.sim import batch as TB

    probe_ns = chain_probe_ns(torch)
    graphs = [g for _, gs in rank_grid() for g in gs]
    machine = Machine.hybrid(*REPLAY_MACHINE)
    noise = NoiseModel(*REPLAY_NOISE)
    log: list = []
    planners = [_Planner(name, log) for name in REPLAY_SCHEDULERS]
    entries = [(g, machine, p) for p in planners for g in graphs]

    R.reset_launch_count()
    t0 = time.perf_counter()
    out = TB.sweep_suite_makespans(entries, noise=noise, seeds=REPLAY_SEEDS,
                                   device=CARD)
    wall = time.perf_counter() - t0
    launches = R.launch_count()
    planning_s = sum(p.seconds for p in planners)
    items = [(g, plan) for _, g, plan in log]
    buckets = TB.bucket_plans(items)
    S = len(REPLAY_SEEDS)
    check(launches == len(buckets), f"replay launched {launches} times, "
          f"expected one launch per bucket ({len(buckets)})")
    check(len(out) == len(entries) and all(
        o.shape == (S,) and o.dtype == np.float32 for o in out),
        "the sweep returned rows of the wrong shape or dtype")
    ms_all = np.stack(out)
    check(bool(np.isfinite(ms_all).all() and (ms_all > 0).all()),
          "a makespan is not finite and positive")
    print(f"replay sweep: {len(items)} plans x {S} seeds in {len(buckets)} "
          f"buckets, launches {launches}; wall {wall:.3f} s = planning "
          f"{planning_s:.3f} s + replay path {wall - planning_s:.3f} s "
          f"(noise, plan tensors, copies, launches, results on the host)")
    pipelined = pipelined_replay(graphs, machine, noise, out, planning_s)

    t_check = time.perf_counter()
    rows = []
    totals = dict.fromkeys(("sm90", "host", "bound", "plain", "floor"), 0.0)
    err_max = 0.0
    for (n_key, p_key), idxs in sorted(buckets.items()):
        bd = TB.BatchedPlanDag.from_plans([items[i] for i in idxs])
        tt = TB.bucket_times([TB.sample_actual_batch(*items[i], noise,
                                                     REPLAY_SEEDS)
                              for i in idxs], bd.n_pad)
        args = (bd.order, bd.pred, bd.pred_delay, bd.floor, tt)
        dev_args = [a.to(CARD) for a in args]
        R.check_indices(*dev_args[:2])
        got = R.launch(*dev_args)
        torch.cuda.synchronize()
        turns = [graph_ms(lambda: R.launch(*dev_args), iters=5)
                 for _ in range(2)]
        ms = sum(turns) / len(turns)
        t1 = time.perf_counter()
        for _ in range(5):
            R.launch(*dev_args)
        host_ms = (time.perf_counter() - t1) / 5 * 1e3
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = R.bucket_makespans_ref(*args)
        plain = time.perf_counter() - t1
        shape = tuple(bd.pred.shape) + (S,)
        g_k = got.cpu()
        err = (g_k - want).abs().max().item()
        err_max = max(err_max, err)
        check(torch.equal(g_k, want), f"the replay kernel disagrees with "
              f"its plain version on bucket {shape}: max|err| {err}")
        check(np.array_equal(g_k.numpy(), ms_all[idxs]), f"bucket "
              f"{shape}: the sweep's rows differ from the launch")
        ns = [items[i][0].n for i in idxs]
        chain = max(ns)
        floor_ms = chain * probe_ns * 1e-6
        bound, by, moved = replay_bound_ms(bd, ns, S)
        print(f"replay bucket ({n_key}, {p_key}) B,n_pad,P_pad,S={shape}: "
              f"{ms:.4f} ms (turns {turns[0]:.4f} / {turns[1]:.4f}), CUDA "
              f"graph of 5; longest chain {chain} steps, "
              f"{ms / chain * 1e6:.1f} ns a step; chain floor "
              f"{floor_ms:.4f} ms ({floor_ms / ms:.1%} of its time); "
              f"{sum(ns)} real steps a seed; wrapper {host_ms:.4f} ms of "
              f"host time a call; bound {bound * 1e3:.3f} us ({by}, {moved} "
              f"bytes), at {bound / ms:.2%} of it; plain version "
              f"{plain:.3f} s on the host; exact")
        rows.append({"shape": list(shape), "ms": ms, "turns": turns,
                     "host_ms": host_ms, "bound_ms": bound, "bound_by": by,
                     "chain": chain, "chain_floor_ms": floor_ms,
                     "steps": sum(ns), "plain_s": plain})
        for key, val in (("sm90", ms), ("host", host_ms), ("bound", bound),
                         ("plain", plain), ("floor", floor_ms)):
            totals[key] += val
    check_s = time.perf_counter() - t_check

    t_engine = time.perf_counter()
    worst = 0.0
    for name in REPLAY_SCHEDULERS:
        own = [i for i, (n_, _, _) in enumerate(log) if n_ == name]
        for i in (min(own, key=lambda k: items[k][0].n),
                  max(own, key=lambda k: items[k][0].n)):
            g, plan = items[i]
            for s in (0, 1):
                want = simulate(g, machine, FrozenPlanScheduler(plan),
                                noise=noise, seed=s).makespan
                rel = abs(float(ms_all[i, s]) - want) / want
                worst = max(worst, rel)
                check(rel <= REPLAY_RTOL, f"{name} on {g.n} tasks, seed {s}: "
                      f"replay {ms_all[i, s]} against the engine's {want}")
    engine_s = time.perf_counter() - t_engine
    print(f"replay checks: {totals['sm90']:.3f} ms over {len(rows)} buckets "
          f"(wrappers {totals['host']:.3f} ms of host time; bounds "
          f"{totals['bound'] * 1e3:.3f} us; chain floors "
          f"{totals['floor']:.3f} ms over chains of "
          f"{sum(r['chain'] for r in rows)} steps in all); plain version "
          f"{totals['plain']:.3f} s on the host, the kernel bit-equal on "
          f"every bucket; bucket checks {check_s:.3f} s; engine checks "
          f"{engine_s:.3f} s, worst rtol {worst:.3e}")
    return {"launches": launches, "buckets": rows, "wall_s": wall,
            "planning_s": planning_s, "path_s": wall - planning_s,
            "pipelined": pipelined,
            "kernel_ms": totals["sm90"], "host_ms": totals["host"],
            "bound_ms": totals["bound"], "chain_floor_ms": totals["floor"],
            "probe_ns": probe_ns, "plain_s": totals["plain"],
            "max_abs_err": err_max, "check_s": check_s,
            "engine_s": engine_s, "worst_rtol": worst}


def _probe_ms(torch, run) -> float:
    """The least of three CUDA-event timings of ``run()``."""
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def contention_sm90_probe_ns(torch, t_pad: int,
                             steps: int = 50_000) -> tuple[float, float]:
    """ns of the two links of the sm90 kernel's chains at the block it
    launches for ``t_pad`` transfers, from ``contention_sm90_chain_probe``:
    the same dependent replay step, and one combined count-and-min
    reduction (the packed per-link counts of four links at that block's
    field width, and the float64 min) of a warp alone (no barrier) or of
    the block behind one barrier.  Each is the difference of a run of 2
    ``steps`` and one of ``steps``, the least of three, so the launch's own
    cost drops out."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.contention import contention as C

    probe = build.load("contention_sm90").contention_sm90_chain_probe
    probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    probe.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.float64, device=CARD)
    stream = torch.cuda.current_stream().cuda_stream

    def run_ms(mode: int, n: int) -> float:
        return _probe_ms(torch, lambda: check(
            probe(out.data_ptr(), n, mode, t_pad, stream) == 0,
            "contention sm90 chain probe failed"))

    run_ms(0, 1000)
    check(out.item() == 1250.0, f"sm90 probe step returned {out.item()}")
    run_ms(1, 10)
    check(out.item() == 10.0, f"sm90 probe reduction returned {out.item()}")
    step = (run_ms(0, 2 * steps) - run_ms(0, steps)) / steps * 1e6
    red = (run_ms(1, 2 * steps) - run_ms(1, steps)) / steps * 1e6
    print(f"contention sm90 chain probe, T_pad {t_pad} on "
          f"{C.threads(t_pad)} threads: "
          f"{step:.2f} ns a dependent float64 replay step, {red:.2f} ns a "
          "combined count-and-min reduction")
    return step, red


def contention_bound_ms(cb, counts, items) -> tuple[float, str]:
    """The least time of one group's fixpoint and its limit: every input
    tensor read once and the durations and counts written once, against
    the float64 operations this run's data needs, from the kernel's counts
    and the items' own sizes (per replay step and real slot an add and a
    max, per real task an add; per event and real transfer about six
    operations (its activity test, the next event's candidates, the update
    of what remains); per filling round and real transfer two (its share
    and its links' test), per link four)."""
    moved = sum(t.numel() * t.element_size() for t in cb.tensors())
    moved += cb.size.numel() * 8 + counts.size * 4
    slots = cb.pred_mask.sum(dim=(1, 2)).numpy()
    n_real = [g.n for g, _ in items]
    T_real = cb.t_mask.sum(dim=1).numpy()
    L = int(max(cb.up.max(), cb.dn.max())) + 1
    rounds, events, fills = counts[:, 0], counts[:, 1], counts[:, 2]
    ops = float((rounds * (2 * slots + n_real)).sum()
                + (events * 6 * T_real).sum()
                + (fills * (2 * T_real + 4 * L)).sum())
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def split_shares(cycles) -> dict:
    """Each phase's share of the slowest plan's clock cycles (from a split
    launch), with that plan's total."""
    from repro_torch.kernels.contention import contention as C
    import numpy as np

    row = cycles[int(np.argmax(cycles.sum(axis=1)))]
    total = int(row.sum())
    return {"cycles": total, **{name: int(v) / total
                                for name, v in zip(C.PHASES, row)}}


def contention_groups(torch, items, nets, label: str, oracle: set,
                      probes: dict) -> list[dict]:
    """Each (n_pad, P_pad, L) group of ``items`` through the contention
    kernel on the card, outside any counted run: bit for bit against the
    plain version on CPU copies; the per-edge delays of the items in
    ``oracle`` within rtol 1e-6, atol 1e-9 of ``contended_plan_delays``;
    its device time from CUDA graphs of 3 launches, twice, the bare launch's
    host time, the whole wrapper's (index checks, launch, copy back) and
    the plain version's; its phase split (its split variant, the slowest
    plan); its chain floor from the per-plan counts and its probe at the
    group's block size."""
    import numpy as np
    from repro_torch.kernels.contention import contention as C
    from repro_torch.sim import batch as TB
    from repro_torch.sim.network import (CONTENTION_ITERS,
                                         contended_plan_delays)
    from repro_torch.sim import plan_times

    zeros, groups = TB.contended_buckets(items, nets)
    for i in oracle & set(zeros):
        g, plan = items[i]
        want = contended_plan_delays(g, plan, plan_times(g, plan, g.proc),
                                     nets[i])
        check(not want.any(), f"{label}: item {i} has no transfer, but the "
              "oracle charges a delay")
    rows = []
    for (n_pad, P_pad, L), (idxs, transfers, cb) in sorted(groups.items()):
        B, T_pad = cb.size.shape
        shape = (B, n_pad, P_pad, T_pad, L)
        dev_args = [t.to(CARD) for t in cb.tensors()]
        kw = {"num_links": L, "iters": CONTENTION_ITERS}
        t0 = time.perf_counter()
        whole = C.contended_durations(*dev_args, **kw).cpu()
        path_ms = (time.perf_counter() - t0) * 1e3
        got, counts_t = C.launch(*dev_args, **kw)
        torch.cuda.synchronize()
        turns = [graph_ms(lambda: C.launch(*dev_args, **kw), iters=3)
                 for _ in range(2)]
        ms = sum(turns) / len(turns)
        t1 = time.perf_counter()
        for _ in range(3):
            C.launch(*dev_args, **kw)
        host_ms = (time.perf_counter() - t1) / 3 * 1e3
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = C.contended_durations(*cb.tensors(), **kw)
        plain_s = time.perf_counter() - t1
        g_k = got.cpu()
        err = (g_k - want).abs().max().item()
        check(torch.equal(g_k, want), f"{label}: the contention kernel "
              f"disagrees with its plain version on {shape}: max|err| {err}")
        check(torch.equal(whole, want), f"{label}: the wrapper path "
              f"disagrees with the plain version on {shape}")
        counts = counts_t.cpu().numpy()
        check(bool((counts[:, 3] == counts[:, 0] * n_pad).all()
                   and (counts[:, 0] >= 1).all()
                   and (counts[:, 0] <= CONTENTION_ITERS).all()
                   and (counts[:, 4] <= counts[:, 1]).all()),
              f"{label}: implausible kernel counts {counts.tolist()}")
        out_s, counts_s, cycles = C.launch_split(*dev_args, **kw)
        check(torch.equal(out_s, got) and torch.equal(counts_s, counts_t),
              f"{label}: the split variant differs from the launch")
        split = split_shares(cycles.cpu().numpy())
        nt = C.threads(T_pad)
        if T_pad not in probes:
            probes[T_pad] = contention_sm90_probe_ns(torch, T_pad)
        step_ns, red_ns = probes[T_pad]
        rounds, events, fills, steps, merged = counts.T
        floor = float(((steps * step_ns + (fills + events - merged) * red_ns)
                       * 1e-6).max())
        oracle_s, worst = 0.0, 0.0
        got_np = g_k.numpy()
        for b, (i, tr) in enumerate(zip(idxs, transfers)):
            if i not in oracle:
                continue
            g, plan = items[i]
            delay = np.zeros(g.num_edges)
            hit = tr.key_of >= 0
            delay[hit] = got_np[b][tr.key_of[hit]]
            t1 = time.perf_counter()
            want_e = contended_plan_delays(g, plan, plan_times(g, plan, g.proc),
                                           nets[i])
            oracle_s += time.perf_counter() - t1
            diff = np.abs(delay - want_e)
            worst = max(worst, float((diff / np.maximum(np.abs(want_e),
                                                        1e-300)).max(initial=0)))
            check(np.allclose(delay, want_e, rtol=NET_RTOL, atol=NET_ATOL),
                  f"{label}: plan {i} on {g.n} tasks: the kernel's delays "
                  f"differ from the oracle's by up to "
                  f"{np.abs(delay - want_e).max()}")
        bound, by = contention_bound_ms(cb, counts[:, :4],
                                        [items[i] for i in idxs])
        n_or = len(oracle & set(idxs))
        phases = ", ".join(f"{name} {split[name]:.1%}" for name in C.PHASES)
        print(f"contention {label} group (n_pad, P_pad, L) = ({n_pad}, "
              f"{P_pad}, {L}), B, T_pad = {B}, {T_pad}: {ms:.4f} ms on {nt} "
              f"threads (turns {turns[0]:.4f} / {turns[1]:.4f}), CUDA graphs "
              f"of 3; launch host time {host_ms:.4f} ms, wrapper path "
              f"{path_ms:.3f} ms; plain version {plain_s:.3f} s on the host; "
              f"oracle {oracle_s:.3f} s on the host for {n_or} plans (worst "
              f"rel err {worst:.3e}); counts (rounds, events, fills, steps, "
              f"merged) per plan {counts.tolist()}; chain floor "
              f"{floor:.4f} ms ({floor / ms:.1%} of its time); bound "
              f"{bound * 1e3:.3f} us ({by}); exact")
        print(f"contention {label} group {shape} split of the slowest plan "
              f"(clock64 cycles of thread 0): {split['cycles']} cycles: "
              f"{phases}")
        rows.append({"shape": list(shape), "ms": ms, "turns": turns,
                     "threads": nt, "host_ms": host_ms, "path_ms": path_ms,
                     "plain_s": plain_s, "oracle_s": oracle_s,
                     "oracle_plans": n_or, "max_abs_err": err,
                     "counts": counts.tolist(), "chain_floor_ms": floor,
                     "step_ns": step_ns, "reduction_ns": red_ns,
                     "split": split, "bound_ms": bound, "bound_by": by})
    return rows


def contention_phase(torch) -> dict:
    """The campaign's network sub-grid (the main path), then the same
    generator at the §6.1 fork-join's scale, through the port's
    ``sweep_suite_makespans`` on the card, and each group of each grid
    through ``contention_groups``.

    The main path: 6 netbound scenarios x (hlp_ols, CAHLP with contention)
    replayed under each of ``instant``, ``fixed_latency`` and
    ``maxmin_fair`` with lognormal 0.2 noise and 32 seeds, the contention
    and replay launch counters and ``trace_count("contended")`` set to 0
    just before each sweep and read just after: the contention kernel
    launched once per (n_pad, P_pad, L) group under ``maxmin_fair`` and
    never under the other two, the sm90 replay kernel once per bucket.
    Every plan's delays against the oracle.  At the large scale
    (``NET_SCALE``) the same under ``maxmin_fair`` alone, the oracle run
    on seed 300's two plans only."""
    import numpy as np
    from repro_torch.kernels.contention import contention as C
    from repro_torch.kernels.replay import replay as R
    from repro_torch.sim import NoiseModel, make_network
    from repro_torch.sim import batch as TB
    from repro_torch.sim.adapters import CommAwareHLPScheduler
    from repro_torch.sim.scenarios import netbound_scenario

    noise = NoiseModel(*REPLAY_NOISE)
    S = len(REPLAY_SEEDS)
    probes: dict = {}
    out: dict = {}
    for label, (width, depth), models in (
            ("campaign", (12, 5), NET_MODELS),
            ("scale", NET_SCALE, ("maxmin_fair",))):
        scens = [netbound_scenario(width=width, depth=depth, seed=s)
                 for s in NET_SEEDS]
        sweeps, items, nets = {}, None, None
        for model in models:
            log: list = []
            planners = [_Planner("hlp_ols", log),
                        _Planner("cahlp_ctn", log,
                                 CommAwareHLPScheduler(contention=True))]
            entries = [(sc.graph, sc.machine, p) for sc in scens
                       for p in planners]
            net = make_network(model)
            C.reset_launch_count()
            R.reset_launch_count()
            TB.reset_trace_counts()
            t0 = time.perf_counter()
            rows = TB.sweep_suite_makespans(entries, noise=noise,
                                            seeds=REPLAY_SEEDS, network=net,
                                            device=CARD)
            wall = time.perf_counter() - t0
            launches, traces = C.launch_count(), TB.trace_count("contended")
            replays = R.launch_count()
            planning = sum(p.seconds for p in planners)
            items = [(g, plan) for _, g, plan in log]
            nets = [net] * len(items)
            groups = (len(TB.contended_buckets(items, nets)[1])
                      if net.contended else 0)
            buckets = len(TB.bucket_plans(items))
            check(launches == groups and traces == groups,
                  f"{label} {model}: the contention kernel launched "
                  f"{launches} times and trace_count('contended') is "
                  f"{traces}; expected {groups}, one per group")
            check(replays == buckets, f"{label} {model}: replay launched "
                  f"{replays} times, expected {buckets}")
            ms = np.stack(rows)
            check(ms.shape == (len(entries), S) and ms.dtype == np.float32
                  and bool(np.isfinite(ms).all() and (ms > 0).all()),
                  f"{label} {model}: makespans not finite and positive")
            sweeps[model] = {"wall_s": wall, "planning_s": planning,
                             "path_s": wall - planning,
                             "contention_launches": launches,
                             "groups": groups, "replay_launches": replays,
                             "mean_makespan": float(ms.mean())}
            print(f"contention {label} sweep under {model}: {len(items)} "
                  f"plans x {S} seeds, wall {wall:.3f} s = planning "
                  f"{planning:.3f} s + path {wall - planning:.3f} s; "
                  f"contention launches {launches} (groups {groups}, "
                  f"trace_count {traces}), replay {replays}; mean makespan "
                  f"{ms.mean():.4f}")
        oracle = (set(range(len(items))) if label == "campaign" else
                  {i for i, (g, _) in enumerate(items)
                   if scens[i // 2].seed in NET_ORACLE_SEEDS})
        group_rows = contention_groups(torch, items, nets, label, oracle,
                                       probes)
        out[label] = {"sweeps": sweeps, "groups": group_rows,
                      "launches": sweeps["maxmin_fair"]["contention_launches"]}
    return out


def lp_probe_ns(torch, threads: int, steps: int = 20_000) -> float:
    """ns of one level step of the first-order LP's scans at a block of
    ``threads`` threads, from ``hlp_fo_sm90_chain_probe`` (a shared-memory
    read of another thread's last value, an expf and a logf, a store and a
    barrier): the difference of a run of 2 ``steps`` and one of ``steps``,
    the least of three, so the launch's own cost drops out."""
    from repro_torch.kernels.hlp_fo import hlp_fo as HF

    def run_ms(n: int) -> float:
        return _probe_ms(torch, lambda: HF.chain_probe(n, threads))

    run_ms(100)
    return (run_ms(2 * steps) - run_ms(steps)) / steps * 1e6


def lp_bound_ms(d, iters: int, c: int = 1, q: int = 0,
                comm: bool = False) -> tuple[float, str]:
    """The least time of one solve and its limit: every input read once
    (the DAG's index arrays, the times or the choice grid, the schedule
    table, z0) and best x and λ written once, against the float32
    operations of ``iters`` steps counted as 13 a real pred slot (soft and
    exact forward, the reverse gather) and 50 a task entry (its time, soft
    max, chain rule, Adam, loads), each expf / logf as one."""
    n, P = d.pred.shape
    E = int(d.succ_task.shape[0])
    L = d.levels
    ints = (L + 1) + n + n * P + (n + 1) + 2 * E
    floats = (2 * n * c + q * c + q + (n * P if comm else 0) + 3 * iters
              + n * c + n * c + 1)
    moved = 4 * (ints + floats)
    ops = iters * (13 * E + 50 * n * c + (4 * q * E if comm else 0))
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lp_reverse_split(torch, HF, d, z0, m: int, k: int) -> dict:
    """The gather kernel's reverse pass split with clock64 on ``d``: each
    task's cycles in its successor gather, its chain rule and new x, and
    its Adam step's loads and stores, summed over the steps.  A level's
    time is its slowest task's; returned: the slowest level's split and
    the split summed over every level's slowest task (the chain)."""
    import numpy as np
    tc = torch.zeros((d.n, len(HF.REVERSE_PARTS)), dtype=torch.int64,
                     device=CARD)
    HF.launch_hybrid(d, z0, m=m, k=k, iters=LP_ITERS, kernel="gather",
                     task_cycles=tc)
    tc = tc.cpu().numpy()
    lp, lt = d.level_ptr.cpu().numpy(), d.level_task.cpu().numpy()
    slowest = []
    for lvl in range(d.levels):
        tasks = lt[lp[lvl]:lp[lvl + 1]]
        j = int(tasks[int(np.argmax(tc[tasks].sum(axis=1)))])
        slowest.append((int(tc[j].sum()), lvl, j, len(tasks)))
    top, lvl, j, width = max(slowest)
    chain = tc[[s[2] for s in slowest]].sum(axis=0)
    return {"level": lvl, "task": j, "width": width,
            "cycles": dict(zip(HF.REVERSE_PARTS, tc[j].tolist())),
            "shares": dict(zip(HF.REVERSE_PARTS, (tc[j] / top).tolist())),
            "chain_shares": dict(zip(HF.REVERSE_PARTS,
                                     (chain / chain.sum()).tolist()))}


def lp_phase(torch) -> dict:
    """The first-order LP on the card.  The main path: ``solve_hlp_jax`` on
    the solver target's instances (:data:`LP_SOLVER`), every counter 0 just
    before and, just after, one launch a solve, all of the default kernel
    (``hlp_fo_sm90.cu``).  Then the first design's reverse pass split with
    clock64 on potri nb=20, and each instance through both kernels' bare
    launches and through the plain version on CPU copies from the same
    starting logits: the kernels' best x and λ bit for bit, each against
    the plain version (λ at :data:`LP_RTOL`, threshold allocations
    identical, the main path's allocation the same), timed from CUDA
    events in turns (sm90, gather, gather, sm90) beside its chain floor (2
    level steps a level a step for sm90, 3 for gather, the probe's ns
    each), its bound, its phase split, the plain version's host time and
    HiGHS's (``solve_hlp``).  Then the choice entry on a netbound and a
    moldable instance, and one campaign-sized solve (the full grid's
    largest ``hlp_jax_ols`` graph, one warp), the same way."""
    import numpy as np
    from repro_torch.core.allocation import AllocationProblem
    from repro_torch.core.hlp import solve_hlp
    from repro_torch.core.hlp_jax import (PaddedDag, reference_normal,
                                          solve_hlp_jax)
    from repro_torch.core.workloads import chameleon
    from repro_torch.kernels.hlp_fo import hlp_fo as HF
    from repro_torch.sim.scenarios import (comm_suite, default_suite,
                                           moldable_suite, netbound_scenario)

    m, k = LP_MACHINE
    graphs = {f"{a}{nb}": chameleon(a, nb, 512) for a, nb in LP_SOLVER}
    HF.reset_launch_count()
    t0 = time.perf_counter()
    sols = {name: solve_hlp_jax(g, m, k, iters=LP_ITERS)
            for name, g in graphs.items()}
    path_s = time.perf_counter() - t0
    counts = HF.launch_counts()
    check(counts == {"sm90": len(graphs), "gather": 0}, f"the first-order "
          f"LP's main path launched {counts} for {len(graphs)} solves")
    probes: dict[int, float] = {}

    def probe(threads: int) -> float:
        if threads not in probes:
            probes[threads] = lp_probe_ns(torch, threads)
            print(f"lp chain probe: {probes[threads]:.2f} ns a level step at "
                  f"{threads} threads")
        return probes[threads]

    walks = {"sm90": 2, "gather": 3}   # level walks a step

    def both(d, run, name, c=1, q=0, comm=False) -> dict:
        """Both kernels' results (bit-equal), times in turns, chain
        floors and phase splits; ``run(kernel, cycles)`` launches."""
        res = {kern: run(kern, None) for kern in HF.KERNELS}
        (sx, sv), (gx, gv) = res["sm90"], res["gather"]
        same = (torch.equal(sx.view(torch.int32), gx.view(torch.int32))
                and torch.equal(sv.view(torch.int32), gv.view(torch.int32)))
        check(same, f"lp {name}: the sm90 kernel's best x or λ "
              f"({float(sv)!r}) differs from the gather kernel's "
              f"({float(gv)!r})")
        threads = HF.threads_for(d.max_width)
        times = {kern: [] for kern in HF.KERNELS}
        for kern in ("sm90", "gather", "gather", "sm90"):
            times[kern].append(time_ms(lambda: run(kern, None), iters=5,
                                       warmup=1))
        bound, bound_by = lp_bound_ms(d, LP_ITERS, c, q, comm)
        out = {"levels": d.levels, "width": d.max_width, "threads": threads,
               "edges": int(d.succ_task.shape[0]), "bit_equal": same,
               "probe_ns": probe(threads), "bound_ms": bound,
               "bound_by": bound_by, "x": sx.cpu().numpy(),
               "lam": float(sv)}
        for kern in HF.KERNELS:
            cycles = torch.zeros(len(HF.PHASES[kern]), dtype=torch.int64,
                                 device=CARD)
            _, cv = run(kern, cycles)
            check(float(cv) == float(sv), f"lp {name}: the {kern} kernel's "
                  "split launch changed λ")
            cyc = cycles.cpu().tolist()
            chain = walks[kern] * d.levels * LP_ITERS
            out[kern] = {"ms": sum(times[kern]) / 2, "ms_turns": times[kern],
                         "chain_steps": chain,
                         "chain_floor_ms": chain * probes[threads] * 1e-6,
                         "split": {ph: v / sum(cyc) for ph, v in
                                   zip(HF.PHASES[kern], cyc)}}
        return out

    def show(row) -> str:
        return "; ".join(
            f"{kern} {row[kern]['ms']:.3f} ms a solve (turns "
            + ", ".join(f"{t:.3f}" for t in row[kern]["ms_turns"])
            + f"), floor {row[kern]['chain_floor_ms']:.3f} ms, split "
            + ", ".join(f"{ph} {v:.3f}" for ph, v in row[kern]["split"].items())
            for kern in HF.KERNELS)

    def plain_check(name, x, lam, rx, rv, rtol, alloc) -> float:
        rel = abs(lam - rv) / abs(rv)
        check(rel <= rtol, f"lp {name}: kernel λ {lam} against the plain "
              f"version's {rv} (rel {rel:.3e} > {rtol})")
        check(np.array_equal(alloc(x), alloc(rx)), f"lp {name}: the "
              "kernels' allocation differs from the plain version's")
        return rel

    def threshold(x):
        return x >= 0.5

    def argmax(x):
        return x.argmax(1)

    split = None
    rows = []
    for name, g in graphs.items():
        t0 = time.perf_counter()
        exact = solve_hlp(g, m, k)
        highs_s = time.perf_counter() - t0
        sol = sols[name]
        check(sol.lp_value >= exact.lp_value - 1e-9, f"lp {name}: "
              f"first-order λ {sol.lp_value} below HiGHS's {exact.lp_value}")
        z0 = np.float32(0.01) * reference_normal(0, (g.n,))
        dc = PaddedDag.from_graph(g, "cpu")
        t0 = time.perf_counter()
        rx, rv = HF.hybrid(dc, torch.tensor(z0), m=m, k=k, iters=LP_ITERS)
        plain_s = time.perf_counter() - t0
        rx, rv = rx.numpy(), float(rv)
        dg = PaddedDag.from_graph(g, CARD)
        zg = torch.tensor(z0, device=CARD)
        if name == "potri20":
            split = lp_reverse_split(torch, HF, dg, zg, m, k)
        row = both(dg, lambda kern, cyc: HF.launch_hybrid(
            dg, zg, m=m, k=k, iters=LP_ITERS, kernel=kern, cycles=cyc),
            name)
        kx = row.pop("x")
        rel = plain_check(name, kx, row["lam"], rx, rv, LP_RTOL, threshold)
        check(np.array_equal(sol.alloc, np.where(kx >= 0.5, 0, 1)),
              f"lp {name}: the main path's allocation differs")
        row.update({"name": name, "n": g.n, "plain_lam": rv, "rel": rel,
                    "max_abs_err": float(np.abs(kx - rx).max()),
                    "plain_ms": plain_s * 1e3, "highs_s": highs_s,
                    "lp_highs": exact.lp_value,
                    "lp_first_order": sol.lp_value,
                    "gap_pct": (sol.lp_value / exact.lp_value - 1) * 100})
        rows.append(row)
        print(f"lp {name} (n={g.n}, {row['levels']} levels, widest "
              f"{row['width']}, {row['threads']} threads): {show(row)}; "
              f"bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}), "
              f"plain {row['plain_ms']:.1f} ms (host), HiGHS {highs_s:.3f} "
              f"s; λ rel {rel:.2e}, gap {row['gap_pct']:.3f}%; bit-equal")
    print(f"lp gather reverse split on potri20 (clock64, 300 steps): slowest "
          f"level {split['level']} (width {split['width']}, task "
          f"{split['task']}): " + ", ".join(
              f"{p} {v:.3f}" for p, v in split["shares"].items())
          + "; over every level's slowest task: " + ", ".join(
              f"{p} {v:.3f}" for p, v in split["chain_shares"].items()))

    nb = netbound_scenario(seed=300)
    mo = moldable_suite(seed=400, num=1, ccr=2.0)[0]
    choice_cases = [("netbound_s300", nb.graph, nb.counts, True,
                     LP_NETBOUND_RTOL),
                    ("moldable_s400_ccr2", mo.graph, mo.machine, False,
                     LP_RTOL)]
    crows = []
    for name, g, machine, rigid, rtol in choice_cases:
        prob = AllocationProblem.build(g, machine, comm_aware=True,
                                       rigid=rigid)
        p_dev = np.where(prob.finite, prob.p_choice, 1e12)
        ins = [p_dev, p_dev * prob.width_of.astype(np.float64),
               prob.type_mask, 1.0 / np.asarray(prob.counts, np.float64)]
        z0 = np.float32(0.01) * reference_normal(0, p_dev.shape)
        res = {}
        for dev in ("cpu", CARD):
            d = PaddedDag.from_graph(g, dev)
            t = [torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in ins]
            zt = torch.tensor(z0, device=dev)
            before = HF.launch_counts()
            t0 = time.perf_counter()
            x, v = HF.choice(d, zt, *t, iters=LP_ITERS,
                             use_comm=prob.comm_aware)
            res[dev] = (x.cpu().numpy(), float(v), time.perf_counter() - t0,
                        d, zt, t)
            after = HF.launch_counts()
            want = {"sm90": int(dev == CARD), "gather": 0}
            check({kern: after[kern] - before[kern] for kern in after}
                  == want, f"lp {name}: launches {before} -> {after} on "
                  f"{dev} for one solve")
        (rx, rv, plain_s, *_), (_, _, _, dg, zg, tg) = res["cpu"], res[CARD]
        c, q = p_dev.shape[1], prob.type_mask.shape[0]
        row = both(dg, lambda kern, cyc: HF.launch_choice(
            dg, zg, *tg, iters=LP_ITERS, use_comm=prob.comm_aware,
            kernel=kern, cycles=cyc), name, c, q, prob.comm_aware)
        kx = row.pop("x")
        check(np.array_equal(kx, res[CARD][0]), f"lp {name}: the entry's "
              "solve and the bare launch differ")
        rel = plain_check(name, kx, row["lam"], rx, rv, rtol, argmax)
        row.update({"name": name, "n": g.n, "choices": c,
                    "comm": prob.comm_aware, "plain_lam": rv, "rel": rel,
                    "rtol": rtol, "max_abs_err": float(np.abs(kx - rx).max()),
                    "plain_ms": plain_s * 1e3})
        crows.append(row)
        print(f"lp choice {name} (n={g.n}, C={c}, comm {prob.comm_aware}, "
              f"{row['threads']} threads): {show(row)}; plain "
              f"{row['plain_ms']:.1f} ms (host); λ rel {rel:.2e} (limit "
              f"{rtol}); bit-equal")

    # one campaign-sized solve: the full grid's largest hlp_jax_ols graph
    scens = (default_suite(seed=0) + comm_suite(seed=50)
             + default_suite(seed=100, counts=(16, 4))
             + comm_suite(seed=150, counts=(16, 4)))
    sc = max(scens, key=lambda s: s.graph.n)
    g, (cm, ck) = sc.graph, sc.machine.counts
    z0 = np.float32(0.01) * reference_normal(0, (g.n,))
    t0 = time.perf_counter()
    rx, rv = HF.hybrid(PaddedDag.from_graph(g, "cpu"), torch.tensor(z0),
                       m=cm, k=ck, iters=LP_ITERS)
    plain_s = time.perf_counter() - t0
    dg = PaddedDag.from_graph(g, CARD)
    zg = torch.tensor(z0, device=CARD)
    row = both(dg, lambda kern, cyc: HF.launch_hybrid(
        dg, zg, m=cm, k=ck, iters=LP_ITERS, kernel=kern, cycles=cyc),
        sc.name)
    check(row["threads"] == 32, f"lp {sc.name}: {row['threads']} threads")
    kx = row.pop("x")
    rel = plain_check(sc.name, kx, row["lam"], rx.numpy(), float(rv),
                      LP_RTOL, threshold)
    row.update({"name": sc.name, "n": g.n, "machine": [cm, ck],
                "plain_lam": float(rv), "rel": rel,
                "max_abs_err": float(np.abs(kx - rx.numpy()).max()),
                "plain_ms": plain_s * 1e3})
    print(f"lp campaign-sized {sc.name} (n={g.n}, {row['levels']} levels, "
          f"one warp): {show(row)}; plain {row['plain_ms']:.1f} ms (host); "
          f"λ rel {rel:.2e}; bit-equal")
    return {"launches": counts, "path_s": path_s, "hybrid": rows,
            "choice": crows, "campaign_solve": row, "reverse_split": split}


def _campaign_run(args: list[str], pin_path: Path, name: str
                  ) -> tuple[dict, dict, float, float, int]:
    """``python -m repro_torch.launch.campaign ARGS`` on the card in a fresh
    process, then ``benchmarks/render_tables --check-bench`` against
    ``pin_path``; both must exit 0, every pinned metric must lie within
    ``CAMPAIGN_RTOL`` of its pin and every pinned count equal it.  Returns
    the trajectory's benches, the pins, the wall, the worst relative
    difference and the number of counts held."""
    out_dir = ROOT / "build" / "campaign"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"BENCH_{name}.json"
    path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.campaign",
                          *args, "--bench-json", str(path)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        if line.startswith("#"):
            print(f"{name} | {line}")
    check(run.returncode == 0, f"the campaign entry {args} exited "
          f"{run.returncode}:\n{run.stderr[-4000:]}")
    gate = subprocess.run([sys.executable, "-m", "benchmarks.render_tables",
                           "--check-bench", str(path), str(pin_path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    print(f"{name} gate | {gate.stdout.strip()}")
    check(gate.returncode == 0, f"render_tables --check-bench exited "
          f"{gate.returncode}:\n{gate.stdout[-4000:]}{gate.stderr[-2000:]}")
    got = json.loads(path.read_text())["benches"]
    pins = json.loads(pin_path.read_text())["benches"]
    worst, counts = 0.0, 0
    for bench, pin in pins.items():
        for key, want in pin["metrics"].items():
            rel = abs(got[bench]["metrics"][key] - want) / abs(want)
            worst = max(worst, rel)
            check(rel <= CAMPAIGN_RTOL, f"{name} {bench} metric {key}: "
                  f"{got[bench]['metrics'][key]} against the pin {want}")
        for key, want in pin.items():
            if (key in CAMPAIGN_COUNTS and isinstance(want, int)
                    and not isinstance(want, bool)):
                counts += 1
                check(got[bench][key] == want, f"{name} {bench} count "
                      f"{key}: {got[bench][key]} against the pin {want}")
    return got, pins, wall, worst, counts


def campaign_phase() -> dict:
    """``python -m repro_torch.launch.campaign`` on the card in a fresh
    process (the replay shapes it counts, like the reference's jit caches,
    are per process), then the JAX package's gate ``benchmarks/render_tables
    --check-bench`` against ``benchmarks/BENCH_pinned.json``; both must exit
    0.  Beyond the gate's 5%, every pinned metric must lie within
    ``CAMPAIGN_RTOL`` of its pin and every pinned count equal it.  The
    process counts each target's replay, contention and first-order LP
    launches from 0; they must equal the replay chunks it dispatched (for
    ``sim``, the pipelined sweeps' buckets), the contention groups it
    priced, and 0.  Then ``--full --only sim`` the same way against
    ``tests/torch_sim_full_pin.json`` (the reference's trajectory of the
    full grid): the first-order LP's launches must equal the ``hlp_jax_ols``
    solves, one a scenario of the static suite."""
    from repro_torch.sim.scenarios import comm_suite, default_suite

    got, pins, wall, worst, counts = _campaign_run([], PINNED, "campaign")
    sim, search = got["sim"]["launches"], got["search"]["launches"]
    check(sim["replay"] == sim["replay_chunks"] == got["sim"]["buckets"],
          f"campaign sim: {sim['replay']} replay launches for "
          f"{sim['replay_chunks']} chunks in {got['sim']['buckets']} buckets")
    check(sim["contention"] == sim["contended_groups"] >= 1,
          f"campaign sim: {sim['contention']} contention launches for "
          f"{sim['contended_groups']} groups")
    check(search["replay"] == search["replay_chunks"] >= 1
          and search["contention"] == 0,
          f"campaign search: launches {search}")
    check(sim["hlp_fo"] == search["hlp_fo"] == 0,
          f"campaign: the quick grid launched the first-order LP: {sim}")
    summary = {"wall_s": wall, "worst_rel": worst, "counts": counts}
    for name in ("sim", "search"):
        b = got[name]
        summary[name] = {"wall_s": b["wall_s"], "launches": b["launches"],
                         **{k: b[k] for k in ("plan_build_s", "build_wall_s",
                                              "solve_max_s", "overlap_frac",
                                              "drain_s", "plan_workers",
                                              "buckets")
                            if k in b}}
        print(f"campaign {name}: wall {b['wall_s']:.3f} s, launches "
              f"{b['launches']}" + (
                  f", plan_build_s {b['plan_build_s']:.3f} over "
                  f"{b['plan_workers']} workers (build wall "
                  f"{b['build_wall_s']:.3f} s), overlap_frac "
                  f"{b['overlap_frac']:.4f}, drain {b['drain_s']:.4f} s"
                  if name == "sim" else ""))
    print(f"campaign: entry {wall:.1f} s in its own process; "
          f"{sum(len(p['metrics']) for p in pins.values())} pinned metrics "
          f"within rtol {CAMPAIGN_RTOL} (worst {worst:.3e}), {counts} "
          "pinned counts exact")

    got, pins, wall, worst, counts = _campaign_run(
        ["--full", "--only", "sim"], FULL_PIN, "campaign_full")
    full = got["sim"]["launches"]
    solves = len(default_suite(seed=0) + comm_suite(seed=50)
                 + default_suite(seed=100, counts=(16, 4))
                 + comm_suite(seed=150, counts=(16, 4)))
    check(full["hlp_fo"] == full["hlp_fo_sm90"] == solves, f"campaign full: "
          f"{full['hlp_fo']} first-order LP launches ({full['hlp_fo_sm90']} "
          f"of the sm90 kernel) for {solves} hlp_jax_ols solves")
    check(full["replay"] == full["replay_chunks"] == got["sim"]["buckets"],
          f"campaign full: {full['replay']} replay launches for "
          f"{full['replay_chunks']} chunks in {got['sim']['buckets']} "
          "buckets")
    check(full["contention"] == full["contended_groups"] >= 1,
          f"campaign full: launches {full}")
    b = got["sim"]
    summary["full"] = {"wall_s": wall, "worst_rel": worst, "counts": counts,
                       "sim_wall_s": b["wall_s"], "launches": full,
                       "hlp_jax_ols_solves": solves,
                       **{k: b[k] for k in ("plan_build_s", "build_wall_s",
                                            "solve_max_s", "overlap_frac",
                                            "drain_s", "plan_workers",
                                            "buckets") if k in b}}
    print(f"campaign full: entry {wall:.1f} s in its own process, sim wall "
          f"{b['wall_s']:.3f} s, plan_build_s {b['plan_build_s']:.3f} over "
          f"{b['plan_workers']} workers, launches {full}; "
          f"{sum(len(p['metrics']) for p in pins.values())} pinned metrics "
          f"within rtol {CAMPAIGN_RTOL} (worst {worst:.3e}), {counts} "
          "pinned counts exact")
    return summary


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

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"build: {build_all(build):.1f} s")

    t0 = time.perf_counter()
    flash_row, fp32_row, fma_row = flash_phase(torch)
    print(f"kernels: {time.perf_counter() - t0:.1f} s")

    # the serving path: counters at 0 just before, read just after
    fa.reset_launch_count()
    summary = serve.main(SERVE_ARGS)
    launches = fa.launch_count()
    per_kernel = fa.launch_counts()
    torch.cuda.synchronize()
    layers = 28
    check(launches == layers * SERVE_BATCHES,
          f"flash attention launched {launches} times, expected "
          f"{layers * SERVE_BATCHES}")
    check(per_kernel["sm90_bf16"] == launches, f"the bf16 serving path "
          f"launched {per_kernel}, not the sm90 kernel alone")
    check(summary["flash_launches"] == launches, "serve summary count differs")
    check(summary["logits_finite"], "non-finite logits while serving")
    check(summary["tokens"] == 8 * 32, f"served {summary['tokens']} tokens")
    print(f"serve qwen2-1.5b full width on {card}: {summary['tok_per_s']:.1f} "
          f"tok/s, prefill {summary['prefill_s']:.3f} s, decode "
          f"{summary['decode_s']:.3f} s, wall {summary['wall_s']:.3f} s, "
          f"makespan {summary['makespan']:.3f} s, flash launches {launches} "
          f"{per_kernel}")
    flash_row["launches"] = launches

    # two prefills of 28 layers each, through the kernel of the dtype: the
    # fp32 one is the 3xTF32 kernel's path, its counter 0 just before
    for dtype in ("float32", "bfloat16"):
        fa.reset_launch_count()
        consistency(torch, dtype)
        counts = fa.launch_counts()
        name = FLASH_KERNEL[dtype]
        check(counts == {**dict.fromkeys(counts, 0), name: 2 * layers},
              f"the {dtype} prefills launched {counts}, expected "
              f"{2 * layers} of {name}")
        print(f"prefill {dtype}: flash launches {counts}")
        if dtype == "float32":
            fp32_row["launches"] = counts[name]
        torch.cuda.empty_cache()
    print(f"serve summary: {json.dumps(summary)}")

    t0 = time.perf_counter()
    maxplus_row = maxplus_phase(torch)
    torch.cuda.empty_cache()
    print(f"maxplus: {time.perf_counter() - t0:.1f} s")

    # the ranking path: its counter at 0 just before, read just after
    ranks = ranks_phase(torch)
    maxplus_row["launches"] = ranks["launches"]
    print(f"ranks summary: {json.dumps(ranks)}")

    # the replay path: its counter at 0 just before, read just after
    t0 = time.perf_counter()
    replay = replay_phase(torch)
    print(f"replay: {time.perf_counter() - t0:.1f} s")
    buckets = replay.pop("buckets")
    bound_by = ("bytes" if all(b["bound_by"] == "bytes" for b in buckets)
                else "operations")

    sm90_row = {
        "name": "replay_makespans_sm90", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/replay_sm90.cu",
        "replaces": "src/repro/sim/batch.py:455",
        "shape": "every bucket of the sweep, summed",
        "launches": replay["launches"],
        "max_abs_err": replay["max_abs_err"],
        "ms": sum(b["ms"] for b in buckets),
        "plain_ms": replay["plain_s"] * 1e3, "plain_on": "host",
        "bound_ms": replay["bound_ms"], "bound_by": bound_by,
        "library_ms": None,
        "chain_floor_ms": replay["chain_floor_ms"],
        "chain_steps": sum(b["chain"] for b in buckets),
        "real_steps": sum(b["steps"] for b in buckets),
        "bucket_ms": [b["ms"] for b in buckets],
        "host_ms": replay["host_ms"], "probe_ns": replay["probe_ns"],
        "pipelined_launches": replay["pipelined"]["cold"]["launches"],
        "buckets": buckets}
    print(f"replay summary: {json.dumps(replay)}")

    # the contention path: its counters at 0 just before each sweep
    t0 = time.perf_counter()
    contention = contention_phase(torch)
    print(f"contention: {time.perf_counter() - t0:.1f} s")
    main_groups = contention["campaign"]["groups"]
    scale_groups = contention["scale"]["groups"]
    sm90_contention = {
        "name": "contention_fixpoint", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/contention_sm90.cu",
        "replaces": "src/repro/sim/batch.py:489",
        "also_replaces": ["src/repro/sim/network.py:473",
                          "src/repro/sim/network.py:512"],
        "shape": "every group of the campaign's netbound grid, summed",
        "launches": contention["campaign"]["launches"],
        "max_abs_err": max(g["max_abs_err"]
                           for g in main_groups + scale_groups),
        "ms": sum(g["ms"] for g in main_groups),
        "plain_ms": sum(g["plain_s"] for g in main_groups) * 1e3,
        "plain_on": "host",
        "bound_ms": sum(g["bound_ms"] for g in main_groups),
        "bound_by": ("bytes" if all(g["bound_by"] == "bytes"
                                    for g in main_groups) else "operations"),
        "library_ms": None,
        "chain_floor_ms": sum(g["chain_floor_ms"] for g in main_groups),
        "group_ms": [g["ms"] for g in main_groups],
        "host_ms": sum(g["host_ms"] for g in main_groups),
        "scale": {
            "shape": f"netbound width {NET_SCALE[0]} depth {NET_SCALE[1]}, "
                     "every group",
            "launches": contention["scale"]["launches"],
            "ms": sum(g["ms"] for g in scale_groups),
            "plain_ms": sum(g["plain_s"] for g in scale_groups) * 1e3,
            "bound_ms": sum(g["bound_ms"] for g in scale_groups),
            "chain_floor_ms": sum(g["chain_floor_ms"]
                                  for g in scale_groups)},
        "groups": main_groups + scale_groups}
    print(f"contention summary: {json.dumps(contention)}")

    # the first-order LP: its counter at 0 just before the main path
    t0 = time.perf_counter()
    lp = lp_phase(torch)
    print(f"lp: {time.perf_counter() - t0:.1f} s")
    hybrid, lp_all = lp["hybrid"], lp["hybrid"] + lp["choice"]
    lp_rows = {}
    for kern, name, source in (
            ("sm90", "hlp_fo_solve", "hlp_fo_sm90.cu"),
            ("gather", "hlp_fo_solve_gather", "hlp_fo.cu")):
        lp_rows[kern] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/core/hlp_jax.py:122",
            "also_replaces": ["src/repro/core/hlp_jax.py:172"],
            "shape": f"{', '.join(r['name'] for r in hybrid)} on "
                     f"{LP_MACHINE}, {LP_ITERS} iterations, summed",
            "launches": lp["launches"][kern],
            "max_abs_err": max(r["max_abs_err"] for r in lp_all),
            "ms": sum(r[kern]["ms"] for r in hybrid),
            "plain_ms": sum(r["plain_ms"] for r in hybrid),
            "plain_on": "host",
            "bound_ms": sum(r["bound_ms"] for r in hybrid),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in hybrid) else "operations"),
            "library_ms": None,
            "chain_floor_ms": sum(r[kern]["chain_floor_ms"] for r in hybrid),
            "highs_ms": sum(r["highs_s"] for r in hybrid) * 1e3,
            "instance_ms": {r["name"]: r[kern]["ms"]
                            for r in lp_all + [lp["campaign_solve"]]},
            "split": {r["name"]: r[kern]["split"] for r in hybrid}}
    lp_rows["sm90"]["reverse_split_of_gather"] = lp["reverse_split"]
    lp_rows["sm90"]["instances"] = lp_all + [lp["campaign_solve"]]
    print(f"lp summary: {json.dumps(lp)}")

    # the port's campaign entry in a fresh process, then the pinned gate;
    # then the full sim grid against the reference's trajectory
    t0 = time.perf_counter()
    campaign = campaign_phase()
    print(f"campaign: {time.perf_counter() - t0:.1f} s")
    sm90_row["campaign_launches"] = sum(
        campaign[b]["launches"]["replay"] for b in ("sim", "search"))
    sm90_contention["campaign_launches"] = sum(
        campaign[b]["launches"]["contention"] for b in ("sim", "search"))
    lp_rows["sm90"]["campaign_launches"] = (
        campaign["full"]["launches"]["hlp_fo_sm90"])
    lp_rows["gather"]["campaign_launches"] = (
        campaign["full"]["launches"]["hlp_fo"]
        - campaign["full"]["launches"]["hlp_fo_sm90"])
    print(f"campaign summary: {json.dumps(campaign)}")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          "imports, build included")
    print(json.dumps({"kernels": [flash_row, fp32_row, fma_row,
                                  maxplus_row, sm90_row, sm90_contention,
                                  lp_rows["sm90"], lp_rows["gather"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
