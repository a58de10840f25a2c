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
   Then (SERVE_MORE) olmo-1b and whisper-medium at their full
             published configs through ``launch.serve.main``, granite-34b
             and internvl2-76b at full width with 16 of their 88 / 80
             layers (``dataclasses.replace(get_config(...),
             num_layers=16)``; all their layers do not fit the card in
             bf16) through ``launch.serve.generate`` with the entry's
             zero frontend embeddings: 8 requests in batches of 4, prompt
             512 (whisper-medium's 416: 448 tokens, its text context; 256
             vision positions before internvl2-76b's), 32 generated, every
             flash counter 0 just before and layers x 2 bf16 launches just
             after (the decoder's causal self-attention; whisper-medium's
             encoder and cross-attention take the chunked path); each
             model's bf16 prefill/decode consistency (seeded frontend
             embeddings) at 0.32 of its logits' std, whisper-medium's at
             CONSIST_TOL.
   moe     — the MoE family (``kernels/csrc/moe_sm90.cu``: route, dispatch,
             combine): each entry against its plain version on the card,
             bit for bit, at qwen2-moe-a2.7b's and granite-moe-1b-a400m's
             prefill (4 x 512 tokens) and decode (4) shapes, bf16 and fp32,
             capacity factor 1.25 and 0.5 (entries drop), then NaN through
             dropped entries, then the route's edge shapes (MOE_EDGE: the
             one-warp and the cluster routes, ragged shares, E = 1 and 64,
             k = 1 and 8, cap 1, every expert over capacity, experts out of
             range, 65,536 entries; a few of them again by token at a wide
             D, MOE_EDGE_WIDE); each entry timed at both configs'
             prefill and decode shapes in bf16 (CUDA graphs; the plain
             versions eagerly) beside its byte bound and its launch floor
             (an empty kernel launched and timed as the entry).  Then both
             configs at their full published configs through
             ``launch.serve.main`` (8 requests in batches of 4, prompt 512,
             32 generated, bf16): every flash and MoE counter 0 just
             before, and just after layers x 2 bf16 flash launches and
             layers x 2 x 32 launches of each MoE entry; one full-width
             prefill through the kernels against the same prefill through
             the plain versions, logits and cache bit for bit; the bf16
             prefill/decode consistency of 32 sequences, each read where
             its routing premise holds (else recorded as not applicable,
             with the layers that broke it), and for granite-moe-1b-a400m
             the same in fp32 at CONSIST_TOL["float32"].
   ssm     — the SSM and hybrid families.  First ``ssd_sm90.cu`` (scan,
             scan_grad, step; ROADMAP B7) against its plain versions on the
             card (SSD_SHAPES: mamba2-130m's serving and training shapes,
             jamba-v0.1-52b's SSM at 4 x 512 and 2 x 2048, a prompt of 1000
             padded to chunks of 256, a chunk of 13; step at both configs'
             decode shapes), bf16 and fp32: scan within 1e-5 (fp32) / 2e-2
             (bf16) and scan_grad within 1e-4 / 2e-2 of each tensor's
             largest magnitude, step's state and conv window bit for bit, every
             entry twice bit for bit; each timed from a CUDA graph beside
             its bound and its launch floor, the plain version eagerly.
             Then mamba2-130m at its full published config through
             ``launch.serve.main`` (8 requests in batches of 4, prompt 512,
             32 generated, bf16): every flash, MoE and SSD counter 0 just
             before, and just after flash and MoE 0, scan layers x 2 and
             step layers x 2 x 31; prefill(S) plus one decode step against
             prefill(S + 1) in fp32 at CONSIST_TOL["float32"] and bf16 at
             CONSIST_TOL["bfloat16"]; the kernel path's full-width prefill
             against the plain path's (``layers.ssd_ops`` bound to the plain
             versions), in fp32 and bf16: each layer's scan against the
             plain scan on the same inputs (1e-5 / 2e-2), and the whole
             prefill's distance from the prefill in the wider dtype (float64
             / fp32) at most SSM_PREFILL_FACTOR times the farthest plain
             path's (fp32: on the card, and with its scans summed in
             SCAN_ORDERS; bf16: on the card and on the CPU), printed
             beside a control (the plain path on the CPU against it on
             the card); one SSM
             layer's ``ssm_apply`` (4 x 512) and ``ssm_decode`` (4) timed
             beside their bounds; one ``torch.profiler`` trace each of a
             prefill batch and a decode step (device time by op, the SSD
             recurrence's share, the busy share, traced and untraced).  jamba-v0.1-52b at full width and 16 of its 32 layers
             through ``launch.serve.generate``: flash launches = 2
             attention layers x 2 prefill batches, each MoE forward entry 8
             MoE layers x 2 x 32, scan 14 SSM layers x 2 and step 14 x 2 x
             31; entries dropped; each batch's decode s beside a warm
             batch's, and a profiler trace of a prefill and a decode step;
             the kernel path's prefill bit for bit the path with the MoE's
             plain versions, each of its scans against the plain scan on
             the same inputs at 2e-2, the all-plain prefill's difference
             printed; bf16 consistency under the MoE premise; in fp32 at 8
             layers (one period), where it fits beside its caches, the
             same three comparisons (each scan at 1e-5), the whole
             prefill's distance from the float64 prefill at most
             SSM_PREFILL_FACTOR times the farthest all-plain path's (in
             SCAN_ORDERS too), and the consistency.
   train   — olmo-1b's training path (``launch.train``'s step function) at
             its full published config, bf16 compute, fp32 parameters,
             batch 8 x 2048, 20 steps: the flash counter 0 before and 0
             after (training takes the chunked attention), every loss and
             grad norm finite, the first loss within 1.0 of ln(50304), the
             last below the first; step s, tokens/s, peak memory and
             (6 N + 12 L S H Dh) tokens / step s against the bf16 peak.
             Two microbatches against one step in fp32 (atol 2e-5); the
             card against the CPU in fp32 at full width and 2 layers, batch
             2 x 512 (rtol 1e-4); the resilient loop with a failure against
             an uninterrupted run bit for bit, at 2 layers, batch 2 x 256,
             in a fresh process (``python3 chip_smoke.py --train-resume
             DIR``) under deterministic algorithms.
             Then the MoE family (``moe_sm90.cu``'s backward entries:
             dispatch_grad, the combine with unit gates; combine_grad;
             gate_grad; and the forward dispatch, which with combine_grad
             goes by token there): each bit for bit to its plain version at
             both MoE configs' training shape (8 x 2048 tokens), bf16 and
             fp32, capacity 1.25 and 0.5, and in NaN cases, and timed there
             (CUDA graphs) beside its byte bound and launch floor; a
             full-width MoE layer's gradients (x, router, experts, shared)
             through the kernels bit for bit those through the plain
             versions; granite-moe-1b-a400m at its full config through the
             trainer's step (bf16, fp32 state, remat full, batch 8 x 2048,
             20 steps): the flash and MoE counters 0 just before and, just
             after, 0 flash launches and layers x steps x (route 2,
             dispatch 2, combine 3, combine_grad 1, gate_grad 1); finite
             falling losses from ln V, each step's aux loss and dropped
             share, step s, tokens/s, peak GB and (6 N_active + 12 L S H
             Dh) tokens / step s; qwen2-moe-a2.7b at full width and 2 of
             24 layers, 6 steps, the same checks; granite-moe at 2 layers
             in fp32 on the card against the CPU (rtol 1e-4) where no
             top-k choice flips between the two.
             Then the SSM family: mamba2-130m at its full published config
             through the trainer's step (bf16, fp32 state, remat full, batch
             8 x 2048, 20 steps): every flash, MoE and SSD counter 0 just
             before and, just after, flash and MoE 0, scan layers x steps x
             2 (the forward and remat's recompute) and scan_grad layers x
             steps; finite falling losses from ln V, step s, tokens/s, peak
             GB and (6 N tokens + 3 x the scan's operations a layer) / step
             s; the card against the CPU in fp32 at full width and 2
             layers, batch 2 x 512 (the loss, the grad norm, every gradient
             and AdamW on the same gradients at rtol 1e-4); the kernel path
             against the plain path on the card at that cut in bf16 (the
             loss and every gradient within 2e-2 of each leaf's largest
             magnitude); jamba-v0.1-52b's smoke config 6 steps on the card
             with the SSD and MoE launches exact, and card against CPU in
             fp32 where no top-k choice flips.
   encdec  — whisper-medium (served above): fp32 prefill/decode
             consistency at full config over 448 tokens with seeded audio
             frames at CONSIST_TOL, 2 x 24 fp32 flash launches; trained at
             its full config through the trainer's step (bf16, fp32 state,
             remat full, 8 x (1500 frames + 448 tokens), 10 steps): 0 flash
             launches, finite falling losses from ln V, step s, text
             tokens/s and positions/s, peak GB and ``_encdec_train_flops``
             / step s; card against CPU in fp32 at 2 + 2 layers, batch 2
             (every gradient, AdamW's parameters and moments on the same
             gradients, rtol 1e-4).
   vlm     — internvl2-76b at full width (served above): fp32 consistency
             at 4 layers; trained at 1 of its 80 layers, batch 4 x (256 +
             1792), 6 steps, the same checks as whisper-medium's.
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
             ``solve_hlp_jax`` on the card: the ``hlp_fo`` counter set to 0
             just before and required, just after, to show one launch of
             ``hlp_fo_sm90.cu`` a solve.  Then each instance through the
             kernel's bare launch in both of its layouts (shared memory,
             and the scratch buffer ``layout="global"`` forces) and the
             plain version on CPU copies from the same starting logits:
             the layouts' best x and λ bit for bit, λ at rtol 1e-5 of the
             plain version and identical threshold allocations; one
             comm-aware netbound instance and one moldable instance
             through the choice entry the same way (both bit for bit,
             ``LP_NETBOUND_RTOL`` and ``LP_MOLDABLE_RTOL`` 0: the card's XLA
             exp / log twins equal the plain version's, and the kernel's
             best x the reference's pinned best x bit for bit at 160 / 250
             / 300 iterations, the moldable one from the pinned z0 of the
             reference's program; the hybrid entry's best x and λ equal to
             ``tests/torch_hlp_fo_hybrid_pin.json``'s bits); and one
             campaign-sized solve (the full grid's largest ``hlp_jax_ols``
             graph, 43 tasks, one warp).  The kernel timed from CUDA events
             twice beside its chain floor (2 level steps a level a step,
             each as ``hlp_fo_sm90_chain_probe`` measures it) and the split
             of its chain's clock cycles over the phases of a step; the
             bound, the plain version's host time and HiGHS's
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
11. paper  — the paper's §6 experiments and the kernels target:
             ``python -m repro_torch.launch.campaign --only
             offline2,offline3,online,kernels`` on the card in a fresh
             process (its counters from 0 in that process), each
             experiment's dict held to ``tests/torch_paper_pin.json`` (the
             reference's own outputs on the default grid) with ``==`` on
             every float, 544 runs each, its CSVs' rows and SHA-256 (the
             ``lp_seconds`` timing column taken out) and its lines (the µs
             column taken out) equal to the pin's (where this host's HiGHS
             returns another optimal LP vertex than the pin's, those rows
             are reproduced from the pin's allocations and the dict and
             lines held from the reconciled rows); the ``kernels`` target's
             (max, +) and flash attention launches above 0 and its µs a
             call printed.  Then the placement planner
             (``repro_torch.core.placement.plan_pipeline``) on the full
             published granite-3-2b and qwen2-1.5b configs at seq 4096 and
             batch 8, on the pin's 2- and 3-pod platforms with 1 and 6
             streams: each plan's allocation, makespan and LP bound equal
             to the pin's (a plan on another optimal LP vertex: LP* within
             rtol 1e-12 of the pin's, within the Q(Q+1) bound, and OLS on
             the pin's allocation giving the pin's makespan exactly).

12. streams — the open-system streams: the campaign entry with
             ``--only streams`` and ``--full --only streams`` on the card,
             each in a fresh process (``python3 chip_smoke.py
             --streams-entry ARGS``, the entry with every rollout's
             makespans kept), held to ``tests/torch_streams_pin.json`` (the
             reference's outputs, each written from a fresh process) with
             ``==``: the 15 mean slowdowns and ``sitl_vs_erls_bursty``, runs
             (30, 60), jobs (480, 1920), replay shapes, the CSV's digest,
             the 16 lines (µs aside) and the digest of the 96 / 384
             arrivals' rollout makespans; the replay launches above 0 and
             equal to the chunks dispatched.  Then the pin's Chameleon stream (32 jobs,
             31,196 tasks on (32, 4)) under ``sim_in_the_loop`` (8 noisy
             rollout seeds) and ``er_ls`` in a fresh process on the card
             (``python3 chip_smoke.py --chameleon-stream cuda ...``), and
             ``sim_in_the_loop`` with its rollouts on the CPU in another:
             mean slowdown, each job's (arrival, start, finish), the task
             records' SHA-256, the decisions, the replay shapes and the
             digest of the 32 arrivals' 4 x 8 rollout makespans equal to
             the pin's (so the card's rollouts equal the CPU's bit for
             bit); the rollout wall (``stream.rollout`` spans), the
             replay launches (= chunks) and their kernel ms (CUDA events).

The tests that launch a kernel run apart, on the same card:

    PYTHONPATH=src python -m pytest -q --noconftest -m card \
        tests/test_torch_flash_card.py tests/test_torch_maxplus_card.py \
        tests/test_torch_replay_card.py tests/test_torch_replay_sm90_card.py \
        tests/test_torch_contention_card.py \
        tests/test_torch_contention_sm90_card.py \
        tests/test_torch_pipeline_card.py tests/test_torch_hlp_fo_card.py \
        tests/test_torch_hlp_fo_sm90_card.py tests/test_torch_streams_card.py \
        tests/test_torch_train_card.py tests/test_torch_moe_card.py \
        tests/test_torch_ssm_card.py tests/test_torch_ssd_card.py

To compare two trees on one card, run ``python3 chip_smoke.py --pair
TREE LABEL ARCH...`` for each side in turns (parent, change, change,
parent): one JSON line a side, with the MoE entries' times of each ARCH
that has experts, the SSD entries' times when mamba2-130m is an ARCH, and
each ARCH's serving.  ``python3 chip_smoke.py --ssd-split OUT [TREE]``
prints the device time of each kernel of the SSD scan and its backward
from a profiler trace and writes it to OUT as JSON.

Each phase prints its wall seconds on a line of its own (``phase NAME: S
s``) and all of them in one JSON object at the end.  The line before the
last is the card's name and power limit, the one before it a JSON object
of per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits with code 1 and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
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

# The further configs, served as qwen2-1.5b is (2 batches of 4 requests,
# 32 generated, bf16), each as (arch, layers served or None for the full
# config, prompt, the consistency check's sequence).  olmo-1b at its full
# published config through the serve entry point; granite-34b at full
# width (d 6144, 48 query heads on 1 kv head, d_ff 24576) with its depth cut
# to 16 of its 88 layers, through launch.serve.generate: 8.8 B parameters,
# 35 GB in fp32 at init and 17.6 GB served in bf16, where all 88 layers
# take 94 GB in bf16, more than the card's 80 GB.
#
# The encoder-decoder family: whisper-medium ([arXiv:2212.04356]) at its
# full published config (24 encoder + 24 decoder layers, d 1024, 16 heads
# of 64, d_ff 4096, 1500 audio frames from the stub frontend; 0.758 B
# parameters) through the serve entry point, a prompt of 416 and 32
# generated (448 tokens, its text context, over which consistency runs).
# The decoder's self-attention at prefill takes the causal flash path (416
# fills no 128-row tile at its end); the encoder's and the cross-attention
# are not causal and take the chunked path, as the reference's.
#
# The vision-language family: internvl2-76b ([arXiv:2404.16821]: the
# InternLM2 decoder, d 8192, 64 query heads on 8 kv heads of 128, d_ff
# 28672, vocab 128,256, 256 vision tokens from the stub frontend; 70.6 B
# parameters, 141 GB in bf16 at its 80 layers, more than the card's 80 GB)
# at full width with its depth cut to 16 layers (15.8 B parameters, 31.6 GB
# in bf16) through launch.serve.generate, 256 vision + 512 text + 32
# generated (768 positions on the causal flash path).
SERVE_MORE = (("olmo-1b", None, 512, 512), ("granite-34b", 16, 512, 512),
              ("whisper-medium", None, 416, 448),
              ("internvl2-76b", 16, 512, 512))
CONSIST_SEQ = {arch: seq for arch, _, _, seq in SERVE_MORE}

# whisper-medium trained at its full config through the trainer's step:
# bf16, fp32 state, remat full, 8 x (1500 frames + 448 tokens), the
# pipeline's seeded audio frames; its fp32 consistency at full config; the
# card against the CPU in fp32 at 2 + 2 layers, batch 2.
ENCDEC_ARCH = "whisper-medium"
ENCDEC_TRAIN = {"steps": 10, "warmup": 10, "batch": 8, "seq": 448,
                "lr": 3e-3}
ENCDEC_CPU_CHECK = {"layers": 2, "batch": 2, "seq": 448}
# internvl2-76b at full width: fp32 consistency at 4 layers (5.5 B
# parameters, 22.1 GB); trained at 1 layer (2.96 B parameters, 47 GB of
# fp32 parameters, gradients and AdamW moments, 2.1 B of them the
# embedding and the head), batch 4 x (256 + 1792), 6 steps; 2 layers
# (3.81 B, 61 GB of state) ran the card out of memory.  The lr: with 2.1 B
# of its 2.96 B parameters in the 128,256-row embedding and head, the
# 1-layer model's loss ended above its first at a peak lr of 3e-3 and of
# 2e-4 over 6 warmup steps on an H100, and falls at 5e-5.
VLM_ARCH = "internvl2-76b"
VLM_FP32_LAYERS = 4
VLM_TRAIN = {"layers": 1, "steps": 6, "warmup": 6, "batch": 4, "seq": 1792,
             "lr": 5e-5}
SERVE_PROMPT, SERVE_GEN, SERVE_BATCH = 512, 32, 4

# The MoE family, served as the dense models (2 batches of 4 prompts of 512,
# 32 generated, bf16) at their full published configs: qwen2-moe-a2.7b (24
# layers, d 2048, 60 experts top-4 of d_ff 1408 and 4 shared, 14.3 B
# parameters, 28.6 GB served) and granite-moe-1b-a400m (24 layers, d 1024,
# 32 experts top-8 of d_ff 512, 1.3 B).  The dispatch/combine kernel is held
# to its plain version at each model's prefill (4 x 512 tokens) and decode
# (4 tokens) shapes, bf16 and fp32, at capacity factors 1.25 (the configs')
# and 0.5 (entries drop), bit for bit; the full-width prefill through the
# kernels bit for bit against the same prefill through the plain versions.
# Consistency: prefill(S) and decode(S-1 | prefill S-1) compute one function
# for a sequence only where the routing agrees: the prefill of S kept every
# choice of the last position in every layer, no top-k choice flipped between
# the two paths (bf16 rounding can swap two experts of near-equal
# probability), and the earlier positions were routed alike in both
# prefills.  Each sequence is read where that holds, at the config's capacity
# and at a capacity of every token (cf = E / k), where nothing drops.  With
# random weights a qwen2-moe-a2.7b sequence flips a choice in some of its 24
# layers more often than not (4 of 4 sequences at a capacity of every token
# on an H100), so 32 sequences are run for a few that keep every choice.
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")
MOE_CAPACITY = (1.25, 0.5)
MOE_CONSIST_BATCH = 32
# The fp32 prefill/decode consistency at full config, at CONSIST_TOL
# ["float32"] where the premise holds, as qwen2-1.5b's: granite-moe-1b-
# a400m's fp32 tree is 5.3 GB (qwen2-moe-a2.7b's, 57 GB, is not run).
MOE_FP32_CONSIST = ("granite-moe-1b-a400m",)
# The route's edge shapes, each entry bit for bit to its plain version on
# the card (tests/test_torch_moe_sm90.py emulates the route on the same
# cases): (name, tokens, experts, top-k, cap; None: capacity 1.25 / 0.5).
# Contiguous shares whole and ragged, one block and a few, E = 1 and 64,
# top-1 and top-8, cap 1, every expert over its capacity, the decode
# shapes' one warp (a repeated expert and one out of range), experts out
# of range, and 65,536 entries (the consistency prefill of qwen2-moe).
MOE_EDGE = (("shares_whole_tiles", 2048, 60, 4, 176),
            ("shares_ragged", 2091, 32, 4, 80), ("one_block", 11, 8, 3, 2),
            ("few_blocks", 450, 12, 4, 40), ("one_expert", 700, 1, 1, 300),
            ("e64_top8", 1000, 64, 8, 40), ("top1", 3000, 16, 1, 200),
            ("cap_one", 777, 24, 2, 1), ("all_overflow", 2048, 32, 8, 12),
            ("warp_1x1", 1, 60, 1, 4), ("warp_4x4", 4, 60, 4, 4),
            ("warp_4x8", 4, 60, 8, 4), ("out_of_range", 1500, 36, 4, 50),
            ("entries_65536_cf1.25", 16384, 60, 4, None),
            ("entries_65536_cf0.5", 16384, 60, 4, None))

# Edge routings of MOE_EDGE again at a D that puts x past ROWS_IN_L2 (the
# dispatch and combine_grad by token): (name, D, dtype).  Every D here is
# more than 512 vectors a token (bf16 above 4096, fp32 above 2048), so the
# token blocks' vector loop reloads; an inf and a NaN at dropped tokens sit
# in the reloaded columns.
MOE_EDGE_WIDE = (("one_expert", 12288, "bfloat16"),
                 ("cap_one", 12288, "bfloat16"),
                 ("e64_top8", 12288, "bfloat16"),
                 ("out_of_range", 8192, "bfloat16"),
                 ("all_overflow", 6144, "float32"))

# x's bytes of the dispatch that ``--pair`` also times in bf16, between the
# serving prefill's 4-8 MB and the training shape's 33.5-67 MB.
PAIR_GAP_BYTES = 24 << 20

# The MoE entries of the forward pass (serving launches only these).
MOE_FORWARD = ("route", "dispatch", "combine")

# The SSM and hybrid families, served as the others (2 batches of 4 prompts
# of 512, 32 generated, bf16).  mamba2-130m at its full published config
# ([arXiv:2405.21060]: 24 layers, d 768, d_inner 1536, 24 heads of 64,
# state 128, chunk 256, tied embeddings; 0.129 B parameters) through
# launch.serve.main: no flash and no MoE launch; its prefill(S) plus one
# decode step against prefill(S + 1), the chunked scan against the
# recurrence, in fp32 at CONSIST_TOL["float32"] and in bf16 at
# CONSIST_TOL["bfloat16"]; one torch.profiler trace of a prefill batch and
# of a decode step.  jamba-v0.1-52b at full width ([arXiv:2403.19887; hf]:
# d 4096, GQA 32:8, d_ff 14336, 16 experts top-2 every 2nd layer, attention
# at offset 4 of each period of 8, SSM state 16, 128 heads of 64) cut to
# HYBRID_LAYERS of its 32 layers (26.0 B parameters, 52 GB served in bf16;
# all 32 take 103 GB), as granite-34b is cut: flash launches = attention
# layers x prefill batches, each MoE entry = MoE layers x prefill batches x
# SERVE_GEN; the kernel path's prefill bit for bit the plain path's
# (layers.moe_ops bound to the plain versions); the bf16 consistency of
# HYBRID_CONSIST_BATCH sequences under the MoE premise; and in fp32 at
# HYBRID_FP32's depth (one period, 13.3 B parameters, 53 GB) where it fits
# beside its caches.
SSM_ARCH = "mamba2-130m"
PROFILE_UNTRACED = 3     # untraced calls timed beside each profiled one
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 16
HYBRID_CONSIST_BATCH = 8
HYBRID_FP32 = {"layers": 8, "batch": 4}

# The SSD kernels (ssd_sm90.cu: scan, scan_grad, step; ROADMAP B7), each
# against its plain version (kernels/ssd/ref.py) on the same card inputs in
# bf16 and fp32: scan within SSD_TOL[dtype][0] and scan_grad within
# SSD_TOL[dtype][1] of each tensor's largest magnitude, each run twice bit
# for bit; step's state and conv window bit for bit, its readout at the
# forward's tolerance.  Shapes (b, s, valid steps, nh, hd, ns, lc):
# mamba2-130m's serving prefill and training batch, jamba-v0.1-52b's SSM at
# its serving prefill and its training length, a prompt of 1000 padded to 4
# chunks of 256 (dt 0 on the padded steps, as ssm_apply pads), a chunk of
# 13; step at both configs' decode shapes (b, nh, hd, ns, conv window
# width).  Each entry timed from a CUDA graph (bf16) beside its bound and
# its launch floor (an empty kernel launched as the entry launches its
# kernels); the plain versions eagerly.
SSD_SHAPES = {"mamba2-130m serving": (4, 512, 512, 24, 64, 128, 256),
              "mamba2-130m training": (8, 2048, 2048, 24, 64, 128, 256),
              "jamba-v0.1-52b serving": (4, 512, 512, 128, 64, 16, 256),
              "jamba-v0.1-52b": (2, 2048, 2048, 128, 64, 16, 256),
              "padded S=1000": (2, 1024, 1000, 24, 64, 128, 256),
              "S=13": (2, 13, 13, 24, 64, 128, 13)}
SSD_TIMED = ("mamba2-130m serving", "mamba2-130m training", "jamba-v0.1-52b")
SSD_STEP = {"mamba2-130m": (4, 24, 64, 128, 1792),
            "jamba-v0.1-52b": (4, 128, 64, 16, 8224)}
SSD_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
# The whole SSM prefill through the kernels, held against the prefill of
# the same parameters in the wider dtype (bf16 against fp32, fp32 against
# float64): its distance, key by key (logits, state, conv), at most
# SSM_PREFILL_FACTOR times the farthest of the plain paths it is held
# against.  In bf16 those are the plain path on the card and on the CPU.
# In fp32 they are the plain path on the card and the same path with the
# plain scan's contractions summed in the SCAN_ORDERS (the cumsum stays in
# order): plain paths that differ from the card's only where the kernel
# path does, in the scans' summation order.  The CPU path differs in every
# product and lies about three times further from float64 (mamba2-130m:
# 8.8e-5 - 1.06e-4 against 2.5e-5 - 3.1e-5), so it is printed, not held
# against, in fp32.  jamba-v0.1-52b's fp32 prefill at HYBRID_FP32's depth
# is held the same way.  The factor comes from the
# run before the forward scan moved to the tensor cores (mamba2-130m,
# NVIDIA H100 80GB HBM3, 700.00 W): in bf16 the kernel path then stood at
# 1.007 / 0.992 / 0.977 times the larger plain distance (logits 0.1363
# against 0.1354, state 0.1173 against 0.1183, conv 0.1293 against
# 0.1323), in fp32 at 1.00 (bit for bit the plain path on the card), while
# the two plain paths, the same roundings in other summation orders, were
# up to 17% apart (bf16 state: 0.1009 on the card, 0.1183 on the CPU);
# 1.25 leaves that spread and a margin above it.
SSM_PREFILL_FACTOR = 1.25
#: the contracted index's orders of the plain scan's reordered paths
SCAN_ORDERS = ("reversed", "even-odd", "rotated")

# The SSM family's training: mamba2-130m at its full published config
# ([arXiv:2405.21060]: 24 layers, d 768, state 128; 0.129 B parameters) as
# olmo-1b's run: bf16 compute, fp32 parameters and AdamW state, remat
# "full", batch TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps.  A layer a step
# launches the scan twice (the forward and remat's recompute, whose
# per-chunk states the backward takes) and scan_grad once:
# SSM_TRAIN_LAUNCHES.  Then the card against the CPU in fp32 at
# TRAIN_CPU_CHECK's cut (the loss, the grad norm, every gradient, AdamW on
# the same gradients, at TRAIN_CPU_RTOL); the kernel path against the plain
# path (layers.ssd_ops bound to ref) at that cut in bf16, within
# SSD_TOL["bfloat16"] of each leaf's largest magnitude; and the hybrid,
# jamba-v0.1-52b's smoke config, HYBRID_TRAIN's steps on the card with the
# SSD and MoE launches exact, then card against CPU in fp32 where no top-k
# choice flips.  (jamba at full width does not train on one card: one
# period of 8 layers holds 13.3 B parameters, 213 GB of fp32 parameters,
# gradients and AdamW state.)
SSM_TRAIN_LAUNCHES = {"scan": 2, "scan_grad": 1, "step": 0}
HYBRID_TRAIN = {"steps": 6, "batch": 4, "seq": 64}

# The MoE family's training run: granite-moe-1b-a400m at its full published
# config ([hf:ibm-granite/granite-3.0-1b-a400m-base]: 24 layers, d 1024,
# GQA 16:8, 32 experts top-8 of d_ff 512; 1.33 B parameters, 0.42 B
# active), as olmo-1b's run below: bf16 compute, fp32 parameters and AdamW
# state, remat "full", batch 8 x 2048, TRAIN_STEPS steps.  Per MoE layer
# and step the forward and remat's recompute launch route, dispatch and
# combine twice each, and the backward launches the combine once more (the
# dispatch's cotangent, unit gates), combine_grad and gate_grad once each:
# MOE_TRAIN_LAUNCHES.  Then qwen2-moe-a2.7b at full width cut to 2 of its
# 24 layers (its 14.3 B parameters' fp32 state, 229 GB, does not fit the
# card; 2 layers hold 1.76 B, 28 GB of state), MOE_TRAIN_CUT's steps: the
# one config with shared experts, E = 60 and the k <= 4 kernels.  The
# backward entries are held to their plain versions at both configs'
# training shape (8 x 2048 tokens) and timed there; a full-width MoE layer's
# gradients through the kernels to those through the plain versions, bit
# for bit; and granite-moe's whole model, fp32, 2 layers, on the card
# against the CPU at TRAIN_CPU_RTOL where no top-k choice flips between the
# two.
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
MOE_TRAIN_LAUNCHES = {"route": 2, "dispatch": 2, "combine": 3,
                      "combine_grad": 1, "gate_grad": 1}
MOE_TRAIN_CUT = {"arch": "qwen2-moe-a2.7b", "layers": 2, "steps": 6,
                 "warmup": 6}
#: the backward entries, timed at the training shape, and the entry whose
#: launch each makes (its launch floor)
MOE_BACKWARD = {"dispatch_grad": "combine", "combine_grad": "combine_grad",
                "gate_grad": "gate_grad"}

# The training run: olmo-1b at its full published config (bf16 compute,
# fp32 parameters and AdamW state, remat "full"), batch 8 x 2048 (OLMo's
# context), TRAIN_STEPS steps of launch.train's step function at its
# defaults (lr 3e-3, 20 warmup steps, cosine).  The first loss must lie
# within TRAIN_LOSS0_TOL of ln(vocab): the tied head's random logits have
# a std of about sqrt(2048) * 0.02 = 0.9, which adds about 0.4.  Then:
# 2 microbatches against the whole batch in fp32 at the full config, the
# summed gradients and the loss at TRAIN_GRAD_RTOL of each leaf's largest
# entry, and the reference test's own claim (tests/test_system.py: one
# step's parameters within atol 2e-5 of the single step's) at its own
# config, the qwen2-1.5b smoke config; the card against the CPU in fp32
# (TF32 off) at olmo-1b's full width cut to TRAIN_CPU_CHECK's depth and
# batch: the loss, the grad norm and every gradient at rtol 1e-4 (an
# absolute floor of 1e-4 of each leaf's largest entry: the tolerance of
# tests/test_torch_train.py), then AdamW on those same gradients on both,
# the parameters at the same tolerance.  (A first Adam step divides each
# gradient by its own magnitude, so the parameters of two runs whose
# gradients differ by rounding differ by up to the step size where a
# gradient is near Adam's eps: at full width that showed as 3.3e-5 between
# microbatched and whole steps in chip run 1, so the parameters are held
# on the same gradients and the gradients on their own.)  Last, the
# resilient loop with one injected failure against an uninterrupted run,
# bit for bit, at TRAIN_RESUME's cut (its checkpoints hold the
# 103 M-parameter embedding three times over).
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 20
TRAIN_LOSS0_TOL = 1.0
TRAIN_MICRO_ATOL = 2e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_CPU_CHECK = {"layers": 2, "batch": 2, "seq": 512}
TRAIN_CPU_RTOL = 1e-4
TRAIN_RESUME = {"layers": 2, "batch": 2, "seq": 256, "steps": 6,
                "ckpt_every": 3, "fail_at": 4}
TRAIN_CKPT = ROOT / "build" / "chip_smoke_train"
BF16_FLOP_PER_S = 989e12       # the H100 SXM's dense bf16 peak, data sheet

# Flash attention cases: (B, S, H, Hkv, D).  The serving shape first, then
# tests/test_kernels.py's sweep (B=2), then a length that divides no tile,
# then olmo-1b's and granite-34b's serving shapes (MHA 16:16; MQA 48:1),
# then FLASH_MODELS: whisper-medium's decoder prefill (MHA 16:16 of 64, a
# prompt of 416 that fills no 128-row tile at its end) and internvl2-76b's
# (GQA 64:8 of 128 over 256 vision + 512 text positions), each also timed
# beside SDPA.
FLASH_SLICE = (4, 512, 12, 2, 128)
FLASH_MODELS = {"whisper-medium": (4, 416, 16, 16, 64),
                "internvl2-76b": (4, 768, 64, 8, 128)}
FLASH_SWEEP = [(2, 256, 4, 4, 64), (2, 512, 4, 2, 64), (2, 256, 8, 1, 128),
               (2, 384, 6, 2, 64), (2, 200, 4, 2, 64), (4, 512, 16, 16, 128),
               (4, 512, 48, 1, 128), *FLASH_MODELS.values()]
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
# The models whose bf16 consistency is held to CONSIST_TOL's absolute
# limit (whisper-medium's logits' std is 0.64 on an H100, where
# CONSIST_BF16_STD would give 0.20)
CONSIST_ABS = ("qwen2-1.5b", "whisper-medium")
# The other served models' bf16 limit: qwen2-1.5b's, 0.25 at its logits'
# std of 0.784 (chip runs of PRs 11-23), as a share of each model's std
CONSIST_BF16_STD = 0.32

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
# instance bit for bit (LP_NETBOUND_RTOL 0).  That instance is
# ill-conditioned (its trajectory moves with any change of rounding), so it
# is where the choice entry's order shows: the kernel and the plain version
# both run the program XLA:CPU compiles for the reference's _solve_choice,
# XLA's own exp and log included (csrc/xla_math.cuh, hlp_fo/xla_math.py;
# ROADMAP C6, closed): the card's twins (hlp_fo.transcendental) equal the
# plain version's bit for bit, the kernel is its plain version bit for bit,
# and its λ (frac_objective of x normalised) against the reference's pinned
# best x at 160 / 250 / 300 iterations is held at LP_NETBOUND_REF_RTOL, 0:
# the plain version gives the pin's x bit for bit on the CPU
# (tests/test_torch_xla_math.py).  Before, with the card's expf / logf, it
# lay 3.79e-5 from the plain version and 4.87e-5 from the reference at 300
# iterations (held at 4e-5 and 5e-5).  The two layouts are held to each
# other bit for bit everywhere.
LP_SOLVER = (("potrf", 10), ("getrf", 10), ("potri", 20))
LP_MACHINE = (64, 8)
LP_ITERS = 300
LP_RTOL = 1e-5
LP_NETBOUND_RTOL = 0.0
LP_NETBOUND_PIN = ROOT / "tests" / "torch_hlp_fo_netbound_pin.json"
LP_NETBOUND_ITERS = (160, 250, 300)
LP_NETBOUND_REF_RTOL = 0.0
# The moldable instance (20 tasks, 8 choices, 3 pred slots; ROADMAP C6,
# closed in its second half): the kernel starts from the z0 of the
# reference's own program (pinned: XLA folds 0.01 * sqrt(2) into one
# constant) and is its plain version bit for bit (LP_MOLDABLE_RTOL 0); its
# best x at 160 / 250 / 300 iterations is the reference's pinned x bit for
# bit, as netbound's is.
LP_MOLDABLE_RTOL = 0.0
LP_MOLDABLE_PIN = ROOT / "tests" / "torch_hlp_fo_moldable_pin.json"
# The hybrid entry keeps the card's expf / logf: its best x and λ on the
# three instances above are pinned (an H100 run before the choice entry
# took XLA's transcendentals), and held bit for bit.
LP_HYBRID_PIN = ROOT / "tests" / "torch_hlp_fo_hybrid_pin.json"

# The paper phase: the reference's outputs of its §6 experiments on the
# default grid (34 instances x 16 configurations) and its placement plans,
# written by tests/test_torch_paper.py::write_pin
PAPER_PIN = ROOT / "tests" / "torch_paper_pin.json"
PAPER_TARGETS = ("offline2", "offline3", "online")
PAPER_RUNS = 544
# the offline experiments' CSV and the columns that read the LP's allocation
# (the rest read its optimum or no LP): where the host's HiGHS returns
# another optimal vertex than the reference's, only these may differ
PAPER_LP_ROWS = {"offline2": ("offline_2type.csv", ("hlp_est", "hlp_ols")),
                 "offline3": ("offline_3type.csv", ("qhlp_est", "qhlp_ols"))}
# the kernels target's cases (launch/kernel_bench.py): (max, +) exact, flash
# attention in float32 (causal) within FLASH_TOL's atol = rtol
PAPER_KERNEL_TOL = {"kernels/maxplus_256x256x256": 0.0,
                    "kernels/flash_attn_s512": FLASH_TOL["float32"]}
# a placement plan on another optimal LP vertex: its LP* against the pin's,
# which another HiGHS build rounds differently (1 ulp on the H100's host)
PLAN_LP_RTOL = 1e-12

# The streams phase: the reference's outputs of its open-system grid (the
# default and the full one) and of a Chameleon stream at size, each written
# from a fresh process (tests/test_torch_streams_campaign.py::write_pin),
# held with ==.  The stream's configuration is the pin's own.
STREAMS_PIN = ROOT / "tests" / "torch_streams_pin.json"
STREAMS_KEYS = ("mean_slowdown", "sitl_vs_erls_bursty", "policies",
                "processes", "runs", "jobs", "compiles")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


#: each phase's wall seconds, in the order the phases ran
PHASE_S: dict[str, float] = {}


def phase(name: str, fn, *args):
    """``fn(*args)``, its wall seconds kept in PHASE_S and printed on a line
    of their own, ``phase NAME: S s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return out


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

    shapes = {"serving": FLASH_SLICE, "long": FLASH_LONG, **FLASH_MODELS}
    times = {(dt, shape): flash_times(torch, case, getattr(torch, dt),
                                      plain=shape != "long")
             for dt in ("bfloat16", "float32")
             for shape, case in shapes.items()}

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
                "bound_by": long["bound_by"], "tflops": long["tflops"]},
            "models": {arch: {
                "shape": list(case), "ms": times[dt, arch]["kernel"],
                "eager_ms": times[dt, arch]["kernel_eager"],
                "plain_ms": times[dt, arch]["plain"],
                "library_ms": times[dt, arch]["sdpa"],
                "library_eager_ms": times[dt, arch]["sdpa_eager"],
                "bound_ms": times[dt, arch]["bound"],
                "bound_by": times[dt, arch]["bound_by"]}
                for arch, case in FLASH_MODELS.items()}}

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
    exact forward, the reverse walk) and 50 a task entry (its time, soft
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


def netbound_witness(torch, prob, card, kx, klam, rx, rv) -> dict:
    """ROADMAP C6 on netbound seed 300, closed: the choice entry takes
    XLA:CPU's own exp and log (``csrc/xla_math.cuh``), so the card's twins
    (``hlp_fo.transcendental``) equal the plain version's
    (``xla_math.xla_exp_f32`` / ``xla_log_f32``) bit for bit on a sweep of
    2^22 random float32 bit patterns and the solve's ranges; the kernel's
    best x ``kx`` and λ ``klam`` equal the plain version's ``rx`` / ``rv``
    bit for bit at :data:`LP_ITERS`; and at each of
    :data:`LP_NETBOUND_ITERS` the kernel's best x is the reference's pinned
    x bit for bit, and its λ (``frac_objective`` of x normalised) lies
    within :data:`LP_NETBOUND_REF_RTOL` of the λ of the
    reference's pinned best x, both taken on this host (the pin's own λ
    was taken on another, whose float64 objective may differ in the ninth
    digit), its allocation the reference's.  ``card``
    is (DAG, z0, inputs) on the card."""
    import numpy as np
    from repro_torch.core.allocation import frac_objective
    from repro_torch.kernels.hlp_fo import hlp_fo as HF
    from repro_torch.kernels.hlp_fo.xla_math import xla_exp_f32, xla_log_f32

    def lam(x):
        x = np.asarray(x, np.float64)
        return frac_objective(prob, x / x.sum(axis=1, keepdims=True))
    bits = np.random.default_rng(24).integers(0, 2 ** 32, 2 ** 22,
                                              dtype=np.uint64)
    sweep = torch.from_numpy(np.concatenate([
        bits.astype(np.uint32).view(np.float32),
        np.linspace(-90, 90, 2 ** 20, dtype=np.float32),
        np.geomspace(1e-30, 1e4, 2 ** 20).astype(np.float32)]))
    twins_equal = {}
    for op, twin in (("exp", xla_exp_f32), ("log", xla_log_f32)):
        got = HF.transcendental(sweep.to(CARD), op).cpu()
        want = twin(sweep)
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            got.isnan() & want.isnan())
        twins_equal[op] = bool(same.all())
        check(twins_equal[op], f"lp netbound_s300: the card's {op} twin "
              f"differs from the plain version's at {int((~same).sum())} of "
              f"{sweep.numel()} inputs")
    kernel_is_plain = (np.array_equal(np.asarray(kx, np.float32).view(
        np.int32), np.asarray(rx, np.float32).view(np.int32)) and klam == rv)
    check(kernel_is_plain, f"lp netbound_s300: the kernel ({klam!r}) is not "
          f"its plain version ({rv!r}) bit for bit")
    (dg, zg, tg) = card
    pin = json.loads(LP_NETBOUND_PIN.read_text())
    gaps, pin_bits = {}, {}
    for iters in LP_NETBOUND_ITERS:
        x, _ = HF.launch_choice(dg, zg, *tg, iters=iters, use_comm=True)
        x = x.cpu().numpy()
        ref = pin[str(iters)]
        gaps[iters] = abs(lam(x) / lam(ref["x"]) - 1)
        pin_bits[iters] = bool(np.array_equal(
            x.view(np.int32), np.asarray(ref["x"], np.float32).view(np.int32)))
        check(pin_bits[iters], f"lp netbound_s300: the kernel's best x at "
              f"{iters} iterations is not the reference's pinned x bit for "
              "bit")
        check(gaps[iters] <= LP_NETBOUND_REF_RTOL, f"lp netbound_s300: the "
              f"kernel's λ lies {gaps[iters]:.3e} from the reference's at "
              f"{iters} iterations (limit {LP_NETBOUND_REF_RTOL})")
        check(np.array_equal(x.argmax(1), np.asarray(ref["x"]).argmax(1)),
              f"lp netbound_s300: the kernel's allocation at {iters} "
              "iterations is not the reference's")
    return {"twins_bit_equal": twins_equal,
            "kernel_is_plain_bit_for_bit": kernel_is_plain,
            "ref_gap": gaps, "ref_x_bit_equal": pin_bits}


def lp_phase(torch) -> dict:
    """The first-order LP on the card.  The main path: ``solve_hlp_jax`` on
    the solver target's instances (:data:`LP_SOLVER`), the counter 0 just
    before and, just after, one launch a solve (``hlp_fo_sm90.cu``).  Then
    each instance through the kernel's bare launch in both layouts and
    through the plain version on CPU copies from the same starting logits:
    the layouts' best x and λ bit for bit, the kernel against the plain
    version (λ at :data:`LP_RTOL`, threshold allocations identical, the
    main path's allocation the same), timed from CUDA events twice beside
    its chain floor (2 level steps a level a step, the probe's ns each),
    its bound, its phase split, the plain version's host time and HiGHS's
    (``solve_hlp``).  Then the choice entry on a netbound and a moldable
    instance (the netbound one also through :func:`netbound_witness`),
    and one campaign-sized solve (the full grid's largest ``hlp_jax_ols``
    graph, one warp), the same way."""
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
    hybrid_pin = json.loads(LP_HYBRID_PIN.read_text())["instances"]
    HF.reset_launch_count()
    t0 = time.perf_counter()
    sols = {name: solve_hlp_jax(g, m, k, iters=LP_ITERS)
            for name, g in graphs.items()}
    path_s = time.perf_counter() - t0
    counts = HF.launch_count()
    check(counts == len(graphs), f"the first-order LP's main "
          f"path launched {counts} for {len(graphs)} solves")
    probes: dict[int, float] = {}

    def probe(threads: int) -> float:
        if threads not in probes:
            probes[threads] = lp_probe_ns(torch, threads)
            print(f"lp chain probe: {probes[threads]:.2f} ns a level step at "
                  f"{threads} threads")
        return probes[threads]

    def both(d, run, name, c=1, q=0, comm=False) -> dict:
        """The kernel's result in both layouts (bit-equal), its times,
        chain floor and phase split; ``run(layout, cycles)`` launches."""
        fits = HF.layout_for(d.pred.shape[0], d.levels, c, q, comm,
                             e=int(d.succ_task.shape[0]))
        (sx, sv), (gx, gv) = (run(layout, None) for layout in
                              (fits, "global"))
        same = (torch.equal(sx.view(torch.int32), gx.view(torch.int32))
                and torch.equal(sv.view(torch.int32), gv.view(torch.int32)))
        check(same, f"lp {name}: the kernel's best x or λ in the {fits} "
              f"layout ({float(sv)!r}) differs from the global one's "
              f"({float(gv)!r})")
        threads = HF.threads_for(d.max_width)
        times = [time_ms(lambda: run(None, None), iters=5, warmup=1)
                 for _ in range(2)]
        bound, bound_by = lp_bound_ms(d, LP_ITERS, c, q, comm)
        cycles = torch.zeros(len(HF.PHASES), dtype=torch.int64,
                             device=CARD)
        _, cv = run(None, cycles)
        check(float(cv) == float(sv), f"lp {name}: the split launch "
              "changed λ")
        cyc = cycles.cpu().tolist()
        chain = 2 * d.levels * LP_ITERS      # two level walks a step
        return {"levels": d.levels, "width": d.max_width, "threads": threads,
                "edges": int(d.succ_task.shape[0]), "bit_equal": same,
                "probe_ns": probe(threads), "bound_ms": bound,
                "bound_by": bound_by, "x": sx.cpu().numpy(),
                "lam": float(sv), "ms": sum(times) / 2, "ms_turns": times,
                "chain_steps": chain,
                "chain_floor_ms": chain * probes[threads] * 1e-6,
                "split": {ph: v / sum(cyc) for ph, v in
                          zip(HF.PHASES, cyc)}}

    def show(row) -> str:
        return (f"{row['ms']:.3f} ms a solve (runs "
                + ", ".join(f"{t:.3f}" for t in row["ms_turns"])
                + f"), floor {row['chain_floor_ms']:.3f} ms, split "
                + ", ".join(f"{ph} {v:.3f}" for ph, v in row["split"].items()))

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
        row = both(dg, lambda lay, cyc: HF.launch_hybrid(
            dg, zg, m=m, k=k, iters=LP_ITERS, cycles=cyc, layout=lay), name)
        kx = row.pop("x")
        rel = plain_check(name, kx, row["lam"], rx, rv, LP_RTOL, threshold)
        pinned = hybrid_pin[name]
        row["pinned_bits"] = (hashlib.sha256(np.asarray(kx, np.float32)
                                             .tobytes()).hexdigest()
                              == pinned["x_sha256"]
                              and row["lam"] == pinned["lam"])
        check(row["pinned_bits"], f"lp {name}: the hybrid entry's best x or "
              f"λ moved from the pinned bits ({LP_HYBRID_PIN.name})")
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
              f"s; λ rel {rel:.2e}, gap {row['gap_pct']:.3f}%; layouts "
              "bit-equal")

    nb = netbound_scenario(seed=300)
    mo = moldable_suite(seed=400, num=1, ccr=2.0)[0]
    choice_cases = [("netbound_s300", nb.graph, nb.counts, True,
                     LP_NETBOUND_RTOL),
                    ("moldable_s400_ccr2", mo.graph, mo.machine, False,
                     LP_MOLDABLE_RTOL)]
    moldable_pin = json.loads(LP_MOLDABLE_PIN.read_text())["comm"]
    crows = []
    for name, g, machine, rigid, rtol in choice_cases:
        prob = AllocationProblem.build(g, machine, comm_aware=True,
                                       rigid=rigid)
        p_dev = np.where(prob.finite, prob.p_choice, 1e12)
        ins = [p_dev, p_dev * prob.width_of.astype(np.float64),
               prob.type_mask, 1.0 / np.asarray(prob.counts, np.float64)]
        z0 = (np.float32(0.01) * reference_normal(0, p_dev.shape)
              if rigid else np.asarray(moldable_pin["z0"], np.float32))
        res = {}
        for dev in ("cpu", CARD):
            d = PaddedDag.from_graph(g, dev)
            t = [torch.tensor(np.asarray(a, np.float32), device=dev)
                 for a in ins]
            zt = torch.tensor(z0, device=dev)
            before = HF.launch_count()
            t0 = time.perf_counter()
            x, v = HF.choice(d, zt, *t, iters=LP_ITERS,
                             use_comm=prob.comm_aware)
            res[dev] = (x.cpu().numpy(), float(v), time.perf_counter() - t0,
                        d, zt, t)
            after = HF.launch_count()
            check(after - before == int(dev == CARD), f"lp {name}: "
                  f"launches {before} -> {after} on "
                  f"{dev} for one solve")
        (rx, rv, plain_s, *_), (_, _, _, dg, zg, tg) = res["cpu"], res[CARD]
        c, q = p_dev.shape[1], prob.type_mask.shape[0]
        row = both(dg, lambda lay, cyc: HF.launch_choice(
            dg, zg, *tg, iters=LP_ITERS, use_comm=prob.comm_aware,
            cycles=cyc, layout=lay), name, c, q, prob.comm_aware)
        kx = row.pop("x")
        check(np.array_equal(kx, res[CARD][0]), f"lp {name}: the entry's "
              "solve and the bare launch differ")
        rel = plain_check(name, kx, row["lam"], rx, rv, rtol, argmax)
        row.update({"name": name, "n": g.n, "choices": c,
                    "comm": prob.comm_aware, "plain_lam": rv, "rel": rel,
                    "rtol": rtol, "max_abs_err": float(np.abs(kx - rx).max()),
                    "plain_ms": plain_s * 1e3})
        crows.append(row)
        row["bit_equal_to_plain"] = bool(np.array_equal(
            kx.view(np.int32), np.asarray(rx, np.float32).view(np.int32)))
        check(rtol > 0 or row["bit_equal_to_plain"], f"lp {name}: the "
              "kernel is not its plain version bit for bit")
        if name == "netbound_s300":
            row.update(netbound_witness(torch, prob, (dg, zg, tg), kx,
                                        row["lam"], rx, rv))
        else:
            row["ref_x_bit_equal"] = {}
            for iters in LP_NETBOUND_ITERS:
                x, _ = HF.launch_choice(dg, zg, *tg, iters=iters,
                                        use_comm=prob.comm_aware)
                want = np.asarray(moldable_pin[str(iters)]["x"], np.float32)
                row["ref_x_bit_equal"][iters] = bool(np.array_equal(
                    x.cpu().numpy().view(np.int32), want.view(np.int32)))
                check(row["ref_x_bit_equal"][iters], f"lp {name}: the "
                      f"kernel's best x at {iters} iterations is not the "
                      "reference's pinned x bit for bit")
        print(f"lp choice {name} (n={g.n}, C={c}, comm {prob.comm_aware}, "
              f"{row['threads']} threads): {show(row)}; plain "
              f"{row['plain_ms']:.1f} ms (host); λ rel {rel:.2e} (limit "
              f"{rtol}); layouts bit-equal"
              + f"; bit-equal to the plain version: "
              f"{row['bit_equal_to_plain']}"
              + (f"; the card's XLA twins bit-equal to the plain version's; "
                 f"λ rel to the reference "
                 + ", ".join(f"{k} it {v:.3e} (x bit-equal "
                             f"{row['ref_x_bit_equal'][k]})"
                             for k, v in row["ref_gap"].items())
                 if "ref_gap" in row else
                 f"; the reference's pinned best x bit for bit at "
                 f"{row['ref_x_bit_equal']}"))

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
    row = both(dg, lambda lay, cyc: HF.launch_hybrid(
        dg, zg, m=cm, k=ck, iters=LP_ITERS, cycles=cyc, layout=lay),
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
          f"λ rel {rel:.2e}; layouts bit-equal")
    return {"launches": counts, "path_s": path_s, "hybrid": rows,
            "choice": crows, "campaign_solve": row}


def _entry_run(args: list[str], name: str, keep_rollouts: bool = False
               ) -> tuple[Path, float]:
    """``python -m repro_torch.launch.campaign ARGS`` on the card in a fresh
    process, its trajectory under ``build/campaign/``; it must exit 0.
    With ``keep_rollouts`` the entry runs through :func:`streams_entry_child`
    and the digest of its rollouts joins the trajectory as ``rollouts``.
    Returns the trajectory's path and the wall."""
    out_dir = ROOT / "build" / "campaign"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"BENCH_{name}.json"
    path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    entry = ([str(ROOT / "chip_smoke.py"), "--streams-entry"] if keep_rollouts
             else ["-m", "repro_torch.launch.campaign"])
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *entry, *args, "--bench-json",
                          str(path)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    wall = time.perf_counter() - t0
    rollouts = None
    for line in run.stdout.splitlines():
        if line.startswith("#"):
            print(f"{name} | {line}")
        if line.startswith("ROLLOUTS "):
            rollouts = json.loads(line[len("ROLLOUTS "):])
    check(run.returncode == 0, f"the campaign entry {args} exited "
          f"{run.returncode}:\n{run.stderr[-4000:]}")
    if keep_rollouts:
        check(rollouts is not None, f"{name}: no ROLLOUTS line")
        traj = json.loads(path.read_text())
        traj["rollouts"] = rollouts
        path.write_text(json.dumps(traj))
    return path, wall


def streams_entry_child(args: list[str]) -> int:
    """``python3 chip_smoke.py --streams-entry ARGS...``: the port's campaign
    entry (``repro_torch.launch.campaign.main(ARGS)``) in this fresh
    process, every rollout's makespans kept from ``sweep_suite_makespans``;
    then one ``ROLLOUTS {...}`` line, their ``rollout_digest``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch import campaign as TC
    from repro_torch.streams import policy as SP

    sweeps = []
    sweep = SP.sweep_suite_makespans

    def kept(*a, **kw):
        out = sweep(*a, **kw)
        sweeps.append(out)
        return out
    SP.sweep_suite_makespans = kept
    rc = TC.main(args)
    print("ROLLOUTS " + json.dumps(TC.rollout_digest(sweeps)), flush=True)
    return rc


def _campaign_run(args: list[str], pin_path: Path, name: str
                  ) -> tuple[dict, dict, float, float, int]:
    """:func:`_entry_run`, then ``benchmarks/render_tables --check-bench``
    against ``pin_path``; it must exit 0, every pinned metric must lie
    within ``CAMPAIGN_RTOL`` of its pin and every pinned count equal it.
    Returns the trajectory's benches, the pins, the wall, the worst
    relative difference and the number of counts held."""
    path, wall = _entry_run(args, name)
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
    check(full["hlp_fo"] == solves, f"campaign full: {full['hlp_fo']} "
          f"first-order LP launches for {solves} hlp_jax_ols solves")
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


def paper_rows(target: str, pin: dict
               ) -> tuple[dict, dict, list[str], str]:
    """An offline experiment's CSV rows (``lp_seconds`` taken out) against
    the pin's.  A row may differ only in the columns that read the LP's
    allocation, and only where the host's HiGHS returns another optimal
    vertex: then the port's own LP must reach the pin's LP* exactly with
    another allocation, and the port's list schedulers on the reference's
    allocation (kept in the pin) must give the pin's makespans exactly.
    Returns the dict of the port's rows, the dict of the rows so
    reconciled (``offline*_summary``, the experiment's own aggregation),
    the rows that took another vertex and the SHA-256 of the reconciled
    CSV (``lp_seconds`` taken out, as ``csv_digest`` hashes it)."""
    import base64
    import csv
    import hashlib
    import io
    import zlib

    import numpy as np
    from repro_torch.core.hlp import solve_hlp, solve_qhlp
    from repro_torch.core.listsched import hlp_est, hlp_ols
    from repro_torch.launch import campaign as TC

    name, lp_cols = PAPER_LP_ROWS[target]
    with open(TC.ART / name, newline="") as f:
        table = list(csv.reader(f))
    keep = [i for i, h in enumerate(table[0]) if h != "lp_seconds"]
    head = [table[0][i] for i in keep]
    rows = [[row[i] for i in keep] for row in table[1:]]
    want_rows = pin["rows"]
    check(len(rows) == len(want_rows) == PAPER_RUNS, f"paper {target}: "
          f"{len(rows)} rows, the pin {len(want_rows)}")
    types = 2 if target == "offline2" else 3
    graphs = {label: g for label, _, g in TC.instances(False, types)}
    per = PAPER_RUNS // len(graphs)
    sizes = [g.n for g in graphs.values() for _ in range(per)]
    allocs = np.split(np.frombuffer(zlib.decompress(base64.b64decode(
        pin["alloc"])), np.int8), np.cumsum(sizes)[:-1])
    lp = head.index("lp_star")
    cols = [head.index(c) for c in lp_cols]
    vertex, reconciled = [], list(rows)
    for i, (row, want) in enumerate(zip(rows, want_rows)):
        if row == want:
            continue
        what = f"paper {target} row {i} ({want[:lp]})"
        differ = sorted(h for h, a, b in zip(head, row, want) if a != b)
        check(set(differ) <= set(lp_cols), f"{what}: {differ} differ from "
              f"the pin: {row} against {want}")
        g, counts = graphs[want[0]], [int(v) for v in want[2:lp]]
        alloc = allocs[i].astype(np.int32)
        sol = solve_hlp(g, *counts) if types == 2 else solve_qhlp(g, counts)
        check(sol.lp_value == float(want[lp])
              and not np.array_equal(sol.alloc, alloc), f"{what}: the "
              f"port's LP* {sol.lp_value!r} (the pin's {want[lp]}) or its "
              "allocation is the reference's, yet the row differs")
        got = [hlp_est(g, counts, alloc).makespan,
               hlp_ols(g, counts, alloc).makespan]
        check(got == [float(want[c]) for c in cols], f"{what}: on the "
              f"reference's allocation the port's schedules give {got}, "
              f"the pin {[want[c] for c in cols]}")
        vertex.append(f"{want[0]} {counts}")
        reconciled[i] = want

    def summary(rs):
        fn = TC.offline2_summary if types == 2 else TC.offline3_summary
        return json.loads(json.dumps(fn(
            [[v if c < 2 else float(v) for c, v in enumerate(r)]
             for r in rs])))
    buf = io.StringIO()
    csv.writer(buf).writerows([head] + reconciled)
    return (summary(rows), summary(reconciled), vertex,
            hashlib.sha256(buf.getvalue().encode()).hexdigest())


def paper_experiments(got: dict, pin: dict) -> dict:
    """Each experiment of ``got`` (a trajectory's benches) against the
    pin: its dict, runs, CSV digests, lines and no kernel launch (see
    :func:`paper_phase`); returns each one's wall, runs and the count of
    rows that took another LP vertex."""
    from repro_torch.launch.campaign import (ART, csv_digest, offline2_lines,
                                             offline3_lines, without_us)

    lines_of = {"offline2": offline2_lines, "offline3": offline3_lines}
    summary = {}
    for target in PAPER_TARGETS:
        b, p = got[target], pin[target]
        missing = sorted(set(p["result"]) - set(b))
        check(not missing, f"paper {target}: the trajectory lacks {missing}")
        mine = {key: b[key] for key in p["result"]}
        vertex, digests = [], {}
        if target in PAPER_LP_ROWS:
            own, reconciled, vertex, digest = paper_rows(target, p)
            digests[PAPER_LP_ROWS[target][0]] = digest
            check(own == mine, f"paper {target}: the trajectory's dict "
                  f"{mine} is not its rows' {own}")
            mine = reconciled
        for key, want in p["result"].items():
            check(mine[key] == want, f"paper {target} {key}: "
                  f"{mine[key]!r} against the pin {want!r}")
        check(b["runs"] == PAPER_RUNS, f"paper {target}: {b['runs']} runs")
        for name, want in p["csv"].items():
            rows, digest = csv_digest(ART / name)
            # a CSV with rows on another vertex: the reconciled one's
            check(rows == want["rows"] and {"rows": rows, "sha256": digest}
                  == b["csv"][name]
                  and digests.get(name, digest) == want["sha256"],
                  f"paper {target} {name}: {rows} rows, {digest} against the "
                  f"pin {want} (trajectory {b['csv'][name]})")
        if vertex:
            print(f"paper {target}: {len(vertex)} of {PAPER_RUNS} rows took "
                  f"another optimal LP vertex on this host's HiGHS "
                  f"({'; '.join(vertex)}); each reproduced from the "
                  "reference's allocation")
        check(without_us(b["lines"]) == p["lines"] or (vertex and without_us(
            lines_of[target](mine, 0)) == p["lines"]), f"paper {target}: "
              f"lines {b['lines']} against the pin {p['lines']}")
        check(not any(b["launches"].values()), f"paper {target}: kernel "
              f"launches {b['launches']}")
        summary[target] = {"wall_s": b["wall_s"], "runs": b["runs"],
                           "other_vertex_rows": len(vertex)}
        print(f"paper {target}: wall {b['wall_s']:.3f} s, {b['runs']} runs, "
              f"dict ({len(p['result'])} keys), {len(p['csv'])} CSV digest(s) "
              f"and {len(p['lines'])} lines equal to the pin")
    return summary


def placement_plans(cases: list[dict]) -> int:
    """``plan_pipeline`` on each pinned case (a full published config, its
    pods, seq, batch and streams): its allocation, makespan and LP* equal
    to the pin's, or, on another optimal LP vertex of this host's HiGHS,
    LP* within :data:`PLAN_LP_RTOL`, the plan within the Q(Q+1) bound and
    OLS on the pin's allocation giving the pin's makespan exactly.
    Returns the plans on another vertex."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.listsched import hlp_ols
    from repro_torch.core.placement import PodType, layer_dag, plan_pipeline

    vertex = 0
    for case in cases:
        pods = [PodType(*p) for p in case["pods"]]
        cfg, shape = get_config(case["arch"]), {
            "seq": case["seq"], "batch": case["batch"],
            "streams": case["streams"]}
        plan = plan_pipeline(cfg, pods, **shape)
        what = (f"placement {case['arch']} on {len(pods)} pods, "
                f"{case['streams']} stream(s)")
        if (plan.assignment.tolist() == case["assignment"]
                and plan.makespan == case["makespan"]
                and plan.lp_bound == case["lp_bound"]):
            print(f"{what}: {len(case['assignment'])} tasks, makespan "
                  f"{plan.makespan:.6g} s, LP* {plan.lp_bound:.6g} s, equal "
                  "to the pin")
            continue
        # another optimal vertex of the LP (see paper_rows): the optimum
        # to HiGHS's own rounding, a valid plan within the Q(Q+1) bound,
        # and on the reference's allocation the reference's OLS makespan
        g = layer_dag(cfg, pods, **shape)
        counts = [p.count for p in pods]
        ref = hlp_ols(g, counts, np.asarray(case["assignment"], np.int32))
        ref.validate(g, counts)
        q = len(pods)
        check(plan.assignment.tolist() != case["assignment"]
              and abs(plan.lp_bound / case["lp_bound"] - 1) <= PLAN_LP_RTOL
              and plan.makespan <= q * (q + 1) * plan.lp_bound
              and ref.makespan == case["makespan"], f"{what}: makespan "
              f"{plan.makespan!r}, LP* {plan.lp_bound!r} against the pin's "
              f"{case['makespan']!r}, {case['lp_bound']!r}; OLS on the "
              f"pin's allocation {ref.makespan!r}")
        vertex += 1
        print(f"{what}: another optimal LP vertex on this host's HiGHS "
              f"(LP* {plan.lp_bound!r}, the pin's {case['lp_bound']!r}; "
              f"makespan {plan.makespan:.6g} s, the pin's "
              f"{case['makespan']:.6g}); on the pin's allocation OLS gives "
              "the pin's makespan exactly")
    return vertex


def paper_phase() -> dict:
    """The paper's §6 experiments and the ``kernels`` target through the
    port's campaign entry on the card in a fresh process (its counters from
    0 there), held to :data:`PAPER_PIN` (the reference's outputs on the
    default grid): each experiment's dict with ``==`` on every float,
    :data:`PAPER_RUNS` runs, its CSVs' rows and digests (``lp_seconds``
    taken out) and its lines (µs taken out); the ``kernels`` target must
    launch the (max, +) and flash attention kernels, each case's output
    equal to its plain version's (maxplus) or within :data:`FLASH_TOL`
    (flash, float32) on the same inputs.  Then the placement
    planner on the pin's full published configs and platforms, each plan
    equal to the pin's.

    Where the host's HiGHS (scipy) is another version than the one that
    wrote the pin, a degenerate LP may return another optimal vertex: LP*
    is the same, the allocation and the HLP schedules' makespans are not.
    The offline experiments' rows are then held by :func:`paper_rows`, and
    their dicts (and lines) and CSV digests from the reconciled rows to the
    pin with ``==``; the rows that took another vertex are printed and
    counted.  On the host that wrote the pin, the port's own outputs equal
    it with no row reconciled
    (``tests/test_torch_paper.py::test_default_grid_equals_the_pin``)."""
    pin = json.loads(PAPER_PIN.read_text())
    path, wall = _entry_run(["--only", ",".join(PAPER_TARGETS + ("kernels",))],
                            "paper")
    got = json.loads(path.read_text())["benches"]
    summary = {"wall_s": wall, **paper_experiments(got, pin)}
    k = got["kernels"]
    check(k["launches"]["maxplus"] > 0 and k["launches"]["flash"] > 0,
          f"paper kernels: launches {k['launches']}")
    check(set(k["cases"]) == set(k["us_per_call"]) == set(PAPER_KERNEL_TOL),
          f"paper kernels: cases {sorted(k['cases'])}")
    for name, c in k["cases"].items():
        tol = PAPER_KERNEL_TOL[name]
        rule = f"atol = rtol = {tol}" if tol else "exact equality required"
        print(f"paper {name} {c['shape']}: kernel {k['us_per_call'][name]} "
              f"us, plain {c['ref_us']:.0f} us, max|err| "
              f"{c['max_abs_err']:.3e}, err_vs_plain {c['err_vs_plain']:.3e} "
              f"({rule})")
        check(c["err_vs_plain"] <= tol and (tol or c["max_abs_err"] == 0),
              f"paper {name}: the kernel disagrees with its plain version "
              f"at {c['shape']}: {c}")
    summary["kernels"] = {"wall_s": k["wall_s"], "launches": k["launches"],
                          "us_per_call": k["us_per_call"],
                          "cases": k["cases"]}
    print(f"paper kernels: wall {k['wall_s']:.3f} s, launches "
          f"{k['launches']}, kernels.us_per_call {k['us_per_call']}")

    t0 = time.perf_counter()
    summary["placement_other_vertex"] = placement_plans(pin["placement"])
    summary["placement_s"] = time.perf_counter() - t0
    summary["placement_plans"] = len(pin["placement"])
    print(f"paper: entry {wall:.1f} s in its own process (offline2 "
          f"{summary['offline2']['wall_s']:.1f} s, offline3 "
          f"{summary['offline3']['wall_s']:.1f} s, online "
          f"{summary['online']['wall_s']:.1f} s, kernels "
          f"{k['wall_s']:.1f} s); {len(pin['placement'])} placement plans in "
          f"{summary['placement_s']:.1f} s")
    return summary


def _streams_grid(args: list[str], name: str, want: dict) -> dict:
    """The ``streams`` target through the port's campaign entry on the card
    in a fresh process, held to ``want`` (the pin's grid) with ``==``: its
    dict, counts, CSV digest and lines (µs aside), and the count, shapes
    and digest of its rollouts' makespans (the replay kernel bit for bit
    at the grid's shapes); its replay launches above 0 and equal to the
    replay chunks it dispatched."""
    from repro_torch.launch.campaign import without_us
    path, wall = _entry_run(args, name, keep_rollouts=True)
    traj = json.loads(path.read_text())
    got = traj["benches"]["streams"]
    for key, value in traj["rollouts"].items():
        check(value == want[key], f"{name}: {key} {value!r}, pinned "
              f"{want[key]!r}")
    for key in STREAMS_KEYS:
        check(got[key] == want[key], f"{name}: {key} {got[key]!r}, pinned "
              f"{want[key]!r}")
    check(got["csv"]["streams_campaign.csv"] == want["csv"],
          f"{name}: CSV {got['csv']} against the pin's {want['csv']}")
    check(without_us(got["lines"]) == want["lines"], f"{name}: lines "
          f"{got['lines']} against the pin's {want['lines']}")
    launches = got["launches"]
    check(0 < launches["replay"] == launches["replay_chunks"],
          f"{name}: replay launches {launches}")
    return {"wall_s": wall, "target_wall_s": got["wall_s"],
            "runs": got["runs"], "jobs": got["jobs"],
            "compiles": got["compiles"], "launches": launches["replay"],
            "rollouts": traj["rollouts"]["rollouts"]}


def chameleon_child(device: str, policies: list[str]) -> int:
    """``python3 chip_smoke.py --chameleon-stream DEVICE POLICY...``: the
    pin's Chameleon stream under each policy in turn in this fresh process,
    its rollouts on DEVICE.  Each run with the replay counter at 0 just
    before and the obs registry on (the ``stream.rollout`` spans); on the
    card every replay launch is timed by CUDA events around it, and every
    arrival's rollout makespans (each candidate at each seed, from
    ``sweep_suite_makespans``) are kept.  Prints one ``STREAM {...}`` line a
    policy: the run's summary (``repro_torch.launch.campaign.stream_summary``),
    the digest of its rollout makespans (``rollout_digest``), its new replay
    shapes, decisions, walls, launches, chunks and kernel ms."""
    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch import obs
    from repro_torch.kernels.replay import replay as R
    from repro_torch.launch.campaign import rollout_digest, stream_summary
    from repro_torch.streams import policy as SP
    from repro_torch.obs import registry
    from repro_torch.sim import NoiseModel
    from repro_torch.sim.batch import trace_count
    from repro_torch.sim.engine import Machine
    from repro_torch.streams import (SimInTheLoop, chameleon_stream,
                                     make_policy, run_stream)

    cfg = json.loads(STREAMS_PIN.read_text())["chameleon"]["config"]
    pairs = []
    if device == CARD:
        launch = R.launch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = launch(*args, **kw)
            end.record()
            pairs.append((start, end))
            return out
        R.launch = timed
    sweeps = []
    sweep = SP.sweep_suite_makespans

    def kept(*args, **kw):
        out = sweep(*args, **kw)
        sweeps.append(out)
        return out
    SP.sweep_suite_makespans = kept
    obs.enable()
    for name in policies:
        noise = NoiseModel("lognormal", cfg["noise"])
        pol = (SimInTheLoop(rollout_seeds=range(cfg["rollout_seeds"]),
                            rollout_noise=noise, device=device)
               if name == "sim_in_the_loop"
               else make_policy(name, device=device))
        src = chameleon_stream(
            tuple(cfg["apps"]), num_jobs=cfg["num_jobs"],
            nb_blocks=tuple(cfg["nb_blocks"]), block_size=cfg["block_size"],
            num_tenants=cfg["num_tenants"], rate=cfg["rate"],
            seed=cfg["seed"])
        obs.reset()
        pairs.clear()
        sweeps.clear()
        traces = trace_count("bucket")
        chunks = registry.counter_value("sim.replay.chunks")
        R.reset_launch_count()
        t0 = time.perf_counter()
        res = run_stream(src, Machine.hybrid(*cfg["machine"]), pol,
                         noise=noise, seed=cfg["seed"])
        wall = time.perf_counter() - t0
        launches = R.launch_count()
        if device == CARD:
            torch.cuda.synchronize()
        out = stream_summary(res)
        out.update(rollout_digest(sweeps))
        out.update(
            traces=trace_count("bucket") - traces,
            decisions=[list(d) for d in getattr(pol, "decisions", [])],
            wall_s=wall, launches=launches,
            chunks=registry.counter_value("sim.replay.chunks") - chunks,
            rollout_s=sum(e["dur"] for e in registry.wall_events()
                          if e["name"] == "stream.rollout"),
            kernel_ms=sum(a.elapsed_time(b) for a, b in pairs))
        print("STREAM " + json.dumps({"policy": name, "device": device,
                                      **out}), flush=True)
    return 0


def _chameleon_run(device: str, policies: list[str]) -> dict:
    """:func:`chameleon_child` in a fresh process; each policy's output
    held to the pin's run with ``==`` (summary, task-record digest,
    decisions, new replay shapes, and the count, shapes and digest of its
    rollout makespans: the replay bit for bit at the stream's shapes, its
    floors and envelope buckets).  Returns the runs by policy."""
    pin = json.loads(STREAMS_PIN.read_text())["chameleon"]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--chameleon-stream", device, *policies],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    check(run.returncode == 0, f"the Chameleon stream on {device} exited "
          f"{run.returncode}:\n{run.stderr[-4000:]}")
    runs = {}
    for line in run.stdout.splitlines():
        if line.startswith("STREAM "):
            got = json.loads(line[len("STREAM "):])
            runs[got["policy"]] = got
    check(sorted(runs) == sorted(policies), f"Chameleon stream on {device}: "
          f"runs {sorted(runs)}")
    for name, got in runs.items():
        want = pin[name]
        for key in ("mean_slowdown", "jobs", "tasks", "tasks_sha256",
                    "decisions", "traces", "rollouts", "rollout_shapes",
                    "rollout_sha256"):
            check(got[key] == want[key], f"Chameleon stream {name} on "
                  f"{device}: {key} {str(got[key])[:200]}, pinned "
                  f"{str(want[key])[:200]}")
        rolls = name == "sim_in_the_loop"
        if device == CARD:
            check((got["launches"] > 0) == rolls
                  and got["launches"] == got["chunks"],
                  f"Chameleon stream {name} on the card: replay launches "
                  f"{got['launches']}, chunks {got['chunks']}")
        else:
            check(got["launches"] == 0 and (got["chunks"] > 0) == rolls,
                  f"Chameleon stream {name} on the CPU: launches "
                  f"{got['launches']}, chunks {got['chunks']}")
    return runs


def streams_phase() -> dict:
    """The open-system streams (ROADMAP A8): the ``streams`` target's
    default and full grids, each in a fresh process on the card, held to
    :data:`STREAMS_PIN`; then the pin's Chameleon stream at size (32 jobs,
    31,196 tasks on (32, 4)) under ``sim_in_the_loop`` (8 noisy rollout
    seeds a candidate, replayed by the replay kernel) and ``er_ls`` in a
    fresh process on the card, and under ``sim_in_the_loop`` with its
    rollouts on the CPU (the plain replay) in another, each held to the pin,
    the 32 arrivals' 4 x 8 rollout makespans bit for bit (card, CPU and
    reference alike): the rollout split between host planning and
    replay."""
    pin = json.loads(STREAMS_PIN.read_text())
    out = {"default": _streams_grid(["--only", "streams"], "streams",
                                    pin["default"]),
           "full": _streams_grid(["--full", "--only", "streams"],
                                 "streams_full", pin["full"])}
    card = _chameleon_run(CARD, ["sim_in_the_loop", "er_ls"])
    host = _chameleon_run("cpu", ["sim_in_the_loop"])
    sitl, sitl_cpu = card["sim_in_the_loop"], host["sim_in_the_loop"]
    check(sitl["rollouts"] == 32 and sitl["rollout_sha256"]
          == sitl_cpu["rollout_sha256"], "Chameleon stream: the card's "
          f"{sitl['rollouts']} rollouts' makespans are not the plain "
          "replay's bit for bit")
    drop = ("jobs", "decisions", "policy", "device")
    out["chameleon"] = {
        "card": {k: {f: v for f, v in r.items() if f not in drop}
                 for k, r in card.items()},
        "cpu": {k: {f: v for f, v in r.items() if f not in drop}
                for k, r in host.items()}}
    print(f"streams: Chameleon stream {sitl['tasks']} tasks, "
          f"sim_in_the_loop on the card {sitl['wall_s']:.2f} s "
          f"(rollouts {sitl['rollout_s']:.2f} s, {sitl['launches']} replay "
          f"launches, {sitl['kernel_ms']:.2f} ms of kernel), on the CPU "
          f"{sitl_cpu['wall_s']:.2f} s (rollouts {sitl_cpu['rollout_s']:.2f} "
          f"s); er_ls {card['er_ls']['wall_s']:.2f} s; mean slowdown "
          f"{sitl['mean_slowdown']:.4f} against {card['er_ls']['mean_slowdown']:.4f}")
    return out


def consistency(torch, dtype: str, cfg=None, params=None, batch: int = 2,
                premise=None, limit: float | None = None,
                seq: int = 512) -> dict:
    """max |decode(S-1 | prefill S-1) - prefill(S)| at full width, S =
    ``seq``: qwen2-1.5b by default (its own parameters from seed 1, the
    limit CONSIST_TOL[dtype]); given ``cfg`` (and its served ``params``),
    that model in bf16 at CONSIST_BF16_STD of its logits' std, or at
    ``limit`` where given.  A model with a stub frontend takes seeded 0.02
    · N(0, 1) embeddings in both prefills (the vlm's vision prefix, the
    encoder-decoder's audio frames), the cache the prefix's positions
    more.  ``premise``,
    called after the prefill of S, the prefill of S-1 and the decode step,
    returns (a flag for each sequence, why): the check reads the sequences
    whose flag holds, and where none holds the row is recorded as not
    applicable, with why."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    if cfg is None:
        cfg = get_config("qwen2-1.5b")
    cfg = dataclasses.replace(cfg, dtype=dtype, use_kernels=True)
    gen = torch.Generator(device=CARD).manual_seed(1)
    if params is None:
        params = M.serving_params(cfg, M.init_params(cfg, gen))
    b, s = batch, seq
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=CARD)
    embeds = serve.stub_embeds(cfg, b, CARD)
    if embeds is not None:
        embeds = (0.02 * torch.randn(embeds.shape, generator=gen,
                                     device=CARD)).to(embeds.dtype)
    max_len = M.prefix_len(cfg) + s
    logits_p, _ = M.prefill(cfg, params, toks, M.init_cache(
        cfg, b, max_len, CARD), embeds=embeds)
    cache = M.init_cache(cfg, b, max_len, CARD)
    _, cache = M.prefill(cfg, params, toks[:, :s - 1], cache, embeds=embeds)
    logits_d, _ = M.decode_step(cfg, params, cache, toks[:, s - 1:])
    flags, why = premise() if premise is not None else ([True] * b, "")
    v = cfg.vocab_size
    check(bool(torch.isfinite(logits_p[:, :v]).all()), "non-finite prefill logits")
    if cfg.padded_vocab > v:
        check(float(logits_d[:, v:].max()) < -1e20,
              "padded vocab rows not masked")
    rows = torch.tensor(flags, device=CARD)
    holds = bool(rows.any())
    diff = (logits_d[:, :v] - logits_p[:, :v]).abs().amax(-1)
    err = diff[rows].max().item() if holds else diff.max().item()
    std = logits_p[:, :v].std().item()
    same = (logits_d[:, :v].argmax(-1) == logits_p[:, :v].argmax(-1)).all().item()
    if limit is None:
        limit = (CONSIST_TOL[dtype] if cfg.name in CONSIST_ABS
                 or dtype == "float32" else CONSIST_BF16_STD * std)
    note = ("" if all(flags) else (", not read: " if holds
                                   else ", NOT APPLICABLE: ") + why)
    print(f"prefill/decode consistency {cfg.name} {dtype} (batch {b}, "
          f"capacity factor {cfg.capacity_factor}): max|diff| {err:.3e} "
          f"over {int(rows.sum())} of {b} sequences (limit {limit:.3g}"
          f"{note}), per sequence "
          f"{[round(x, 4) for x in diff.tolist()]}, logits std {std:.3f}, "
          f"same argmax {same}")
    if holds:
        check(err <= limit, f"{cfg.name}: prefill/decode disagree in "
              f"{dtype}: {err}")
    return {"max_abs_diff": err, "limit": limit, "logits_std": std,
            "per_sequence": diff.tolist(), "checked": flags,
            "same_argmax": bool(same), "applicable": holds, "why": why}


def serve_more(torch, card: str) -> dict:
    """SERVE_MORE's configs: a full config through ``launch.serve.main``, a
    cut one through ``launch.serve.generate`` (with the serve entry's stub
    frontend embeddings, the cache holding their prefix too), each with
    every flash counter at 0 just before and, just after, layers x prefill
    batches launches, all of the bf16 kernel (the encoder's and the
    cross-attention take none); then each model's bf16 prefill/decode
    consistency on the same parameters (2 prefills x layers launches
    more)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    out = {}
    batches = -(-8 // SERVE_BATCH)
    for arch, layers, prompt, consist_seq in SERVE_MORE:
        cfg = get_config(arch)
        full = cfg.num_layers
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, use_kernels=True)
        row = {"layers": cfg.num_layers, "reduced": (
            {} if layers is None else {"num_layers": f"{layers} of {full}"}),
            "params": _tree_params(cfg), "prompt": prompt}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if layers is None:          # the user's entry point, as qwen2-1.5b
            fa.reset_launch_count()
            summary = serve.main(["--arch", arch, "--requests", "8",
                                  "--batch", str(SERVE_BATCH), "--prompt",
                                  str(prompt), "--gen", str(SERVE_GEN)],
                                 device=CARD)
            counts = fa.launch_counts()
            check(summary["logits_finite"]
                  and summary["tokens"] == 8 * SERVE_GEN,
                  f"{arch}: serve summary {summary}")
            row.update({k: summary[k] for k in ("tok_per_s", "prefill_s",
                                                "decode_s", "wall_s")})
            params = M.init_serving_params(
                cfg, torch.Generator(device=CARD).manual_seed(0))
        else:                       # the cut config, through generate
            params = M.init_serving_params(
                cfg, torch.Generator(device=CARD).manual_seed(0))
            rng = np.random.default_rng(0)
            prefill_s = decode_s = 0.0
            finite = True
            fa.reset_launch_count()
            t0 = time.perf_counter()
            for _ in range(batches):
                toks = torch.as_tensor(rng.integers(
                    0, cfg.vocab_size, (SERVE_BATCH, prompt)), device=CARD)
                g = serve.generate(
                    cfg, params, toks, SERVE_GEN,
                    M.prefix_len(cfg) + prompt + SERVE_GEN,
                    serve.stub_embeds(cfg, SERVE_BATCH, CARD))
                prefill_s += g.prefill_s
                decode_s += g.decode_s
                finite = finite and g.finite
            wall = time.perf_counter() - t0
            counts = fa.launch_counts()
            check(finite, f"{arch}: non-finite logits")
            row.update({"tok_per_s": 8 * SERVE_GEN / wall,
                        "prefill_s": prefill_s, "decode_s": decode_s,
                        "wall_s": wall})
        want = cfg.num_layers * batches
        check(counts == {**dict.fromkeys(counts, 0), "sm90_bf16": want},
              f"{arch}: flash launches {counts}, expected {want} of sm90_bf16")
        row["flash_launches"] = want
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        fa.reset_launch_count()
        row["consistency"] = consistency(torch, "bfloat16", cfg, params,
                                         seq=consist_seq)
        counts = fa.launch_counts()
        check(counts == {**dict.fromkeys(counts, 0),
                         "sm90_bf16": 2 * cfg.num_layers},
              f"{arch}: the consistency prefills launched {counts}")
        depth = (f"{cfg.encoder_layers} + {cfg.num_layers}"
                 if cfg.family == "encdec" else str(cfg.num_layers))
        front = M.frontend_positions(cfg)
        print(f"serve {arch} ({depth} layers"
              + (f", cut from {full}" if layers is not None else "")
              + f", {row['params'] / 1e9:.2f} B parameters) on {card}: 8 "
              f"requests of " + (f"{front} {cfg.frontend} positions + "
                                 if front else "")
              + f"{prompt} + {SERVE_GEN}, {row['tok_per_s']:.1f} tok/s, "
              f"prefill {row['prefill_s']:.3f} s, decode "
              f"{row['decode_s']:.3f} s, wall {row['wall_s']:.3f} s, flash "
              f"launches {want} (sm90_bf16), peak {row['peak_gb']:.1f} GB")
        del params
        out[arch] = row
    torch.cuda.empty_cache()
    return out


def _moe_equal(torch, got, want) -> float:
    """Raises unless ``got`` equals ``want`` bit for bit, NaN in the same
    places; returns the max |difference| over the other values (0.0)."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    check(torch.equal(nan_g, nan_w), "NaN in other places")
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    g, w = got[~nan_g], want[~nan_w]
    check(torch.equal(g.view(bits), w.view(bits)), "bits differ")
    return (g.float() - w.float()).abs().max().item() if g.numel() else 0.0


def moe_inputs(torch, seed: int, n: int, e: int, k: int, d: int, dtype):
    """Router-like top-k experts and gates for n tokens, x (n, d) and a
    generator for the expert outputs, on the card."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    probs = torch.softmax(torch.randn((n, e), generator=gen, device=CARD),
                          dim=-1)
    gates, top_e = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    x = torch.randn((n, d), generator=gen, device=CARD).to(dtype)
    return top_e, gates, x, gen


def moe_bound_ms(torch, r, n: int, d: int, elem: int) -> dict:
    """Each entry's least time at these inputs, bytes over the card's rate
    (each input read once, each output written once; combine and gate_grad
    read the rows their entries point at, which the routing decides)."""
    nk, ecap = r.slot.numel(), r.rows.numel()
    e1 = r.stats.numel()
    nd = int(r.stats[-1])
    rows_read = int(torch.unique(r.slot).numel())
    moved = {
        "route": nk * 4 + nk * (4 + 1 + 4) + ecap * 4 + e1 * 4,
        "dispatch": n * d * elem + ecap * d * elem + ecap * 4 + e1 * 4
        + nd * 4 * 2,
        "combine": rows_read * d * elem + n * d * elem + nk * (4 + 1 + 4 + 4)}
    # the backward: the dispatch's cotangent is the combine's function
    # (unit gates); combine_grad moves the dispatch's bytes and the kept
    # entries' gates; gate_grad reads the token rows and the rows its
    # entries point at, and writes a float an entry
    moved["dispatch_grad"] = moved["combine"]
    moved["combine_grad"] = moved["dispatch"] + (nk - nd) * 4
    moved["gate_grad"] = (n * d * elem + rows_read * d * elem
                          + nk * (4 + 1) + nk * 4)
    return {k: {"bytes": v, "bound_ms": v / HBM_BYTES_PER_S * 1e3}
            for k, v in moved.items()}


def _moe_backward_equal(torch, r, want, dout, dbuf, ho, gates) -> float:
    """The three backward entries on the routing ``r`` against their plain
    versions on ``want`` (the same routing), bit for bit; returns the max
    |difference| over the values that are not NaN (0.0)."""
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    return max(
        _moe_equal(torch, moe.dispatch_grad(dbuf, r),
                   ref.dispatch_grad_ref(dbuf, want)),
        _moe_equal(torch, moe.combine_grad(dout, r, gates),
                   ref.combine_grad_ref(dout, want, gates)),
        _moe_equal(torch, moe.gate_grad(dout, ho, r),
                   ref.gate_grad_ref(dout, ho, want)))


def moe_edge_inputs(torch, seed: int, name: str, n: int, e: int, k: int):
    """An edge shape's choices (N, k) on the card: a router's top-k of
    logits skewed toward the low experts (they overflow), with a repeat
    and an expert out of range in the warp cases; uniform in [-3, 40) for
    ``out_of_range``."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    if name == "out_of_range":
        return torch.randint(-3, 40, (n, k), generator=gen, device=CARD,
                             dtype=torch.int32)
    skew = 1.0 if name.startswith("entries") else 3.0
    logits = (torch.randn((n, max(e, k)), generator=gen, device=CARD)
              - skew * torch.arange(max(e, k), device=CARD) / max(e - 1, 1))
    top_e = (torch.topk(logits, k, dim=-1).indices % e).int()
    if name.startswith("warp") and n * k > 2:
        flat = top_e.view(-1)
        flat[1], flat[-1] = flat[0], e + 5
    return top_e


def moe_edge_checks(torch) -> list:
    """The edge shapes (MOE_EDGE): route, dispatch and combine, and the
    backward's three entries, bit for bit to their plain versions on the
    card, in bf16 at D = 2048 and fp32 at D = 64; each route the launch
    ``moe.geometry`` gives (one warp up to 32 entries, else a cluster).
    Then a few of them by token at a wide D (MOE_EDGE_WIDE)."""
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    cmax = moe.library_geometry("route", 16384, 4, 8, 60, 8,
                                torch.bfloat16)["cluster"]
    out = []
    for seed, (name, n, e, k, cap) in enumerate(MOE_EDGE):
        top_e = moe_edge_inputs(torch, 100 + seed, name, n, e, k)
        caps = ([cap] if cap is not None else
                [moe.capacity(n, k, e, float(name.split("cf")[-1]))])
        for c in caps:
            g = moe.library_geometry("route", n, k, 8, e, c, torch.bfloat16)
            check(g == moe.geometry("route", n, k, 8, e, c, 2, cmax),
                  f"moe edge {name}: route launch {g}")
            r = moe.route(top_e, e, c)
            want = ref.route_ref(top_e, e, c)
            for field in ("slot", "keep", "rows", "stats", "dropped"):
                check(torch.equal(getattr(r, field), getattr(want, field)),
                      f"moe edge {name}: route {field} differs")
            gen = torch.Generator(device=CARD).manual_seed(seed)
            gates = torch.rand((n, k), generator=gen, device=CARD)
            for dtype, d in ((torch.bfloat16, 2048), (torch.float32, 64)):
                x = torch.randn((n, d), generator=gen, device=CARD).to(dtype)
                ho = torch.randn((e * c, d), generator=gen,
                                 device=CARD).to(dtype)
                _moe_equal(torch, moe.dispatch(x, r), ref.dispatch_ref(x, want))
                _moe_equal(torch, moe.combine(ho, r, gates),
                           ref.combine_ref(ho, want, gates))
                dbuf = torch.randn((e * c, d), generator=gen,
                                   device=CARD).to(dtype)
                _moe_backward_equal(torch, r, want, x, dbuf, ho, gates)
            check(r.scratch.tolist() == [0, 0, 0],
                  f"moe edge {name}: counters left at {r.scratch.tolist()}")
            row = {"name": name, "entries": n * k, "experts": e, "cap": c,
                   "dropped": int(want.stats[-1]), "route": g}
            out.append(row)
            print(f"moe edge {name}: N*k={n * k} E={e} k={k} cap={c}, "
                  f"{row['dropped']} dropped, route {g['blocks']} x "
                  f"{g['threads']} (cluster {g['cluster']}): route, "
                  "dispatch, combine and the backward's dispatch_grad, "
                  "combine_grad, gate_grad bit for bit to the plain versions")
    out.extend(_moe_edge_wide_checks(torch))
    return out


def _moe_edge_wide_checks(torch) -> list:
    """MOE_EDGE_WIDE: dispatch and combine_grad by token (``moe.by_token``
    and the built kernel's launch, one token a block, agree) bit for bit
    to their plain versions, twice on one routing, an inf and a NaN of x at
    dropped tokens past the first 512 vectors; the counters back at 0."""
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    edge = {c[0]: (seed, c) for seed, c in enumerate(MOE_EDGE)}
    out = []
    for name, d, dt in MOE_EDGE_WIDE:
        seed, (_, n, e, k, cap) = edge[name]
        dtype = getattr(torch, dt)
        elem = torch.empty((), dtype=dtype).element_size()
        top_e = moe_edge_inputs(torch, 100 + seed, name, n, e, k)
        r = moe.route(top_e, e, cap)
        want = ref.route_ref(top_e, e, cap)
        g = moe.library_geometry("dispatch", n, k, d, e, cap, dtype)
        check(moe.by_token(n, d, elem) and g["per_block"] == 1 and g ==
              moe.geometry("dispatch", n, k, d, e, cap, elem),
              f"moe edge {name} D={d}: launch {g}, not by token")
        gen = torch.Generator(device=CARD).manual_seed(200 + seed)
        x = torch.randn((n, d), generator=gen, device=CARD).to(dtype)
        gates = torch.rand((n, k), generator=gen, device=CARD)
        drop = want.dropped[want.dropped >= 0].long()
        check(drop.numel() > 0, f"moe edge {name} D={d}: nothing dropped")
        x[drop[0] // k, d - 8] = float("inf")
        x[drop[-1] // k, d // 2 + 3] = float("nan")
        buf = ref.dispatch_ref(x, want)
        dho = ref.combine_grad_ref(x, want, gates)
        nan_rows = int(torch.isnan(buf).any(1).sum())
        check(nan_rows > 0, f"moe edge {name} D={d}: no NaN to keep")
        for _ in range(2):
            _moe_equal(torch, moe.dispatch(x, r), buf)
            _moe_equal(torch, moe.combine_grad(x, r, gates), dho)
            check(r.scratch.tolist() == [0, 0, 0],
                  f"moe edge {name} D={d}: counters left at "
                  f"{r.scratch.tolist()}")
        out.append({"name": f"{name} D={d} {dt}", "entries": n * k,
                    "experts": e, "cap": cap, "dropped": drop.numel(),
                    "dispatch": g, "nan_rows": nan_rows})
        print(f"moe edge {name} by token: N={n} D={d} {dt} "
              f"({n * d * elem / 1e6:.1f} MB of x), {drop.numel()} dropped, "
              f"{g['blocks']} blocks: dispatch and combine_grad bit for bit "
              f"to the plain versions twice, {nan_rows} rows NaN as theirs")
    return out


def moe_times(torch, arch: str, seed: int, phase: str, n: int) -> dict:
    """Each entry at ``arch``'s ``phase`` shape (n tokens) in bf16 at the
    config's capacity: the kernel replayed from a CUDA graph (device time)
    and eagerly, the plain version eagerly, the launch floor (an empty
    kernel launched and timed as the entry) and the byte bound; the share
    is the larger yardstick over the kernel's time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    cfg = get_config(arch)
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    cap = moe.capacity(n, k, e, cfg.capacity_factor)
    top_e, gates, x, gen = moe_inputs(torch, seed, n, e, k, d, torch.bfloat16)
    top_e = top_e.int()
    r = moe.route(top_e, e, cap, distinct=True)
    ho = torch.randn((e * cap, d), generator=gen,
                     device=CARD).to(torch.bfloat16)
    runs = {"route": (lambda: moe.route(top_e, e, cap, distinct=True),
                      lambda: ref.route_ref(top_e, e, cap)),
            "dispatch": (lambda: moe.dispatch(x, r),
                         lambda: ref.dispatch_ref(x, r)),
            "combine": (lambda: moe.combine(ho, r, gates),
                        lambda: ref.combine_ref(ho, r, gates))}
    bounds = moe_bound_ms(torch, r, n, d, 2)
    times = {}
    for name, (kernel, plain) in runs.items():
        t = {"ms": graph_ms(kernel, 20), "eager_ms": time_ms(kernel, 20),
             "plain_ms": time_ms(plain, 5, warmup=2),
             "floor_ms": graph_ms(lambda name=name: moe.launch_floor(
                 name, n, k, d, e, cap, torch.bfloat16), 20),
             "launch": moe.library_geometry(name, n, k, d, e, cap,
                                            torch.bfloat16),
             **bounds[name]}
        t["share"] = max(t["bound_ms"], t["floor_ms"]) / t["ms"]
        times[name] = t
        print(f"moe {name} {arch} {phase} N={n} cap={cap} bf16: kernel "
              f"{t['ms'] * 1e3:.2f} us (eager {t['eager_ms'] * 1e3:.2f} us), "
              f"plain {t['plain_ms'] * 1e3:.2f} us, launch floor "
              f"{t['floor_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bytes'] / 1e6:.2f} MB), kernel at {t['share']:.1%} "
              f"of the larger; launch {t['launch']}")
    return {"n": n, "cap": cap, "dropped": int(r.stats[-1]), "entries": times}


def moe_kernel_checks(torch) -> dict:
    """(a): route, dispatch and combine against their plain versions on the
    card, bit for bit, at both MoE configs' prefill and decode shapes, bf16
    and fp32, capacity 1.25 and 0.5; then NaN through dropped entries; then
    the edge shapes (MOE_EDGE); then each entry's time at each config's
    prefill and decode shapes in bf16 at 1.25 (CUDA graphs; the plain
    versions eagerly, CUDA events), beside its bound and its launch floor.
    Launches here are comparisons, not the main path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    out = {"cases": [], "times": {}}
    worst = 0.0
    for seed, arch in enumerate(MOE_ARCHS):
        cfg = get_config(arch)
        e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
        for phase, n in (("prefill", SERVE_BATCH * SERVE_PROMPT),
                         ("decode", SERVE_BATCH)):
            for cf in MOE_CAPACITY:
                for dtype in (torch.bfloat16, torch.float32):
                    cap = moe.capacity(n, k, e, cf)
                    top_e, gates, x, gen = moe_inputs(torch, seed, n, e, k, d,
                                                      dtype)
                    r = moe.route(top_e, e, cap, distinct=True)
                    want = ref.route_ref(top_e.int(), e, cap)
                    for name in ("slot", "keep", "rows", "stats", "dropped"):
                        check(torch.equal(getattr(r, name), getattr(want, name)),
                              f"moe route {name} differs at {arch} {phase} "
                              f"cf {cf}")
                    ho = torch.randn((e * cap, d), generator=gen,
                                     device=CARD).to(dtype)
                    errs = [_moe_equal(torch, moe.dispatch(x, r),
                                       ref.dispatch_ref(x, want)),
                            _moe_equal(torch, moe.combine(ho, r, gates),
                                       ref.combine_ref(ho, want, gates))]
                    worst = max([worst] + errs)
                    drops = int(want.stats[-1])
                    check(cf == 1.25 or phase == "decode" or drops > 0,
                          f"{arch} prefill at cf {cf} dropped nothing")
                    out["cases"].append({"arch": arch, "phase": phase,
                                         "n": n, "cap": cap, "cf": cf,
                                         "dtype": str(dtype), "dropped": drops})
                    print(f"moe kernel {arch} {phase} N={n} cap={cap} cf={cf} "
                          f"{dtype}: route, dispatch, combine bit for bit "
                          f"to the plain versions, {drops} entries dropped")
    # NaN: a NaN in every row a dropped entry points at, an inf in the last
    # row, a NaN in dropped tokens' x
    cfg = get_config(MOE_ARCHS[0])
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    n = SERVE_BATCH * SERVE_PROMPT
    cap = moe.capacity(n, k, e, 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        top_e, gates, x, gen = moe_inputs(torch, 9, n, e, k, d, dtype)
        r = moe.route(top_e, e, cap)
        want = ref.route_ref(top_e.int(), e, cap)
        drop = want.dropped[want.dropped >= 0].long()
        ho = torch.randn((e * cap, d), generator=gen, device=CARD).to(dtype)
        ho[want.slot[drop].long(), 3] = float("nan")
        ho[e * cap - 1, 5] = float("inf")
        x[drop[:3] // k, 11] = float("nan")
        got_o, want_o = moe.combine(ho, r, gates), ref.combine_ref(ho, want,
                                                                   gates)
        got_b, want_b = moe.dispatch(x, r), ref.dispatch_ref(x, want)
        check(bool(torch.isnan(want_o[:, 3]).any())
              and bool(torch.isnan(want_b[:, 11]).any()), "no NaN to keep")
        _moe_equal(torch, got_o, want_o)
        _moe_equal(torch, got_b, want_b)
        check(r.scratch.tolist() == [0, 0, 0], "moe dispatch left its "
              f"counters at {r.scratch.tolist()}")
        nan_tokens = int(torch.isnan(got_o[:, 3]).sum())
        print(f"moe kernel NaN {dtype}: {nan_tokens} tokens NaN through "
              f"dropped entries, as the plain version; dispatch rows NaN "
              f"{int(torch.isnan(got_b[:, 11]).sum())}")
        out.setdefault("nan_tokens", {})[str(dtype)] = nan_tokens
    out["max_abs_err"] = worst
    out["edge"] = moe_edge_checks(torch)

    for seed, arch in enumerate(MOE_ARCHS):
        out["times"][arch] = {
            phase: moe_times(torch, arch, seed, phase, n)
            for phase, n in (("prefill", SERVE_BATCH * SERVE_PROMPT),
                             ("decode", SERVE_BATCH))}
    return out


def _plain_moe_ops():
    """The MoE ops module's names bound to the plain versions (dispatch and
    combine with their plain backward, ``ref.dispatch`` / ``ref.combine``):
    the model's plain path on the card, for the kernel path's
    comparison."""
    import types

    from repro_torch.kernels.moe import ref

    def route(top_e, e, cap, distinct=False):
        return ref.route_ref(top_e.int(), e, cap)

    return types.SimpleNamespace(capacity=ref.capacity, route=route,
                                 dispatch=ref.dispatch, combine=ref.combine)


def _moe_premise(torch, cfg, calls: list, trace: list):
    """The premise of prefill(S) against decode(S-1 | prefill S-1) for
    each sequence, from the MoE layers' records in ``calls`` (the prefill
    of S, the prefill of S-1, the decode step): the last position kept
    every choice in every layer of the prefill of S; its choices (as sets)
    are the decode step's in every layer (no top-k flip); the earlier
    positions' choices and kept flags are the same in both prefills.  Then
    the two compute one function and only rounding parts them.  Prints
    each sequence's trace: the layers that broke the premise, and
    max|diff| / std of the decode step's MoE output against the prefill of
    S's over the layers before the first flip and at it, and of the last
    layer's MoE input (after ln2)."""
    nl = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    check(len(calls) == 3 * nl, f"{cfg.name}: {len(calls)} MoE calls, "
          f"expected {3 * nl}")
    pre, pre1, dec = calls[:nl], calls[nl:2 * nl], calls[2 * nl:]

    def rel(key, i, l):
        a, b = dec[l][key][i], pre[l][key][i]
        return ((a - b).abs().max() / b.std()).item()

    flags = []
    for i in range(pre[0]["top_e"].shape[0]):
        lost = [l for l in range(nl) if not bool(pre[l]["keep"][i, -1].all())]
        flip = [l for l in range(nl)
                if not torch.equal(pre[l]["top_e"][i, -1], dec[l]["top_e"][i, 0])]
        early = [l for l in range(nl)
                 if not (torch.equal(pre[l]["top_e"][i, :-1], pre1[l]["top_e"][i])
                         and torch.equal(pre[l]["keep"][i, :-1],
                                         pre1[l]["keep"][i]))]
        dy = [rel("y", i, l) for l in range(nl)]
        first = min(flip) if flip else nl
        t = {"lost": lost, "flip": flip, "earlier_differ": early,
             "out_rel_before_flip": max(dy[:first], default=0.0),
             "out_rel_at_flip": dy[first] if flip else None,
             "in_rel_last": rel("x", i, nl - 1)}
        trace.append(t)
        print(f"{cfg.name} cf {cfg.capacity_factor} sequence {i}: layers "
              f"where the last position lost a choice {lost}, flipped one "
              f"{flip}, earlier positions routed otherwise {early}; MoE "
              f"output max|diff|/std {t['out_rel_before_flip']:.3g} before "
              f"the first flip" + (f", {t['out_rel_at_flip']:.3g} at it"
                                   if flip else "")
              + f"; last MoE input {t['in_rel_last']:.3g}")
        flags.append(not (lost or flip or early))
    out = [i for i, f in enumerate(flags) if not f]
    why = (f"sequences {out}: {sum(bool(t['lost']) for t in trace)} lost a "
           f"choice to capacity, {sum(bool(t['flip']) for t in trace)} "
           f"flipped a top-k choice, "
           f"{sum(bool(t['earlier_differ']) for t in trace)} routed earlier "
           "positions otherwise")
    return flags, why


def moe_consistency(torch, cfg, params, dtype: str = "bfloat16",
                    batch: int = MOE_CONSIST_BATCH) -> dict:
    """(d): the prefill/decode consistency of ``batch`` sequences
    at the config's capacity and at a capacity of every token (cf = E / k:
    cap = N, nothing drops), each read where :func:`_moe_premise` holds:
    in bf16 at the unchanged CONSIST_BF16_STD of the logits' std, in fp32
    at CONSIST_TOL["float32"]."""
    import dataclasses

    from repro_torch.models import layers as L

    out = {}
    roomy = dataclasses.replace(
        cfg, capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    for name, c in (("consistency", cfg), ("consistency_no_drop", roomy)):
        calls, trace = [], []
        apply = L.moe_apply

        def watch(cfg_, p, x):
            y, (probs, r) = apply(cfg_, p, x)
            b, s = x.shape[:2]
            te, order = torch.sort(r.top_e.view(b, s, -1), dim=-1)
            calls.append({"top_e": te,
                          "keep": r.keep.view(b, s, -1).gather(-1, order),
                          "x": x[:, -1].float(), "y": y[:, -1].float()})
            return y, (probs, r)

        L.moe_apply = watch
        try:
            out[name] = consistency(
                torch, dtype, c, params, batch=batch,
                premise=lambda: _moe_premise(torch, c, calls, trace))
        finally:
            L.moe_apply = apply
        out[name]["trace"] = trace
    return out


def moe_serve(torch, card: str) -> dict:
    """(b)-(d) for each MoE config: ``launch.serve.main`` at the full
    config, every flash and MoE counter 0 just before and read just after;
    the kernel path's full-width prefill against the plain path's, bit for
    bit; the bf16 prefill/decode consistency where its premise holds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    out = {}
    batches = -(-8 // SERVE_BATCH)
    for arch in MOE_ARCHS:
        cfg = dataclasses.replace(get_config(arch), use_kernels=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        moe.reset_launch_count()
        summary = serve.main(["--arch", arch, "--requests", "8", "--batch",
                              str(SERVE_BATCH), "--prompt", str(SERVE_PROMPT),
                              "--gen", str(SERVE_GEN)], device=CARD)
        counts, moe_counts = fa.launch_counts(), moe.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(summary["logits_finite"], f"{arch}: non-finite logits")
        want = cfg.num_layers * batches
        check(counts == {**dict.fromkeys(counts, 0), "sm90_bf16": want},
              f"{arch}: flash launches {counts}, expected {want} of sm90_bf16")
        want_moe = cfg.num_layers * batches * SERVE_GEN
        check(moe_counts == {**dict.fromkeys(moe_counts, 0),
                             **dict.fromkeys(MOE_FORWARD, want_moe)}
              and summary["moe_launches"] == moe_counts,
              f"{arch}: MoE launches {moe_counts}, expected {want_moe} of "
              f"each forward entry and no backward launch")
        row = {k: summary[k] for k in ("tok_per_s", "prefill_s", "decode_s",
                                       "wall_s", "prefill_dropped")}
        row.update(layers=cfg.num_layers, params=cfg.num_params(),
                   flash_launches=want, moe_launches=moe_counts, peak_gb=peak)
        print(f"serve {arch} ({cfg.num_layers} layers, "
              f"{cfg.num_params() / 1e9:.2f} B parameters) on {card}: "
              f"{row['tok_per_s']:.1f} tok/s, prefill {row['prefill_s']:.3f}"
              f" s, decode {row['decode_s']:.3f} s, wall {row['wall_s']:.3f} "
              f"s, flash launches {want} (sm90_bf16), MoE launches "
              f"{moe_counts}, entries dropped in prefill "
              f"{row['prefill_dropped']}, peak {peak:.1f} GB")
        del summary

        # (c) the kernel path against the plain path, one prefill of 4 x 512
        gen = torch.Generator(device=CARD).manual_seed(0)
        params = M.init_serving_params(cfg, gen)
        toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                             generator=gen, device=CARD)
        max_len = SERVE_PROMPT + 1
        logits_k, cache_k = M.prefill(cfg, params, toks,
                                      M.init_cache(cfg, SERVE_BATCH, max_len,
                                                   CARD))
        kernel_ops, L.moe_ops = L.moe_ops, _plain_moe_ops()
        try:
            logits_p, cache_p = M.prefill(cfg, params, toks, M.init_cache(
                cfg, SERVE_BATCH, max_len, CARD))
        finally:
            L.moe_ops = kernel_ops
        same = (torch.equal(logits_k, logits_p)
                and torch.equal(cache_k["layers"]["k"], cache_p["layers"]["k"])
                and torch.equal(cache_k["layers"]["v"], cache_p["layers"]["v"]))
        check(same, f"{arch}: the kernel path's prefill differs from the "
              "plain path's")
        print(f"{arch}: full-width prefill (4 x 512) through the kernels "
              "equals the plain path's bit for bit (logits and cache)")
        row["plain_path_equal"] = True
        del cache_k, cache_p, logits_k, logits_p

        # (d) consistency, each sequence where its premise holds
        row.update(moe_consistency(torch, cfg, params))
        del params
        if arch in MOE_FP32_CONSIST:
            torch.cuda.empty_cache()
            c32 = dataclasses.replace(cfg, dtype="float32")
            params = M.init_serving_params(
                c32, torch.Generator(device=CARD).manual_seed(1))
            row["float32"] = moe_consistency(torch, c32, params, "float32")
            del params
        out[arch] = row
    torch.cuda.empty_cache()
    return out


def moe_phase(torch, card: str) -> dict:
    """The MoE family: the kernel's checks and times, then the served
    models; returns the summary and the ``kernels`` line's row."""
    checks = moe_kernel_checks(torch)
    serving = moe_serve(torch, card)
    first = checks["times"][MOE_ARCHS[0]]
    times = first["prefill"]["entries"]
    row = {"name": "moe_dispatch_combine", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_sm90.cu",
           "replaces": "src/repro/models/layers.py:262",
           "shape": f"{MOE_ARCHS[0]} prefill, {SERVE_BATCH} x {SERVE_PROMPT}"
                    " tokens, bf16, capacity 1.25: route + dispatch + combine",
           "launches": sum(sum(v["moe_launches"].values())
                           for v in serving.values()),
           "max_abs_err": checks["max_abs_err"],
           "ms": sum(t["ms"] for t in times.values()),
           "plain_ms": sum(t["plain_ms"] for t in times.values()),
           "bound_ms": sum(t["bound_ms"] for t in times.values()),
           "bound_by": "bytes",
           "bytes": sum(t["bytes"] for t in times.values()),
           "floor_ms": sum(t["floor_ms"] for t in times.values()),
           "library_ms": None,
           "entries": times,
           "decode": first["decode"],
           "other_configs": {a: checks["times"][a] for a in MOE_ARCHS[1:]},
           "edge_cases": len(checks["edge"]),
           "serve_launches": {a: v["moe_launches"] for a, v in serving.items()}}
    return {"checks": checks, "serve": serving, "row": row}


def pair_child(tree: str, label: str, archs: list[str]) -> int:
    """One side of a parent / change comparison on one card, in a fresh
    process: ``python3 chip_smoke.py --pair TREE LABEL ARCH...`` imports
    TREE's ``repro_torch`` (a checkout; the parent's unpacked from ``git
    archive`` into a directory ``.gitignore`` lists).  For each ARCH with
    experts it times route, dispatch and combine at the config's prefill
    and decode shapes in bf16 at its capacity factor (CUDA graphs of 20
    calls, the best of 3); then it serves each ARCH: HYBRID_ARCH at full
    width and HYBRID_LAYERS layers through ``launch.serve.generate`` (a
    first batch of 4 x 512 + 4 builds and warms the kernels, untimed), any
    other at its full config through ``launch.serve.main``; each 8 requests
    in batches of 4, prompt 512, 32 generated.  Prints one JSON line.  Run
    the sides in turns (parent, change, change, parent) within one chip
    call; the first process of each tree builds its kernels.  For each
    ARCH with experts it also times dispatch and combine_grad at the
    training shape (TRAIN_BATCH x TRAIN_SEQ tokens), at the prefill shape
    in fp32, and in bf16 at the tokens whose x is PAIR_GAP_BYTES (the
    last two between the serving prefill's x and the training shape's,
    where the dispatch's shape rule falls).  With SSM_ARCH among
    the ARCHs it also times ``ssd_sm90.cu``'s entries in bf16
    (:func:`ssd_entry_times`, the best of 3)."""
    import dataclasses

    import numpy as np
    import torch

    check(torch.cuda.is_available(), "the pair needs a card")
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import moe
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    check(Path(serve.__file__).resolve().is_relative_to(root),
          f"imported {serve.__file__}, not {root}'s")
    out = {"label": label, "card": card_line(), "times_us": {}, "serve": {}}
    for seed, arch in enumerate(archs):
        cfg = get_config(arch)
        e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
        for phase, n, dtype in (
                ("prefill", SERVE_BATCH * SERVE_PROMPT, torch.bfloat16),
                ("decode", SERVE_BATCH, torch.bfloat16),
                ("train", TRAIN_BATCH * TRAIN_SEQ, torch.bfloat16),
                ("prefill_fp32", SERVE_BATCH * SERVE_PROMPT, torch.float32),
                ("gap", PAIR_GAP_BYTES // (d * 2), torch.bfloat16)) \
                if e else ():
            cap = moe.capacity(n, k, e, cfg.capacity_factor)
            top_e, gates, x, gen = moe_inputs(torch, seed, n, e, k, d, dtype)
            top_e = top_e.int()
            r = moe.route(top_e, e, cap, distinct=True)
            ho = torch.randn((e * cap, d), generator=gen, device=CARD).to(dtype)
            runs = {"route": lambda: moe.route(top_e, e, cap, distinct=True),
                    "dispatch": lambda: moe.dispatch(x, r),
                    "combine": lambda: moe.combine(ho, r, gates)}
            if phase not in ("prefill", "decode"):
                runs = {"dispatch": runs["dispatch"],
                        "combine_grad": lambda: moe.combine_grad(x, r, gates)}
            for name, fn in runs.items():
                out["times_us"][f"{arch} {phase} {name}"] = min(
                    graph_ms(fn, 20) for _ in range(3)) * 1e3
    if SSM_ARCH in archs:
        out["ssd_us"] = {key: ms * 1e3 for key, ms in ssd_entry_times(
            ssd_timed_cases(torch), 3).items()}
    for arch in archs:
        if arch != HYBRID_ARCH:
            summary = serve.main(["--arch", arch, "--requests", "8",
                                  "--batch", str(SERVE_BATCH), "--prompt",
                                  str(SERVE_PROMPT), "--gen", str(SERVE_GEN)],
                                 device=CARD)
            out["serve"][arch] = {k: summary[k] for k in (
                "tok_per_s", "prefill_s", "decode_s", "wall_s")}
            torch.cuda.empty_cache()
            continue
        cfg = dataclasses.replace(get_config(arch), num_layers=HYBRID_LAYERS,
                                  use_kernels=True)
        params = M.init_serving_params(cfg, torch.Generator(device=CARD)
                                       .manual_seed(0))
        rng = np.random.default_rng(0)

        def prompt():
            return torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=CARD)

        serve.generate(cfg, params, prompt(), 4, SERVE_PROMPT + 4)
        torch.cuda.synchronize()
        prefill_s = decode_s = 0.0
        t0 = time.perf_counter()
        for _ in range(-(-8 // SERVE_BATCH)):
            g = serve.generate(cfg, params, prompt(), SERVE_GEN,
                               SERVE_PROMPT + SERVE_GEN)
            prefill_s += g.prefill_s
            decode_s += g.decode_s
        wall = time.perf_counter() - t0
        out["serve"][arch] = {"tok_per_s": 8 * SERVE_GEN / wall,
                              "prefill_s": prefill_s, "decode_s": decode_s,
                              "wall_s": wall}
        del params
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def moe_backward_checks(torch) -> dict:
    """The backward entries (``dispatch_grad``, the combine with unit
    gates; ``combine_grad``; ``gate_grad``) and the forward ``dispatch``
    against their plain versions on the card, bit for bit, at both MoE
    configs' training shape (TRAIN_BATCH x TRAIN_SEQ tokens, where the
    dispatch and combine_grad go by token: ``moe.by_token``), bf16 and
    fp32, capacity 1.25 and 0.5; then NaN: a non-finite dout (the
    dispatch's x) at tokens whose dropped entries' slots are rows, a NaN in
    ho under dropped entries and in dbuf at their slots, twice on one
    routing (its counters back at 0).  The edge shapes run in the moe phase
    (:func:`moe_edge_checks`).  Launches here are comparisons, not the main
    path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    n = TRAIN_BATCH * TRAIN_SEQ
    out, worst = {"cases": []}, 0.0
    for seed, arch in enumerate(MOE_ARCHS):
        cfg = get_config(arch)
        e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
        for cf in MOE_CAPACITY:
            cap = moe.capacity(n, k, e, cf)
            for dtype in (torch.bfloat16, torch.float32):
                top_e, gates, dout, gen = moe_inputs(torch, 20 + seed, n, e,
                                                     k, d, dtype)
                r = moe.route(top_e, e, cap, distinct=True)
                want = ref.route_ref(top_e.int(), e, cap)
                check(moe.by_token(n, d, dout.element_size()),
                      f"{arch}: the training shape's dispatch goes by rows")
                rows = [torch.randn((e * cap, d), generator=gen,
                                    device=CARD).to(dtype) for _ in range(2)]
                worst = max(worst, _moe_backward_equal(
                    torch, r, want, dout, rows[0], rows[1], gates),
                    _moe_equal(torch, moe.dispatch(dout, r),
                               ref.dispatch_ref(dout, want)))
                check(r.scratch.tolist() == [0, 0, 0], "moe dispatch left "
                      f"its counters at {r.scratch.tolist()}")
                drops = int(want.stats[-1])
                check(cf == 1.25 or drops > 0,
                      f"{arch} training shape at cf {cf} dropped nothing")
                out["cases"].append({"arch": arch, "n": n, "cap": cap,
                                     "cf": cf, "dtype": str(dtype),
                                     "dropped": drops})
                print(f"moe backward {arch} N={n} cap={cap} cf={cf} {dtype}:"
                      " dispatch_grad, combine_grad, gate_grad and the "
                      "forward dispatch bit for bit to the plain versions, "
                      f"{drops} entries dropped")
    cfg = get_config(MOE_ARCHS[0])
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    cap = moe.capacity(n, k, e, 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        top_e, gates, dout, gen = moe_inputs(torch, 29, n, e, k, d, dtype)
        r = moe.route(top_e, e, cap)
        want = ref.route_ref(top_e.int(), e, cap)
        drop = want.dropped[want.dropped >= 0].long()
        ho, dbuf = (torch.randn((e * cap, d), generator=gen,
                                device=CARD).to(dtype) for _ in range(2))
        dout[drop[:3] // k, 5] = float("inf")
        dout[drop[3:5] // k, 6] = float("nan")
        ho[want.slot[drop[5:8]].long(), 7] = float("nan")
        dbuf[want.slot[drop[8:10]].long(), 9] = float("nan")
        dho = ref.combine_grad_ref(dout, want, gates)
        dg = ref.gate_grad_ref(dout, ho, want).view(-1)
        dx = ref.dispatch_grad_ref(dbuf, want)
        buf = ref.dispatch_ref(dout, want)
        check(bool(torch.isnan(dho[want.slot[drop[:3]].long(), 5]).all())
              and bool(torch.isnan(dg[drop[5:8]]).all())
              and bool(torch.isnan(dx[drop[8:10] // k, 9]).all())
              and bool(torch.isnan(buf[want.slot[drop[3:5]].long(), 6])
                       .all()), "moe backward: no NaN to keep")
        for _ in range(2):
            _moe_backward_equal(torch, r, want, dout, dbuf, ho, gates)
            _moe_equal(torch, moe.dispatch(dout, r), buf)
            check(r.scratch.tolist() == [0, 0, 0], "moe combine_grad or "
                  f"dispatch left its counters at {r.scratch.tolist()}")
        out.setdefault("nan", {})[str(dtype)] = {
            "dho_rows": int(torch.isnan(dho).any(1).sum()),
            "gates": int(torch.isnan(dg).sum()),
            "dx_tokens": int(torch.isnan(dx).any(1).sum()),
            "dispatch_rows": int(torch.isnan(buf).any(1).sum())}
        print(f"moe backward NaN {dtype}: dho rows NaN "
              f"{out['nan'][str(dtype)]['dho_rows']}, gate cotangents "
              f"{out['nan'][str(dtype)]['gates']}, dx tokens "
              f"{out['nan'][str(dtype)]['dx_tokens']}, forward dispatch rows "
              f"{out['nan'][str(dtype)]['dispatch_rows']}, as the plain "
              "versions")
    out["max_abs_err"] = worst
    return out


def moe_backward_times(torch, arch: str, seed: int) -> dict:
    """Each backward entry at ``arch``'s training shape (TRAIN_BATCH x
    TRAIN_SEQ tokens) in bf16 at the config's capacity: the kernel from a
    CUDA graph and eagerly, the plain version eagerly, the launch floor of
    the entry it launches (MOE_BACKWARD) and the byte bound; the share is
    the larger yardstick over the kernel's time."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.moe import ref

    cfg = get_config(arch)
    e, k, d = cfg.moe_num_experts, cfg.moe_top_k, cfg.d_model
    n = TRAIN_BATCH * TRAIN_SEQ
    cap = moe.capacity(n, k, e, cfg.capacity_factor)
    top_e, gates, dout, gen = moe_inputs(torch, seed, n, e, k, d,
                                         torch.bfloat16)
    r = moe.route(top_e, e, cap, distinct=True)
    ho, dbuf = (torch.randn((e * cap, d), generator=gen,
                            device=CARD).to(torch.bfloat16) for _ in range(2))
    runs = {"dispatch_grad": (lambda: moe.dispatch_grad(dbuf, r),
                              lambda: ref.dispatch_grad_ref(dbuf, r)),
            "combine_grad": (lambda: moe.combine_grad(dout, r, gates),
                             lambda: ref.combine_grad_ref(dout, r, gates)),
            "gate_grad": (lambda: moe.gate_grad(dout, ho, r),
                          lambda: ref.gate_grad_ref(dout, ho, r))}
    bounds = moe_bound_ms(torch, r, n, d, 2)
    times = {}
    for name, (kernel, plain) in runs.items():
        entry = MOE_BACKWARD[name]
        t = {"ms": graph_ms(kernel, 20), "eager_ms": time_ms(kernel, 20),
             "plain_ms": time_ms(plain, 5, warmup=2),
             "floor_ms": graph_ms(lambda entry=entry: moe.launch_floor(
                 entry, n, k, d, e, cap, torch.bfloat16), 20),
             "launch": moe.library_geometry(entry, n, k, d, e, cap,
                                            torch.bfloat16),
             **bounds[name]}
        t["share"] = max(t["bound_ms"], t["floor_ms"]) / t["ms"]
        times[name] = t
        print(f"moe {name} {arch} train N={n} cap={cap} bf16: kernel "
              f"{t['ms'] * 1e3:.2f} us (eager {t['eager_ms'] * 1e3:.2f} us), "
              f"plain {t['plain_ms'] * 1e3:.2f} us, launch floor "
              f"{t['floor_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.3f}"
              f" us ({t['bytes'] / 1e6:.2f} MB), kernel at {t['share']:.1%} "
              f"of the larger; launch {t['launch']}")
    # the forward dispatch on the same routing: combine_grad's kernel
    # without its weights
    fwd = {"ms": graph_ms(lambda: moe.dispatch(dout, r), 20),
           "floor_ms": graph_ms(lambda: moe.launch_floor(
               "dispatch", n, k, d, e, cap, torch.bfloat16), 20),
           "launch": moe.library_geometry("dispatch", n, k, d, e, cap,
                                          torch.bfloat16),
           **bounds["dispatch"]}
    fwd["share"] = max(fwd["bound_ms"], fwd["floor_ms"]) / fwd["ms"]
    print(f"moe dispatch (forward) {arch} train N={n} cap={cap} bf16: "
          f"{fwd['ms'] * 1e3:.2f} us, launch floor "
          f"{fwd['floor_ms'] * 1e3:.2f} us, bound {fwd['bound_ms'] * 1e3:.3f}"
          f" us, at {fwd['share']:.1%}; launch {fwd['launch']}")
    return {"n": n, "cap": cap, "dropped": int(r.stats[-1]), "entries": times,
            "forward_dispatch": fwd}


def _moe_layer_params(torch, cfg, seed: int) -> dict:
    """One MoE layer's parameters at ``cfg``'s full width, fp32 on the card
    (``init_params`` of a one-layer copy; the rest dropped)."""
    import dataclasses

    from repro_torch.models import model as M

    one = dataclasses.replace(cfg, num_layers=1)
    blocks = M.init_params(one, torch.Generator(device=CARD).manual_seed(
        seed))["blocks"]
    return M._layer(blocks, 0)["moe"]


def _leaf_names(tree: dict, path: str = "") -> list:
    """The leaves' paths in ``tree.leaves``' order (sorted keys)."""
    return [name for k in sorted(tree)
            for name in (_leaf_names(tree[k], f"{path}{k}/")
                         if isinstance(tree[k], dict) else [path + k])]


def moe_layer_grad_check(torch) -> dict:
    """A MoE layer of each config at full width on the card, bf16 compute
    and fp32 parameters at the training shape, capacity 1.25 and 0.5: the
    gradients for x, the router, ``w_gate``, ``w_up``, ``w_down`` and the
    shared experts through the kernels bit for bit those through the
    plain versions (:func:`_plain_moe_ops`), on the same inputs; the aux
    loss's gradient included."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.tree import leaves, unflatten_like

    n, out = TRAIN_BATCH * TRAIN_SEQ, {}
    for seed, arch in enumerate(MOE_ARCHS):
        base = get_config(arch)
        p = _moe_layer_params(torch, base, 40 + seed)
        gen = torch.Generator(device=CARD).manual_seed(50 + seed)
        x, dy = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, base.d_model),
                             generator=gen, device=CARD).to(torch.bfloat16)
                 for _ in range(2))
        for cf in MOE_CAPACITY:
            cfg = dataclasses.replace(base, capacity_factor=cf)
            grads, drops = [], []
            for ops in (L.moe_ops, _plain_moe_ops()):
                kernel_ops, L.moe_ops = L.moe_ops, ops
                flat = [x.clone().requires_grad_()] + [
                    w.detach().requires_grad_() for w in leaves(p)]
                try:
                    y, routed = L.moe_apply(cfg, unflatten_like(p, flat[1:]),
                                            flat[0])
                    loss = (y.float() * dy.float()).sum() + L.moe_aux_loss(
                        cfg, routed)
                    grads.append(torch.autograd.grad(loss, flat))
                    drops.append(int(routed[1].stats[-1]))
                finally:
                    L.moe_ops = kernel_ops
            check(drops[0] == drops[1], f"{arch}: routings differ {drops}")
            worst = max(_moe_equal(torch, a, b) for a, b in zip(*grads))
            names = ["x"] + _leaf_names(p)
            out[f"{arch} cf {cf}"] = {"dropped": drops[0], "leaves": names,
                                      "max_abs_err": worst}
            print(f"moe layer {arch} full width, N={n} cf {cf} bf16: "
                  f"{len(names)} gradients ({', '.join(names)}) through the "
                  "kernels bit for bit those through the plain versions, "
                  f"{drops[0]} entries dropped")
            del grads
        del p, x, dy
        torch.cuda.empty_cache()
    return out


def _routing_watch(torch, records: list):
    """``layers.moe_apply`` wrapped to append each call's routing (top_e
    sorted within each token, the kept flags in that order, and the dropped
    count, all on the device) to ``records``; returns (wrapper, original)."""
    from repro_torch.models import layers as L

    apply = L.moe_apply

    def watch(cfg, p, x):
        y, (probs, r) = apply(cfg, p, x)
        te, order = torch.sort(r.top_e, dim=-1)
        records.append({"top_e": te, "keep": r.keep.view(te.shape).gather(
            -1, order), "dropped": r.stats[-1]})
        return y, (probs, r)

    return watch, apply


def timed_train(torch, cfg, oc, data_cfg, steps: int, counters,
                on_step=None) -> dict:
    """``cfg`` trained ``steps`` steps through ``launch.train``'s step
    function on the pipeline's batches of ``data_cfg`` (fresh seeded state
    and AdamW): each kernel module of ``counters`` at 0 just before the
    first step and its ``launch_counts()`` read just after the last; each
    step synchronised and timed, ``on_step(step, metrics, seconds)`` called
    after it, off its clock.  Returns the losses, grad norms, step
    seconds, their median over steps 2-N, peak GB and the counts (in the
    order of ``counters``)."""
    import gc

    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as LT

    dev = torch.device(CARD)
    gc.collect()            # what earlier runs left in reference cycles
    torch.cuda.empty_cache()
    one_step = LT.make_step(cfg, oc, dev)
    state = LT.init_state(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset_launch_count()
    losses, gnorms, step_s = [], [], []
    for step in range(steps):
        batch = make_batch(data_cfg, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = one_step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(step, metrics, step_s[-1])
    counts = [c.launch_counts() for c in counters]
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "step_s_median": sorted(step_s[1:])[len(step_s[1:]) // 2],
            "peak_gb": peak / 1e9, "counts": counts}


def check_losses(name: str, cfg, losses: list, *more: list) -> float:
    """Raises unless every loss (and every value of ``more``) is finite,
    the first loss within TRAIN_LOSS0_TOL of ln V and the last below the
    first; returns ln V."""
    import math

    check(all(math.isfinite(v) for v in losses + sum(more, [])),
          f"{name}: non-finite loss, grad norm or aux loss: {losses}, "
          f"{list(more)}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(losses[0] - ln_v) <= TRAIN_LOSS0_TOL, f"{name}: first loss "
          f"{losses[0]} not within {TRAIN_LOSS0_TOL} of ln V = {ln_v}")
    check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
    return ln_v


def moe_train_run(torch, card: str, arch: str, layers: int | None,
                  steps: int, warmup: int) -> dict:
    """``arch`` (cut to ``layers`` where given) trained for ``steps`` steps
    through ``launch.train``'s step function at TRAIN_BATCH x TRAIN_SEQ:
    every flash and MoE counter 0 just before, read just after (0 flash
    launches; each MoE entry MOE_TRAIN_LAUNCHES a layer a step); every loss
    and grad norm finite, the first loss within TRAIN_LOSS0_TOL of ln V,
    the last below the first; each step's aux loss and share of dropped
    entries (the forward's routings' ``stats[-1]``, read after the step,
    off its clock); step s (synchronised; the median of steps 2-N),
    tokens/s, peak GB and (6 N_active + 12 L S H Dh) tokens / step s."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    check(cfg.family == "moe" and not cfg.use_kernels
          and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
          and cfg.remat == "full", f"{arch}: not the trainer's config")
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=warmup, total_steps=steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    records = []
    watch, apply = _routing_watch(torch, records)
    nk = TRAIN_BATCH * TRAIN_SEQ * cfg.moe_top_k
    aux, dropped = [], []

    def on_step(step, metrics, sec):
        fwd = records[:cfg.num_layers]          # the forward's; then remat's
        records.clear()
        aux.append(float(metrics["aux_loss"]))
        dropped.append(sum(int(r["dropped"]) for r in fwd)
                       / (nk * cfg.num_layers))
        print(f"train {arch} step {step}: loss {float(metrics['loss']):.4f}, "
              f"aux {aux[-1]:.4f}, dropped {dropped[-1]:.2%} of entries, "
              f"{sec:.3f} s")
    L.moe_apply = watch
    try:
        run = timed_train(torch, cfg, oc, data_cfg, steps, (moe, fa), on_step)
    finally:
        L.moe_apply = apply
    launches, flash = run["counts"][0], sum(run["counts"][1].values())
    losses, gnorms, step_s = run["losses"], run["grad_norms"], run["step_s"]
    steady, peak = run["step_s_median"], run["peak_gb"] * 1e9
    want = {k: v * cfg.num_layers * steps
            for k, v in MOE_TRAIN_LAUNCHES.items()}
    check(launches == want, f"{arch}: MoE launches {launches}, expected "
          f"{want}")
    check(flash == 0, f"{arch}: training launched flash attention {flash} "
          "times")
    ln_v = check_losses(arch, cfg, losses, gnorms, aux)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, tokens, TRAIN_SEQ)
    cut = (f"{cfg.num_layers} of {full_layers} layers"
           if layers is not None else "full config")
    row = {"arch": arch, "cut": cut, "layers": cfg.num_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
           "losses": losses, "grad_norms": gnorms, "aux_losses": aux,
           "dropped_share": dropped, "step_s": step_s,
           "step_s_median": steady, "tokens_per_s": tokens / steady,
           "peak_gb": peak / 1e9, "flops_per_step": flops,
           "tflops": flops / steady / 1e12,
           "mfu_vs_bf16_peak": flops / steady / BF16_FLOP_PER_S,
           "moe_launches": launches, "flash_launches": flash,
           "params": cfg.num_params(), "active_params": cfg.active_params()}
    print(f"train {arch} ({cut}) on {card}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (ln V {ln_v:.4f}), aux {aux[0]:.4f} -> "
          f"{aux[-1]:.4f}, dropped {min(dropped):.2%}-{max(dropped):.2%}, "
          f"step {steady:.3f} s (median of steps 2-{steps}; first "
          f"{step_s[0]:.3f} s), {tokens / steady:.0f} tokens/s, peak "
          f"{peak / 1e9:.1f} GB, ~{flops / steady / 1e12:.1f} TFLOP/s = (6 "
          f"N_active tokens + 12 L S H Dh tokens) / step s, N_active = "
          f"{cfg.active_params()} of {cfg.num_params()}, "
          f"{flops / steady / BF16_FLOP_PER_S:.1%} of the bf16 dense peak; "
          f"MoE launches {launches}, flash launches {flash}")
    return row


def train_cpu_check(torch, cfg, batch: int, seq: int, label: str,
                    adamw_too: bool = False) -> dict:
    """``cfg`` (fp32) on the card against the CPU from the same parameters
    and batch: the routing of every MoE layer compared first (each token's
    choice set and kept flags); where no choice flipped, the loss, the aux
    loss, the grad norm and every gradient at TRAIN_CPU_RTOL (an absolute
    floor of 1e-4 of each leaf's largest entry), and with ``adamw_too`` one
    AdamW step on the same gradients on both, the parameters, both moments
    and the learning rate at that tolerance; else "not applicable", with
    the flips counted and printed.  A model with a stub frontend takes the
    pipeline's seeded embeddings (``launch.train.data_config``)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves, tree_map

    dev, cpu = torch.device(CARD), torch.device("cpu")
    p_cpu = LT.init_state(cfg, cpu)["params"]
    p_card = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
    b = make_batch(LT.data_config(cfg, seq, batch), 0)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    runs = {}
    for name, params, where in (("card", p_card, dev), ("cpu", p_cpu, cpu)):
        records = []
        watch, apply = _routing_watch(torch, records)
        L.moe_apply = watch
        try:
            t0 = time.perf_counter()
            loss, metrics, grads = TS.batch_grads(cfg, params,
                                                  LT.batch_on(b, where))
            runs[name] = {"loss": loss, "metrics": metrics, "grads": grads,
                          "routing": records[:moe_layers],
                          "s": time.perf_counter() - t0}
        finally:
            L.moe_apply = apply
    card_r, cpu_r = runs["card"]["routing"], runs["cpu"]["routing"]
    flips = sum(int((a["top_e"].cpu() != b_["top_e"]).any(-1).sum())
                for a, b_ in zip(card_r, cpu_r))
    kept = sum(int((a["keep"].cpu() != b_["keep"]).any(-1).sum())
               for a, b_ in zip(card_r, cpu_r))
    out = {"layers": cfg.num_layers, "batch": batch, "seq": seq,
           "flipped_tokens": flips, "kept_differ_tokens": kept,
           "cpu_s": runs["cpu"]["s"]}
    if flips or kept:
        out["held"] = "not applicable"
        print(f"train {label}: {flips} tokens flipped a top-k choice and "
              f"{kept} kept other entries between the two: not applicable")
        return out
    c, h = runs["card"], runs["cpu"]

    def close(a, b_, what):
        a = a.cpu()
        floor = 1e-4 * b_.abs().max().item()
        within = (a - b_).abs() <= floor + TRAIN_CPU_RTOL * b_.abs()
        check(bool(within.all()), f"{label}: {what} {tuple(b_.shape)} "
              f"differs by {(a - b_).abs().max().item()}")
        return _max_rel(torch, a, b_)

    def rel(x, y):
        x, y = float(x), float(y)
        return abs(x / y - 1) if y else abs(x)

    rels = {"loss": rel(c["loss"], h["loss"]),
            "aux_loss": rel(c["metrics"]["aux_loss"],
                            h["metrics"]["aux_loss"]),
            "grad_norm": rel(adamw.global_norm(c["grads"]),
                             adamw.global_norm(h["grads"]))}
    check(max(rels.values()) <= TRAIN_CPU_RTOL, f"{label}: {rels}")
    worst = max(close(a, b_, "gradient") for a, b_ in
                zip(leaves(c["grads"]), leaves(h["grads"])))
    out.update(held=True, rel=rels, grads_max_rel=worst)
    note = ""
    if adamw_too:
        oc = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        g_same = tree_map(lambda t: t.to(dev), h["grads"])
        _, o_card, m_card = adamw.apply(oc, g_same, adamw.init(p_card),
                                        p_card)
        _, o_cpu, m_cpu = adamw.apply(oc, h["grads"], adamw.init(p_cpu),
                                      p_cpu)
        lr_rel = rel(m_card["lr"], m_cpu["lr"])
        check(lr_rel <= TRAIN_CPU_RTOL, f"{label}: AdamW's lr {lr_rel}")
        out["params_max_rel"] = max(close(a, b_, "parameter") for a, b_ in
                                    zip(leaves(p_card), leaves(p_cpu)))
        out["moments_max_rel"] = max(
            close(a, b_, f"AdamW's {m}") for m in ("mu", "nu")
            for a, b_ in zip(leaves(o_card[m]), leaves(o_cpu[m])))
        note = (f", AdamW on the same gradients: parameters max|Δ| / max|p|"
                f" {out['params_max_rel']:.2e}, moments "
                f"{out['moments_max_rel']:.2e}, lr rel {lr_rel:.1e}")
    print(f"train {label} (TF32 off, batch {batch} x {seq}): no top-k choice "
          f"flipped; loss rel {rels['loss']:.2e}, aux rel "
          f"{rels['aux_loss']:.2e}, grad norm rel {rels['grad_norm']:.2e}, "
          f"gradients max|Δ| / max|g| {worst:.2e}{note} (rtol "
          f"{TRAIN_CPU_RTOL}); the CPU's gradients {runs['cpu']['s']:.1f} s")
    del runs, p_card, p_cpu
    torch.cuda.empty_cache()
    return out


def moe_train_phase(torch, card: str) -> dict:
    """The MoE family's training (MOE_TRAIN_*): the backward entries
    against their plain versions at the training shapes, their times, a
    full-width MoE layer's gradients through the kernels against the plain
    versions; then granite-moe-1b-a400m at its full config and
    qwen2-moe-a2.7b at 2 layers through the trainer's step, each with its
    counters 0 just before and read just after; then the card against the
    CPU.  Returns the summary and the ``kernels`` line's row."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    checks = moe_backward_checks(torch)
    times = {a: moe_backward_times(torch, a, 30 + i)
             for i, a in enumerate(MOE_ARCHS)}
    layer = moe_layer_grad_check(torch)
    full = moe_train_run(torch, card, MOE_TRAIN_ARCH, None, TRAIN_STEPS,
                         TRAIN_STEPS)
    c = MOE_TRAIN_CUT
    cut = moe_train_run(torch, card, c["arch"], c["layers"], c["steps"],
                        c["warmup"])
    cpu = train_cpu_check(
        torch, dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                                   num_layers=TRAIN_CPU_CHECK["layers"],
                                   dtype="float32"),
        TRAIN_CPU_CHECK["batch"], TRAIN_CPU_CHECK["seq"],
        f"{MOE_TRAIN_ARCH} card vs CPU (fp32, {TRAIN_CPU_CHECK['layers']} "
        "layers)")
    mine = times[MOE_TRAIN_ARCH]["entries"]
    launches = full["moe_launches"]
    # the backward's launches; the combine's third a layer a step is its
    # dispatch_grad
    per = launches["combine"] // MOE_TRAIN_LAUNCHES["combine"]
    backward = {"dispatch_grad": per,
                "combine_grad": launches["combine_grad"],
                "gate_grad": launches["gate_grad"]}
    row = {"name": "moe_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/moe_sm90.cu",
           "replaces": "src/repro/models/layers.py:262",
           "shape": f"{MOE_TRAIN_ARCH} training, {TRAIN_BATCH} x {TRAIN_SEQ}"
                    " tokens, bf16, capacity 1.25: dispatch_grad (the "
                    "combine, unit gates) + combine_grad + gate_grad",
           "launches": sum(backward.values()),
           "launches_by_entry": backward,
           "max_abs_err": max(checks["max_abs_err"],
                              max(v["max_abs_err"] for v in layer.values())),
           "ms": sum(t["ms"] for t in mine.values()),
           "plain_ms": sum(t["plain_ms"] for t in mine.values()),
           "bound_ms": sum(t["bound_ms"] for t in mine.values()),
           "bound_by": "bytes",
           "bytes": sum(t["bytes"] for t in mine.values()),
           "floor_ms": sum(t["floor_ms"] for t in mine.values()),
           "library_ms": None,
           "entries": mine,
           "forward_dispatch": times[MOE_TRAIN_ARCH]["forward_dispatch"],
           "forward_dispatch_launches": launches["dispatch"],
           "other_configs": {a: times[a] for a in MOE_ARCHS
                             if a != MOE_TRAIN_ARCH}}
    print(f"train moe: {time.perf_counter() - t0:.1f} s")
    return {"checks": checks, "times": times, "layer": layer, "train": full,
            "train_cut": cut, "cpu_check": cpu, "row": row}


def _ssm_layers(cfg) -> int:
    return sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))


def ssm_train_run(torch, card: str) -> dict:
    """mamba2-130m at its full config through ``launch.train``'s step
    function (TRAIN_BATCH x TRAIN_SEQ, TRAIN_STEPS steps): every flash, MoE
    and SSD counter 0 just before, read just after (0 flash and MoE
    launches; the SSD entries SSM_TRAIN_LAUNCHES a layer a step); every
    loss and grad norm finite, the first loss within TRAIN_LOSS0_TOL of ln
    V, the last below the first; step s (synchronised; the median of steps
    2-N), tokens/s, peak GB and (6 N tokens + 3 x the scan's operations a
    layer) / step s: the model's products forward and backward and the
    scan's forward and backward (its backward two products for each of the
    forward's), remat's recompute left out."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.ssd import ssd
    from repro_torch.optim import adamw

    cfg = get_config(SSM_ARCH)
    check(cfg.family == "ssm" and not cfg.use_kernels
          and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
          and cfg.remat == "full", f"{SSM_ARCH}: not the trainer's config")
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=TRAIN_STEPS,
                         total_steps=TRAIN_STEPS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    run = timed_train(torch, cfg, oc, data_cfg, TRAIN_STEPS, (ssd, fa, moe))
    counts = run["counts"][0]
    flash, moe_n = (sum(c.values()) for c in run["counts"][1:])
    losses, gnorms, step_s = run["losses"], run["grad_norms"], run["step_s"]
    steady, peak = run["step_s_median"], run["peak_gb"] * 1e9
    want = {k: v * cfg.num_layers * TRAIN_STEPS
            for k, v in SSM_TRAIN_LAUNCHES.items()}
    check(counts == want, f"{SSM_ARCH}: SSD launches {counts}, expected "
          f"{want}")
    check(flash == 0 and moe_n == 0, f"{SSM_ARCH}: training launched flash "
          f"{flash} and MoE {moe_n} times")
    ln_v = check_losses(SSM_ARCH, cfg, losses, gnorms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    scan_flops = ssd_bound("scan", TRAIN_BATCH, TRAIN_SEQ, cfg.ssm_num_heads,
                           cfg.ssm_head_dim, cfg.ssm_state,
                           min(cfg.ssm_chunk, TRAIN_SEQ), 2)["flops"]
    flops = 6 * cfg.num_params() * tokens + 3 * scan_flops * cfg.num_layers
    row = {"arch": SSM_ARCH, "cut": "full config", "layers": cfg.num_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": losses, "grad_norms": gnorms, "step_s": step_s,
           "step_s_median": steady, "tokens_per_s": tokens / steady,
           "peak_gb": peak / 1e9, "flops_per_step": flops,
           "tflops": flops / steady / 1e12,
           "mfu_vs_bf16_peak": flops / steady / BF16_FLOP_PER_S,
           "ssd_launches": counts, "flash_launches": flash,
           "moe_launches": moe_n, "params": cfg.num_params()}
    print(f"train {SSM_ARCH} (full config) on {card}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (ln V {ln_v:.4f}), step {steady:.3f} s (median "
          f"of steps 2-{TRAIN_STEPS}; first {step_s[0]:.3f} s), "
          f"{tokens / steady:.0f} tokens/s, peak {peak / 1e9:.1f} GB, "
          f"~{flops / steady / 1e12:.1f} TFLOP/s = (6 N tokens + 3 x the "
          f"scan's {scan_flops / 1e9:.2f} GFLOP a layer) / step s, N = "
          f"{cfg.num_params()}, {flops / steady / BF16_FLOP_PER_S:.1%} of the"
          f" bf16 dense peak; SSD launches {counts}, flash {flash}, MoE "
          f"{moe_n}")
    return row


def ssm_plain_path_grads(torch) -> dict:
    """mamba2-130m at full width cut to TRAIN_CPU_CHECK's depth and batch,
    bf16 compute, remat full, on the card: the loss and every gradient
    through ``ssd_sm90.cu`` against those through the plain versions
    (``layers.ssd_ops`` bound to :func:`_plain_ssd_ops`), within
    SSD_TOL["bfloat16"] of each leaf's largest magnitude; the kernel path's
    launches counted."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import train as LT
    from repro_torch.models import layers as L
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    cut = TRAIN_CPU_CHECK
    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=cut["layers"])
    dev = torch.device(CARD)
    params = LT.init_state(cfg, dev)["params"]
    batch = LT.batch_on(make_batch(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=cut["seq"],
        global_batch=cut["batch"]), 0), dev)
    runs = []
    ssd.reset_launch_count()
    for ops in (L.ssd_ops, _plain_ssd_ops()):
        kernel_ops, L.ssd_ops = L.ssd_ops, ops
        try:
            runs.append(TS.batch_grads(cfg, params, batch))
        finally:
            L.ssd_ops = kernel_ops
        if len(runs) == 1:
            counts = ssd.launch_counts()
    want = {k: v * cfg.num_layers for k, v in SSM_TRAIN_LAUNCHES.items()}
    check(counts == want, f"{SSM_ARCH} kernel path: SSD launches {counts}, "
          f"expected {want}")
    (lk, _, gk), (lp, _, gp) = runs
    tol = SSD_TOL["bfloat16"][1]
    loss_err = abs(float(lk) / float(lp) - 1)
    errs = [_ssd_err(torch, a, b)[0] for a, b in zip(leaves(gk), leaves(gp))]
    check(loss_err <= tol and max(errs) <= tol and all(
        bool(torch.isfinite(g).all()) for g in leaves(gk)),
        f"{SSM_ARCH}: kernel path against the plain path: loss {loss_err}, "
        f"gradients {errs} (limit {tol})")
    names = _leaf_names(params)
    worst = max(range(len(errs)), key=errs.__getitem__)
    print(f"train {SSM_ARCH} kernel path vs plain path on the card (bf16, "
          f"{cfg.num_layers} layers, batch {cut['batch']} x {cut['seq']}): "
          f"loss rel {loss_err:.2e}, {len(errs)} gradients max|Δ| / max|g| "
          f"up to {errs[worst]:.2e} ({names[worst]}; limit {tol}); SSD "
          f"launches {counts}")
    del runs, params
    torch.cuda.empty_cache()
    return {"loss_rel": loss_err, "grads_max_rel": errs[worst],
            "worst_leaf": names[worst], "launches": counts}


def hybrid_train(torch, card: str) -> dict:
    """jamba-v0.1-52b's smoke config (4 layers: 3 SSM, 1 attention, 2 MoE)
    trained HYBRID_TRAIN's steps on the card through ``launch.train``'s
    step (bf16, fp32 state, remat full, one remat a period): every counter
    0 just before; just after, 0 flash launches, each SSD entry
    SSM_TRAIN_LAUNCHES a SSM layer a step and each MoE entry
    MOE_TRAIN_LAUNCHES a MoE layer a step; every loss finite.  Then the
    card against the CPU in fp32 (:func:`train_cpu_check`)."""
    import dataclasses
    import math

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw

    h = HYBRID_TRAIN
    cfg = get_smoke_config(HYBRID_ARCH)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{HYBRID_ARCH} smoke: not the trainer's config")
    dev = torch.device(CARD)
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=h["steps"],
                         total_steps=h["steps"])
    one_step = LT.make_step(cfg, oc, dev)
    state = LT.init_state(cfg, dev)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=h["seq"],
                          global_batch=h["batch"])
    fa.reset_launch_count()
    moe.reset_launch_count()
    ssd.reset_launch_count()
    losses, aux = [], []
    for step in range(h["steps"]):
        state, metrics = one_step(state, make_batch(data_cfg, step))
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    counts, moe_counts = ssd.launch_counts(), moe.launch_counts()
    flash = fa.launch_count()
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    want = {k: v * _ssm_layers(cfg) * h["steps"]
            for k, v in SSM_TRAIN_LAUNCHES.items()}
    want_moe = {k: v * moe_layers * h["steps"]
                for k, v in MOE_TRAIN_LAUNCHES.items()}
    check(counts == want and moe_counts == want_moe and flash == 0,
          f"{HYBRID_ARCH} smoke training: SSD {counts} (expected {want}), "
          f"MoE {moe_counts} (expected {want_moe}), flash {flash}")
    check(all(math.isfinite(v) for v in losses + aux),
          f"{HYBRID_ARCH} smoke training: non-finite {losses}, {aux}")
    print(f"train {HYBRID_ARCH} smoke ({cfg.num_layers} layers: "
          f"{_ssm_layers(cfg)} SSM, {moe_layers} MoE) on {card}: "
          f"{h['steps']} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"aux {aux[0]:.4f} -> {aux[-1]:.4f}; SSD launches {counts}, MoE "
          f"launches {moe_counts}, flash 0")
    del state
    cpu = train_cpu_check(
        torch, dataclasses.replace(cfg, dtype="float32"), h["batch"],
        h["seq"], f"{HYBRID_ARCH} smoke card vs CPU (fp32)")
    return {"losses": losses, "aux_losses": aux, "ssd_launches": counts,
            "moe_launches": moe_counts, "flash_launches": flash,
            "cpu_check": cpu}


def ssm_train_phase(torch, card: str) -> dict:
    """The SSM and hybrid families' training: :func:`ssm_train_run`, the
    card against the CPU (:func:`train_cpu_check`, mamba2-130m at full
    width and TRAIN_CPU_CHECK's cut, with AdamW on the same gradients),
    :func:`ssm_plain_path_grads` and :func:`hybrid_train`."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {"train": ssm_train_run(torch, card)}
    cut = TRAIN_CPU_CHECK
    cfg = dataclasses.replace(get_config(SSM_ARCH), num_layers=cut["layers"],
                              dtype="float32")
    out["cpu_check"] = train_cpu_check(
        torch, cfg, cut["batch"], cut["seq"],
        f"{SSM_ARCH} card vs CPU (fp32, {cut['layers']} layers)",
        adamw_too=True)
    check(out["cpu_check"]["held"] is True, f"{SSM_ARCH}: card vs CPU not "
          "held")
    out["plain_path"] = ssm_plain_path_grads(torch)
    out["hybrid"] = hybrid_train(torch, card)
    print(f"train ssm: {time.perf_counter() - t0:.1f} s")
    return out


def ssd_rows(ssm: dict, ssm_train: dict) -> list:
    """The ``kernels`` line's rows of ``ssd_sm90.cu``'s entries: each at
    mamba2-130m's training shape (step: its decode shape), its launches on
    the main path (the training run's for scan and scan_grad, the serve
    run's for step), the other shapes beside."""
    checks, times = ssm["ssd"], ssm["ssd"]["times"]
    serve_counts = ssm["ssm"]["ssd_launches"]
    train_counts = ssm_train["train"]["ssd_launches"]
    rows = []
    for entry, key, replaces in (
            ("scan", "scan mamba2-130m training", "src/repro/models/layers.py:404"),
            ("scan_grad", "scan_grad mamba2-130m training",
             "src/repro/models/layers.py:404"),
            ("step", "step mamba2-130m decode",
             "src/repro/models/layers.py:474")):
        t = times[key]
        launches = (serve_counts if entry == "step" else train_counts)[entry]
        rows.append({
            "name": f"ssd_{entry}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_sm90.cu",
            "replaces": replaces, "shape": key.split(" ", 1)[1] + ", bf16",
            "launches": launches,
            "serve_launches": {SSM_ARCH: serve_counts[entry],
                               HYBRID_ARCH: ssm["hybrid"]["ssd_launches"][entry]},
            "max_abs_err": checks["max_abs_err"][entry],
            "max_rel_err": checks["max_rel_err"][entry],
            "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "floor_ms": t["floor_ms"], "library_ms": None,
            "other_shapes": {k: {f: v[f] for f in ("ms", "plain_ms",
                                                   "bound_ms", "floor_ms")}
                             for k, v in times.items()
                             if k.split(" ", 1)[0] == entry and k != key}})
    return rows


def _train_flops(cfg, tokens: int, seq: int) -> float:
    """6 N tokens + 12 L S (H Dh) tokens: the model's matrix products
    forward and backward (N = ``cfg.active_params()``, as the reference's
    ``launch/shapes.py::model_flops``: every parameter of a dense model, the
    tied embedding counted once, as the head's product; a MoE model's
    top-k and shared experts and the rest) and attention's two products
    over the whole S x S the chunked path computes; remat's recompute and
    the MoE capacity's padded rows (up to 1.25x the routed ones) left
    out."""
    att = 12 * cfg.num_layers * seq * cfg.num_heads * cfg.resolved_head_dim
    return (6 * cfg.active_params() + att) * tokens


def _max_rel(torch, a, b) -> float:
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def train_phase(torch, card: str) -> dict:
    """olmo-1b's training path on the card (TRAIN_*): the flash counter 0
    just before the main run and 0 just after (training takes the chunked
    attention, as the reference's trainer does); every loss and grad norm
    finite, the first loss within TRAIN_LOSS0_TOL of ln(vocab), the last
    below the first; step s (synchronised), tokens/s, peak memory and the
    estimated TFLOP/s.  Then the microbatch, card-against-CPU and
    resilient-loop checks."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.tree import leaves

    dev = torch.device(CARD)
    cfg = get_config(TRAIN_ARCH)
    check(not cfg.use_kernels and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32", f"{TRAIN_ARCH}: not the "
          "trainer's config")
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=20, total_steps=TRAIN_STEPS)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    run = timed_train(torch, cfg, oc, data_cfg, TRAIN_STEPS, (fa,))
    launches = sum(run["counts"][0].values())
    losses, gnorms, step_s = run["losses"], run["grad_norms"], run["step_s"]
    steady, peak = run["step_s_median"], run["peak_gb"] * 1e9
    check(launches == 0, f"training launched flash attention {launches} "
          "times")
    ln_v = check_losses(TRAIN_ARCH, cfg, losses, gnorms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, tokens, TRAIN_SEQ)
    main = {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "losses": losses, "grad_norms": gnorms,
            "step_s": step_s, "step_s_median": steady,
            "tokens_per_s": tokens / steady, "peak_gb": peak / 1e9,
            "flops_per_step": flops, "tflops": flops / steady / 1e12,
            "mfu_vs_bf16_peak": flops / steady / BF16_FLOP_PER_S,
            "flash_launches": launches, "params": cfg.num_params()}
    print(f"train {TRAIN_ARCH} full config on {card}: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f} (ln V {ln_v:.4f}), step {steady:.3f} s "
          f"(median of steps 2-{TRAIN_STEPS}; first {step_s[0]:.3f} s), "
          f"{tokens / steady:.0f} tokens/s, peak {peak / 1e9:.1f} GB, "
          f"~{flops / steady / 1e12:.1f} TFLOP/s = (6 N tokens + 12 L S H Dh "
          f"tokens) / step s, N = {cfg.num_params()}, "
          f"{flops / steady / BF16_FLOP_PER_S:.1%} of the bf16 dense peak "
          f"989 TFLOP/s; flash launches {launches}")

    # two microbatches against one, fp32 at the full config: the summed
    # gradients and the mean loss; then the reference test's own claim
    # (the updated parameters at its atol) at its own config on the card
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = LT.init_state(cfg32, dev)["params"]
    batch = LT.batch_on(make_batch(data_cfg, 0), dev)
    l1, _, g1 = TS.batch_grads(cfg32, params, batch, 1)
    l2, _, g2 = TS.batch_grads(cfg32, params, batch, 2)
    micro_rel = max(_max_rel(torch, a, b)
                    for a, b in zip(leaves(g2), leaves(g1)))
    micro_loss = abs(float(l2) / float(l1) - 1)
    del params, g1, g2
    torch.cuda.empty_cache()
    check(micro_rel <= TRAIN_GRAD_RTOL and micro_loss <= TRAIN_GRAD_RTOL,
          f"2 microbatches against one batch: gradients {micro_rel}, loss "
          f"{micro_loss} (rtol {TRAIN_GRAD_RTOL})")
    scfg = dataclasses.replace(get_smoke_config("qwen2-1.5b"),
                               dtype="float32", remat="none")
    oc1 = adamw.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    sbatch = make_batch(DataConfig(vocab_size=scfg.vocab_size, seq_len=16,
                                   global_batch=4), 0)
    stepped = [LT.make_step(scfg, oc1, dev, n)(LT.init_state(scfg, dev),
                                              sbatch)[0]["params"]
               for n in (1, 2)]
    smoke_diff = max((a - b).abs().max().item()
                     for a, b in zip(*map(leaves, stepped)))
    check(smoke_diff <= TRAIN_MICRO_ATOL, f"2 microbatches against one step "
          f"(qwen2-1.5b smoke): max|Δparam| {smoke_diff}")
    print(f"train microbatches 2 vs 1 (fp32, full config, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): gradients max|Δ| / max|g| "
          f"{micro_rel:.2e}, loss rel {micro_loss:.2e} (rtol "
          f"{TRAIN_GRAD_RTOL}); one step of the qwen2-1.5b smoke config "
          f"(tests/test_system.py's): max|Δparam| {smoke_diff:.3e} (atol "
          f"{TRAIN_MICRO_ATOL})")

    # the card against the CPU, fp32, TF32 off, full width cut in depth:
    # the loss and every gradient, then AdamW on the same gradients
    cut = TRAIN_CPU_CHECK
    cpu_check = train_cpu_check(
        torch, dataclasses.replace(cfg, num_layers=cut["layers"],
                                   dtype="float32"),
        cut["batch"], cut["seq"], f"{TRAIN_ARCH} card vs CPU ({cut['layers']}"
        " layers)", adamw_too=True)
    check(cpu_check["held"] is True, f"{TRAIN_ARCH}: card vs CPU not held")

    # the resilient loop in a fresh process: deterministic algorithms and
    # cuBLAS's workspace set from its start
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--train-resume", str(TRAIN_CKPT)], env=env,
                          capture_output=True, text=True, timeout=900)
    resume_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    print(proc.stdout[-3000:], end="")
    check(proc.returncode == 0, f"train resume child failed: "
          f"{proc.stderr[-3000:]}")
    resume = json.loads(proc.stdout.strip().splitlines()[-1])
    check(resume["bit_equal"], f"the resilient loop's result differs from "
          f"an uninterrupted run: {resume}")
    resume["wall_s"] = resume_s
    return {"main": main, "micro": {"grad_rel": micro_rel,
                                    "loss_rel": micro_loss,
                                    "smoke_param_diff": smoke_diff},
            "cpu_check": cpu_check,
            "resume": resume}


def train_resume_child(ckpt_root: str) -> int:
    """The resilient loop on the card at TRAIN_RESUME's cut of olmo-1b
    (bf16 compute): first two uninterrupted runs with PyTorch's default
    (nondeterministic) algorithms, to show whether they already agree bit
    for bit; then, under ``torch.use_deterministic_algorithms(True)``, an
    uninterrupted run and one with a failure injected at ``fail_at``
    through ``resilient_train_loop``, each checkpointing every
    ``ckpt_every`` steps; prints a JSON line."""
    import dataclasses

    import torch

    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import FaultConfig, resilient_train_loop
    from repro_torch.tree import leaves

    r = TRAIN_RESUME
    dev = torch.device(CARD)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=r["layers"])
    oc = adamw.OptConfig(lr=3e-3, warmup_steps=2, total_steps=r["steps"])
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=r["seq"],
                          global_batch=r["batch"])
    one_step = LT.make_step(cfg, oc, dev)

    def init_state():
        return LT.init_state(cfg, dev)

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    plain = []
    for _ in range(2):
        st = init_state()
        for step in range(r["steps"]):
            st, _ = one_step(st, make_batch(data_cfg, step))
        plain.append(st)
    default_equal = same(*plain)
    del plain
    torch.use_deterministic_algorithms(True)
    runs, infos = [], []
    for name, fail in (("clean", None), ("faulty", r["fail_at"])):
        failed = {fail: True}
        st, metrics, info = resilient_train_loop(
            init_state, one_step, data_cfg, r["steps"],
            FaultConfig(ckpt_dir=str(Path(ckpt_root) / name),
                        ckpt_every=r["ckpt_every"], keep=2),
            fail_at=lambda s: failed.pop(s, False), device=dev)
        runs.append(st)
        infos.append({"restarts": info["restarts"],
                      "resumed_from": info["resumed_from"],
                      "loss": float(metrics["loss"])})
    equal = same(*runs)
    print(f"train resume ({r['layers']} of "
          f"{get_config(TRAIN_ARCH).num_layers} layers, batch {r['batch']} x "
          f"{r['seq']}, {r['steps']} steps, failure at {r['fail_at']}): "
          f"default algorithms repeat bit for bit: {default_equal}; "
          f"deterministic, resumed run bit-equal: {equal} {infos}")
    print(json.dumps({"bit_equal": equal and infos[1]["restarts"] == 1,
                      "default_algorithms_bit_equal": default_equal,
                      "runs": infos, "cut": r,
                      "cublas_workspace": os.environ.get(
                          "CUBLAS_WORKSPACE_CONFIG")}))
    return 0


def _kernel_us(evt) -> float:
    """The device time of the kernels a profiler event and its descendants
    launched, each kernel counted once (from the op that launched it), in
    us."""
    return (sum(k.duration for k in getattr(evt, "kernels", []))
            + sum(_kernel_us(c) for c in evt.cpu_children))


def ssm_profile(torch, cfg, params) -> dict:
    """One ``torch.profiler`` trace each of a prefill batch (SERVE_BATCH x
    SERVE_PROMPT) and of the decode step after it, warmed up first: the
    device time of every kernel (each counted once, from the op that
    launched it) summed by kernel and by op, the SSD recurrence's share
    (the kernels under ``layers.SCAN_SPAN`` / ``STEP_SPAN``), and the busy
    share: the kernels' time over the host wall time of the call, traced
    (the profiler's cost lengthens it; a first traced call takes the
    tracer's start-up), and over the mean wall time of PROFILE_UNTRACED
    untraced calls.  The decode steps (warm-up, untraced, traced) run on
    one cache, which holds a position for each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    b, s = SERVE_BATCH, SERVE_PROMPT
    gen = torch.Generator(device=CARD).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=CARD)
    out = {}

    def run(which):
        cache = M.init_cache(cfg, b, s + 3 + PROFILE_UNTRACED, CARD)
        logits, cache = M.prefill(cfg, params, toks, cache)
        if which == "prefill":
            return logits
        torch.cuda.synchronize()
        return lambda: M.decode_step(cfg, params, cache,
                                     logits.argmax(-1, keepdim=True))

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):        # the tracer's own start-up
        run("prefill")
        torch.cuda.synchronize()
    for which, span in (("prefill", L.SCAN_SPAN), ("decode", L.STEP_SPAN)):
        fn = (lambda: run("prefill")) if which == "prefill" else run("decode")
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILE_UNTRACED):
            fn()
        torch.cuda.synchronize()
        untraced_us = (time.perf_counter() - t0) * 1e6 / PROFILE_UNTRACED
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        by_kernel, by_op = {}, {}
        for e in events:
            for k in getattr(e, "kernels", []):
                by_kernel[k.name] = by_kernel.get(k.name, 0.0) + k.duration
                by_op[e.name] = by_op.get(e.name, 0.0) + k.duration
        device_us = sum(by_kernel.values())
        scan_us = sum(_kernel_us(e) for e in events if e.name == span)
        top = dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:12])
        row = {"wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
               "busy": device_us / wall_us,
               "untraced_wall_ms": untraced_us / 1e3,
               "untraced_busy": device_us / untraced_us,
               "scan_ms": scan_us / 1e3, "span": span,
               "scan_share": scan_us / device_us if device_us else None,
               "by_op_ms": {k: v / 1e3 for k, v in top.items()},
               "by_kernel_ms": {k: v / 1e3 for k, v in sorted(
                   by_kernel.items(), key=lambda kv: -kv[1])[:8]}}
        if not device_us:
            row["note"] = ("the profiler recorded no device time: not "
                           "measured")
        out[which] = row
        print(f"profile {cfg.name} {which} ({b} x {s if which == 'prefill' else 1}"
              f" tokens): device {row['device_ms']:.3f} ms of "
              f"{row['wall_ms']:.3f} ms wall (busy {row['busy']:.1%}; "
              f"untraced {row['untraced_wall_ms']:.3f} ms, busy "
              f"{row['untraced_busy']:.1%}); {span} {row['scan_ms']:.3f} ms "
              f"({(row['scan_share'] or 0):.1%} of device time); by op "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          list(row["by_op_ms"].items())[:8]))
    return out


def ssd_bound_ms(cfg, b: int, s: int) -> dict:
    """The least time of one SSM layer's ``ssm_apply`` (s > 1) or
    ``ssm_decode`` (s = 1) on b sequences in bf16: its bytes (x in, the
    weights, out; at decode also the state and the conv window read and
    written) over HBM_BYTES_PER_S against its operations (the projections,
    the chunk's products over its lc (lc + 1) / 2 places on and below the
    diagonal, the inter-chunk and state products) over BF16_FLOP_PER_S."""
    d, di, ns, nh, hd = (cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state,
                         cfg.ssm_num_heads, cfg.ssm_head_dim)
    cw, e = cfg.ssm_conv_width, 2
    weights = d * (2 * di + 2 * ns + nh) + di * d + cw * (di + 2 * ns)
    moved = e * (weights + 2 * b * s * d)
    flops = 2 * b * s * (d * (2 * di + 2 * ns + nh) + di * d)
    if s > 1:
        lc = min(cfg.ssm_chunk, s)
        flops += 2 * b * -(-s // lc) * (lc * (lc + 1) // 2 * (ns + nh * hd)
                                        + lc * 2 * ns * nh * hd)
    else:
        moved += e * 2 * b * (nh * hd * ns + (cw - 1) * (di + 2 * ns))
        flops += 2 * b * 2 * ns * nh * hd
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bytes": moved, "flops": flops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ssd_times(torch, cfg, params) -> dict:
    """One SSM layer of ``cfg`` at the serving shapes in bf16: ``ssm_apply``
    on SERVE_BATCH x SERVE_PROMPT and ``ssm_decode`` on SERVE_BATCH tokens
    (CUDA events, eagerly: the plain torch ops are the implementation),
    each beside :func:`ssd_bound_ms`."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    lp = M._layer(params["blocks"], 0)["ssm"]
    gen = torch.Generator(device=CARD).manual_seed(6)
    b, s = SERVE_BATCH, SERVE_PROMPT
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=CARD).to(
        L.compute_dtype(cfg))
    _, (state, conv) = L.ssm_apply(cfg, lp, x, return_state=True)
    xt = x[:, -1:].contiguous()
    out = {"apply": {"ms": time_ms(lambda: L.ssm_apply(cfg, lp, x), 20),
                     **ssd_bound_ms(cfg, b, s),
                     "shape": f"{b} x {s}"},
           "decode": {"ms": time_ms(lambda: L.ssm_decode(cfg, lp, xt, state,
                                                         conv), 50),
                      **ssd_bound_ms(cfg, b, 1), "shape": f"{b} x 1"}}
    for name, t in out.items():
        t["share"] = t["bound_ms"] / t["ms"]
        print(f"ssd {name} {cfg.name} {t['shape']} bf16: {t['ms'] * 1e3:.1f}"
              f" us a layer, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}), {t['share']:.1%} of it")
    return out


def _plain_ssd_ops():
    """The SSD ops module's names bound to the plain versions (the scan
    with its plain backward, ``ref.scan``; ``ref.step_ref``): the model's
    plain path on the card, for the kernel path's comparison."""
    import types

    from repro_torch.kernels.ssd import ref

    return types.SimpleNamespace(scan=ref.scan, step=ref.step_ref)


def _reordered_ssd_ops(torch, order: str):
    """The plain versions with every contraction of the plain scan
    (``ref.scan_ref``'s einsums over the chunk's steps and over the state)
    summed in another order: the contracted index taken ``order``-wise
    (SCAN_ORDERS) in both operands, the same products and roundings; the
    cumsum in order.  A plain path that differs from
    :func:`_plain_ssd_ops`' only in the scans' summation order."""
    import types

    from repro_torch.kernels.ssd import ref

    def perm(n, device):
        i = torch.arange(n, device=device)
        if order == "reversed":
            return i.flip(0)
        if order == "even-odd":
            return torch.cat([i[0::2], i[1::2]])
        return torch.roll(i, n // 2)

    class Reordered:
        def __getattr__(self, name):
            return getattr(torch, name)

        def einsum(self, eq, a, b):
            ins, out = eq.split("->")
            sa, sb = ins.split(",")
            for ch in (set(sa) & set(sb)) - set(out):
                ia, ib = sa.index(ch), sb.index(ch)
                p = perm(a.shape[ia], a.device)
                a, b = a.index_select(ia, p), b.index_select(ib, p)
            return torch.einsum(eq, a, b)

    def scan(dt, xh, Bmat, Cmat, A, lc):
        kept, ref.torch = ref.torch, Reordered()
        try:
            return ref.scan_ref(dt, xh, Bmat, Cmat, A, lc)[:2]
        finally:
            ref.torch = kept

    return types.SimpleNamespace(scan=scan, step=ref.step_ref)


def ssd_inputs(torch, b: int, s: int, s_in: int, nh: int, hd: int, ns: int,
               dtype, seed: int):
    """Scan inputs on the card as ``ssm_apply`` makes them: dt a softplus,
    0 past ``s_in`` (the padded steps); A = -exp(A_log)."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=gen, device=CARD) - 1.0)
    dt[:, s_in:] = 0.0
    xh = torch.randn((b, s, nh, hd), generator=gen, device=CARD).to(dtype)
    B = torch.randn((b, s, ns), generator=gen, device=CARD).to(dtype)
    C = torch.randn((b, s, ns), generator=gen, device=CARD).to(dtype)
    A = -torch.exp(0.5 * torch.randn((nh,), generator=gen, device=CARD))
    return dt, xh, B, C, A


def ssd_bound(entry: str, b: int, s: int, nh: int, hd: int, ns: int,
              lc: int, elem: int, width: int = 0, cw: int = 4) -> dict:
    """The least time of one SSD entry on the H100: its bytes (each input
    read once, each output written once) over HBM_BYTES_PER_S against its
    operations over the peak of the compute dtype (bf16's tensor cores,
    fp32's FMA).  scan: dt, xh, B, C, A in, y, the final state and the
    per-chunk states out; its products over each chunk's lc (lc + 1) / 2
    places on and below the diagonal (the scores, the masked scores times
    x; the kernel skips the tiles above it) and the state's (C times the
    state, the contribution), 2 b nc (lc (lc + 1) / 2 (ns + nh hd)
    + 2 lc ns nh hd).
    scan_grad: the inputs, the states and dy in, dxh, ddt, dB, dC, dA out;
    two products for each of the forward's.  step: the state read and
    written, the conv window read and its tail written, xh, B, C, dt in, y
    out; bound by bytes (its ~8 operations a state value are not
    counted)."""
    nc = s // lc
    peak = BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S
    fwd = 2 * b * nc * (lc * (lc + 1) // 2 * (ns + nh * hd)
                        + lc * 2 * ns * nh * hd)
    if entry == "scan":
        moved = (4 * (b * s * nh + nh)
                 + elem * (2 * b * s * nh * hd + 2 * b * s * ns
                           + (1 + nc) * b * nh * hd * ns))
        flops = fwd
    elif entry == "scan_grad":
        moved = (4 * (2 * b * s * nh + 2 * nh)
                 + elem * (3 * b * s * nh * hd + 4 * b * s * ns
                           + nc * b * nh * hd * ns))
        flops = 2 * fwd
    else:
        moved = (4 * (b * nh + nh)
                 + elem * (2 * b * nh * hd * ns + (2 * cw - 1) * b * width
                           + 2 * b * nh * hd + 2 * b * ns))
        flops = 0
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bytes": moved, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _ssd_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, max |got - want|)."""
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30), d


def ssd_kernel_checks(torch) -> dict:
    """``ssd_sm90.cu``'s three entries against their plain versions on the
    card at SSD_SHAPES and SSD_STEP in bf16 and fp32 (SSD_TOL; step's state
    and conv window bit for bit), each run twice bit for bit; then each
    entry at SSD_TIMED's shapes and the step shapes in bf16 timed from a
    CUDA graph beside its bound (:func:`ssd_bound`) and launch floor, the
    plain version eagerly.  Launches here are comparisons, not the main
    path."""
    from repro_torch.kernels.ssd import ref, ssd

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    out = {"cases": [], "times": {}}
    worst = {"scan": 0.0, "scan_grad": 0.0, "step": 0.0}
    worst_abs = dict(worst)
    for seed, (name, (b, s, s_in, nh, hd, ns, lc)) in enumerate(
            SSD_SHAPES.items()):
        for dtype in (torch.bfloat16, torch.float32):
            tol_f, tol_b = SSD_TOL[str(dtype).split(".")[-1]]
            args = ssd_inputs(torch, b, s, s_in, nh, hd, ns, dtype, 60 + seed)
            got = ssd._forward_scan(*args, lc)
            again = ssd._forward_scan(*args, lc)
            want = ref.scan_ref(*args, lc)
            errs = {}
            for key, g, a, w in zip(("y", "final", "states"), got, again,
                                    want):
                check(torch.equal(bits(g), bits(a)), f"ssd scan {name} "
                      f"{dtype}: {key} differs between two runs")
                errs[key], d = _ssd_err(torch, g, w)
                worst_abs["scan"] = max(worst_abs["scan"], d)
                check(errs[key] <= tol_f, f"ssd scan {name} {dtype}: {key} "
                      f"{errs[key]} of its largest magnitude (limit {tol_f})")
            worst["scan"] = max([worst["scan"]] + list(errs.values()))
            gen = torch.Generator(device=CARD).manual_seed(70 + seed)
            dy = torch.randn(args[1].shape, generator=gen, device=CARD).to(
                dtype)
            dy[:, s_in:] = 0
            states = want[2]
            del got, again, want
            grads = ssd.scan_grad(*args, lc, states, dy, None)
            twice = ssd.scan_grad(*args, lc, states, dy, None)
            plain = ref.scan_grad_ref(*args, lc, states, dy, None)
            for key, g, a, w in zip(("dxh", "ddt", "dB", "dC", "dA"), grads,
                                    twice, plain):
                check(torch.equal(bits(g), bits(a)), f"ssd scan_grad {name} "
                      f"{dtype}: {key} differs between two runs")
                errs[key], d = _ssd_err(torch, g, w)
                worst_abs["scan_grad"] = max(worst_abs["scan_grad"], d)
                check(bool(torch.isfinite(g).all()) and errs[key] <= tol_b,
                      f"ssd scan_grad {name} {dtype}: {key} {errs[key]} of "
                      f"its largest magnitude (limit {tol_b})")
            worst["scan_grad"] = max([worst["scan_grad"]] + [
                errs[k] for k in ("dxh", "ddt", "dB", "dC", "dA")])
            del grads, twice, plain, states
            torch.cuda.empty_cache()
            out["cases"].append({"shape": name, "dtype": str(dtype),
                                 "errors": errs})
            print(f"ssd {name} (b {b}, S {s_in} -> {s}, nh {nh}, hd {hd}, ns "
                  f"{ns}, lc {lc}) {dtype}: scan and scan_grad against the "
                  "plain versions, max|Δ| / max|ref| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (limits {tol_f} / {tol_b}); two runs bit for bit")
    for arch, (b, nh, hd, ns, width) in SSD_STEP.items():
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=CARD).manual_seed(80)

            def t(*shape):
                return torch.randn(shape, generator=gen, device=CARD).to(
                    dtype)

            state, conv, window = t(b, nh, hd, ns), t(b, 3, width), \
                t(b, 4, width)
            xh, Bv, Cv = t(b, nh, hd), t(b, ns), t(b, ns)
            dtv = torch.nn.functional.softplus(
                torch.randn((b, nh), generator=gen, device=CARD))
            A = -torch.exp(torch.randn((nh,), generator=gen, device=CARD))
            runs = []
            for _ in range(2):
                st, cv = state.clone(), conv.clone()
                runs.append((ssd.step(st, cv, window, xh, dtv, A, Bv, Cv),
                             st, cv))
            st, cv = state.clone(), conv.clone()
            want = ref.step_ref(st, cv, window, xh, dtv, A, Bv, Cv)
            for k in range(3):
                check(torch.equal(bits(runs[0][k]), bits(runs[1][k])),
                      f"ssd step {arch} {dtype}: two runs differ")
            check(torch.equal(bits(runs[0][1]), bits(st))
                  and torch.equal(bits(runs[0][2]), bits(cv)),
                  f"ssd step {arch} {dtype}: the state or the conv window "
                  "differs from the plain version's")
            err, d = _ssd_err(torch, runs[0][0], want)
            tol_f = SSD_TOL[str(dtype).split(".")[-1]][0]
            check(err <= tol_f, f"ssd step {arch} {dtype}: y {err}")
            worst["step"] = max(worst["step"], err)
            worst_abs["step"] = max(worst_abs["step"], d)
            out["cases"].append({"shape": f"{arch} decode", "dtype":
                                 str(dtype), "errors": {"y": err}})
            print(f"ssd step {arch} decode (b {b}, nh {nh}, hd {hd}, ns {ns})"
                  f" {dtype}: state and conv window bit for bit the plain "
                  f"version's, y max|Δ| / max|ref| {err:.2e}; two runs bit for"
                  " bit")
    out["max_rel_err"], out["max_abs_err"] = worst, worst_abs
    # times, bf16
    cases = ssd_timed_cases(torch)
    for key, ms in ssd_entry_times(cases).items():
        entry, kernel, plain, (b, s, nh, hd, ns, lc, width), iters = \
            cases[key]
        t = {"ms": ms, "eager_ms": time_ms(kernel, iters),
             "plain_ms": time_ms(plain, 3 if entry != "step" else 20,
                                 warmup=1 if entry != "step" else 5),
             "floor_ms": graph_ms(lambda entry=entry: ssd.launch_floor(
                 entry, b, s, nh, hd, ns, lc, torch.bfloat16), iters),
             **ssd_bound(entry, b, s, nh, hd, ns, lc, 2, width)}
        t["share"] = max(t["bound_ms"], t["floor_ms"]) / t["ms"]
        out["times"][key] = t
        print(f"ssd {key} bf16: kernel {t['ms'] * 1e3:.2f} us (eager "
              f"{t['eager_ms'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.1f} us, launch floor "
              f"{t['floor_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}: "
              f"{t['bytes'] / 1e6:.2f} MB, {t['flops'] / 1e9:.2f} GFLOP), "
              f"kernel at {t['share']:.1%} of the larger")
    return out


def ssd_timed_cases(torch) -> dict:
    """The bf16 calls of ``ssd_sm90.cu`` that are timed, in the order they
    are timed: scan at SSD_TIMED's shapes and step at SSD_STEP's, then
    scan_grad at SSD_TIMED's, so every forward time comes before any
    scan_grad runs and a ``--pair`` run times the forward under the same
    history on both sides.  {key: (entry, kernel call, plain call, (b, s,
    nh, hd, ns, lc, conv width), calls a CUDA graph)}."""
    from repro_torch.kernels.ssd import ref, ssd
    fwd, bwd = {}, {}
    for seed, name in enumerate(SSD_TIMED):
        b, s, s_in, nh, hd, ns, lc = SSD_SHAPES[name]
        args = ssd_inputs(torch, b, s, s_in, nh, hd, ns, torch.bfloat16,
                          90 + seed)
        _, _, states = ssd._forward_scan(*args, lc)
        dy = torch.randn(args[1].shape, device=CARD).to(torch.bfloat16)
        dims = (b, s, nh, hd, ns, lc, 0)
        fwd[f"scan {name}"] = (
            "scan", lambda a=args, lc=lc: ssd._forward_scan(*a, lc),
            lambda a=args, lc=lc: ref.scan_ref(*a, lc), dims, 10)
        bwd[f"scan_grad {name}"] = (
            "scan_grad",
            lambda a=args, lc=lc, st=states, dy=dy: ssd.scan_grad(
                *a, lc, st, dy),
            lambda a=args, lc=lc, st=states, dy=dy: ref.scan_grad_ref(
                *a, lc, st, dy), dims, 10)
    for arch, (b, nh, hd, ns, width) in SSD_STEP.items():
        gen = torch.Generator(device=CARD).manual_seed(81)
        state, conv, window, xh, Bv, Cv = (
            torch.randn(shape, generator=gen, device=CARD).to(torch.bfloat16)
            for shape in ((b, nh, hd, ns), (b, 3, width), (b, 4, width),
                          (b, nh, hd), (b, ns), (b, ns)))
        dtv = torch.nn.functional.softplus(torch.randn((b, nh), device=CARD))
        A = -torch.exp(torch.randn((nh,), device=CARD))
        step_args = (state, conv, window, xh, dtv, A, Bv, Cv)
        # step's dims: s the conv window's rows, lc its width, as the
        # launch floor takes them
        fwd[f"step {arch} decode"] = (
            "step", lambda a=step_args: ssd.step(*a),
            lambda a=step_args: ref.step_ref(*a),
            (b, 3, nh, hd, ns, width, width), 50)
    return {**fwd, **bwd}


def ssd_entry_times(cases: dict, reps: int = 1) -> dict:
    """ms a call of each of :func:`ssd_timed_cases`, in its order, from a
    CUDA graph of its calls: the best of ``reps``."""
    return {key: min(graph_ms(kernel, iters) for _ in range(reps))
            for key, (_, kernel, _, _, iters) in cases.items()}


def ssd_split_child(out_path: str, tree: str | None = None) -> int:
    """``python3 chip_smoke.py --ssd-split OUT [TREE]``: the device time of
    each kernel of ``ssd_sm90.cu``'s scan and scan_grad at
    :func:`ssd_timed_cases`' shapes, from one ``torch.profiler`` trace
    (CUDA activities) of 10 eager calls, beside the entry's CUDA-graph time;
    printed and written to OUT as JSON.  TREE: another checkout's kernels
    (as ``--pair`` takes them), this one's by default.  Not a phase of the
    smoke run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    check(torch.cuda.is_available(), "the split needs a card")
    src = Path(tree).resolve() / "src" if tree else SRC
    sys.path.insert(0, str(src))
    from repro_torch.kernels.ssd import ssd
    check(Path(ssd.__file__).resolve().is_relative_to(src.resolve()),
          f"imported {ssd.__file__}, not {src}'s")
    card = card_line()
    print(card, flush=True)
    cases = {k: v for k, v in ssd_timed_cases(torch).items()
             if v[0] != "step"}
    res = {"card": card, "split": {}}
    for key, ms in ssd_entry_times(cases).items():
        kernel = cases[key][1]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernel()
            torch.cuda.synchronize()
        rows = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if t > 0 and "kernel" in ev.key:
                rows[ev.key] = t / 10
        res["split"][key] = {"graph_us": ms * 1e3, "kernels_us": dict(
            sorted(rows.items(), key=lambda kv: -kv[1]))}
        print(f"{key}: graph {ms * 1e3:.1f} us, kernels "
              f"{sum(rows.values()):.1f} us", flush=True)
        for k, v in res["split"][key]["kernels_us"].items():
            print(f"   {v:9.1f} us  {k}", flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(res, indent=1))
    return 0


def _checked_ssd_ops(torch, worst: list):
    """The SSD ops through ``ssd_sm90.cu`` whose every scan also runs the
    plain scan on the same inputs: ``worst`` gains, a call, the larger of
    y's and the final state's max|Δ| / max|plain|; the kernel's results go
    on, so a prefill through these is the kernel path's."""
    import types

    from repro_torch.kernels.ssd import ref, ssd

    def scan(*args):
        got = ssd.scan(*args)
        worst.append(max(_ssd_err(torch, g, w)[0]
                         for g, w in zip(got, ref.scan(*args))))
        return got

    return types.SimpleNamespace(scan=scan, step=ssd.step)


def _prefill_with(torch, cfg, params, toks, ssd_ops=None, moe_ops=None):
    """``model.prefill`` of ``toks`` into a fresh cache on toks' device,
    with ``layers.ssd_ops`` / ``layers.moe_ops`` bound to the given
    namespaces for the call."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    kept = L.ssd_ops, L.moe_ops
    L.ssd_ops, L.moe_ops = ssd_ops or L.ssd_ops, moe_ops or L.moe_ops
    try:
        return M.prefill(cfg, params, toks, M.init_cache(
            cfg, toks.shape[0], toks.shape[1] + 1, toks.device))
    finally:
        L.ssd_ops, L.moe_ops = kept


def _prefill_errs(torch, cfg, a, b) -> dict:
    """max|Δ| / max|b| of two prefills' real-vocabulary logits and of their
    cache leaves by name (mamba's state and conv; the hybrid's sub-layers'
    state, conv, k and v), each over every layer that has it."""
    (la, ca), (lb, cb) = a, b
    v = cfg.vocab_size
    out = {"logits": _ssd_err(torch, la[:, :v].cpu(), lb[:, :v].cpu())[0]}
    d, m = {}, {}

    def walk(x, y, key=""):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], k)
            return
        x, y = x.cpu().float(), y.cpu().float()
        d[key] = max(d.get(key, 0.0), (x - y).abs().max().item())
        m[key] = max(m.get(key, 0.0), y.abs().max().item())

    walk(ca["layers"], cb["layers"])
    out.update({k: d[k] / max(m[k], 1e-30) for k in d})
    return out


def _truth_limit(vs: dict, paths) -> dict:
    """The kernel path's limit, key by key, on its distance from the wider
    prefill: SSM_PREFILL_FACTOR times the farthest of the plain ``paths``
    (names in ``vs``)."""
    return {k: SSM_PREFILL_FACTOR * max(vs[p][k] for p in paths)
            for k in vs["plain"]}


def _reordered_prefills(torch, cfg, params, toks, moe_ops=None) -> dict:
    """The plain path's prefill with its scans summed in each of
    SCAN_ORDERS (:func:`_reordered_ssd_ops`), by name."""
    return {f"plain_{o}": _prefill_with(torch, cfg, params, toks,
                                        _reordered_ssd_ops(torch, o), moe_ops)
            for o in SCAN_ORDERS}


def _prefill_bound(torch, cfg, params, toks, truth_dtype: str) -> dict:
    """``cfg``'s prefill of ``toks`` with ``params`` through the SSD
    kernels, held two ways.  Each layer's scan on the kernel path's own
    inputs against the plain scan on them within SSD_TOL[cfg.dtype][0].
    The whole prefill against the prefill of the same parameters in
    ``truth_dtype`` (the plain SSD ops): its distance, key by key, at most
    :func:`_truth_limit`: SSM_PREFILL_FACTOR times the farthest of the
    plain path on the card and, in bf16, the plain path on the CPU, in
    fp32 the plain paths with the scans summed in SCAN_ORDERS.  The kernel
    path against the plain path, and the plain path on the CPU against it
    on the card (the control: the same roundings in other summation
    orders), are printed beside it."""
    import dataclasses

    from repro_torch.tree import tree_map

    name = cfg.dtype
    calls: list = []
    kernel = _prefill_with(torch, cfg, params, toks,
                           _checked_ssd_ops(torch, calls))
    plain = _prefill_with(torch, cfg, params, toks, _plain_ssd_ops())
    t0 = time.perf_counter()
    cpu = _prefill_with(torch, cfg, tree_map(lambda t: t.cpu(), params),
                        toks.cpu())
    cpu_s = time.perf_counter() - t0
    orders = (_reordered_prefills(torch, cfg, params, toks)
              if name == "float32" else {})
    tdt = getattr(torch, truth_dtype)
    truth = _prefill_with(torch, dataclasses.replace(cfg, dtype=truth_dtype),
                          tree_map(lambda t: t.to(tdt), params), toks,
                          _plain_ssd_ops())
    tol = SSD_TOL[name][0]
    check(len(calls) == cfg.num_layers and max(calls) <= tol,
          f"{cfg.name}: the {name} prefill's scans against the plain scan on "
          f"the same inputs {calls} (limit {tol})")
    vs = {k: _prefill_errs(torch, cfg, v, truth) for k, v in
          (("kernel", kernel), ("plain", plain), ("cpu_plain", cpu),
           *orders.items())}
    held = ("plain", *orders) if orders else ("plain", "cpu_plain")
    limit = _truth_limit(vs, held)
    row = {"scan_calls": calls, "scan_limit": tol,
           "kernel_vs_plain": _prefill_errs(torch, cfg, kernel, plain),
           "cpu_plain_vs_plain": _prefill_errs(torch, cfg, cpu, plain),
           f"vs_{truth_dtype}": vs, "cpu_s": cpu_s,
           f"limit_vs_{truth_dtype}": limit, "limit_paths": held}
    check(all(vs["kernel"][k] <= lim for k, lim in limit.items()),
          f"{cfg.name}: the {name} prefill through the kernels is "
          f"{vs['kernel']} from the {truth_dtype} prefill, over its limits "
          f"{limit}")

    def fmt(e):
        return ", ".join(f"{k} {v:.2e}" for k, v in e.items())

    print(f"{cfg.name}: full-width prefill ({SERVE_BATCH} x {SERVE_PROMPT}, "
          f"{name}): each of its {len(calls)} scans through ssd_sm90.cu "
          f"against the plain scan on the same inputs, worst {max(calls):.2e}"
          f" of the largest magnitude (limit {tol}); against the "
          f"{truth_dtype} prefill of the same parameters: "
          + "; ".join(f"{k} {fmt(e)}" for k, e in vs.items())
          + f" (the kernel's limits {fmt(limit)}: {SSM_PREFILL_FACTOR} x the "
          f"farthest of {', '.join(held)}); the kernel path against the "
          "plain path: "
          f"{fmt(row['kernel_vs_plain'])}; control, the plain path on the CPU "
          f"({cpu_s:.1f} s) against it on the card: "
          f"{fmt(row['cpu_plain_vs_plain'])}")
    del kernel, plain, cpu, truth, orders
    torch.cuda.empty_cache()
    return row


def ssm_plain_prefill(torch, cfg, params) -> dict:
    """One full-width prefill (SERVE_BATCH x SERVE_PROMPT) through the SSD
    kernels against the same prefill through the plain versions
    (``layers.ssd_ops`` bound to :func:`_plain_ssd_ops`), by
    :func:`_prefill_bound`: in fp32 (its own parameters) against the
    float64 prefill of the same parameters, in bf16 (the served ``params``)
    against the fp32 one.  The paths are compared by their distance from
    the wider prefill, not with each other: the same roundings in another
    summation order move the whole prefill, a rounding a layer carried on
    through 24 layers (the plain path on the CPU lies 8.3e-5 - 9.1e-5 of
    the largest magnitude from it on the card in fp32, 6-7% in bf16)."""
    import dataclasses

    from repro_torch.models import model as M

    gen = torch.Generator(device=CARD).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                         generator=gen, device=CARD)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.init_serving_params(cfg32, torch.Generator(device=CARD)
                                .manual_seed(0))
    out = {"float32": _prefill_bound(torch, cfg32, p32, toks, "float64")}
    del p32
    out["bfloat16"] = _prefill_bound(torch, cfg, params, toks, "float32")
    return out


def ssm_serve(torch, card: str) -> dict:
    """mamba2-130m at its full config through ``launch.serve.main``, every
    flash and MoE counter 0 just before and 0 just after; its fp32 and bf16
    prefill/decode consistency; the SSD layer's times; the profile."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(SSM_ARCH), use_kernels=True)
    batches = -(-8 // SERVE_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_count()
    moe.reset_launch_count()
    ssd.reset_launch_count()
    summary = serve.main(["--arch", SSM_ARCH, "--requests", "8", "--batch",
                          str(SERVE_BATCH), "--prompt", str(SERVE_PROMPT),
                          "--gen", str(SERVE_GEN)], device=CARD)
    counts, moe_counts = fa.launch_counts(), moe.launch_counts()
    ssd_counts = ssd.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(summary["logits_finite"], f"{SSM_ARCH}: non-finite logits")
    check(summary["tokens"] == 8 * SERVE_GEN, f"{SSM_ARCH}: served "
          f"{summary['tokens']} tokens")
    check(not any(counts.values()) and not any(moe_counts.values())
          and summary["flash_launches"] == 0,
          f"{SSM_ARCH}: flash {counts}, MoE {moe_counts}: expected none")
    want_ssd = {"scan": cfg.num_layers * batches, "scan_grad": 0,
                "step": cfg.num_layers * batches * (SERVE_GEN - 1)}
    check(ssd_counts == want_ssd, f"{SSM_ARCH}: SSD launches {ssd_counts}, "
          f"expected {want_ssd}")
    row = {k: summary[k] for k in ("tok_per_s", "prefill_s", "decode_s",
                                   "wall_s")}
    row.update(layers=cfg.num_layers, params=cfg.num_params(), peak_gb=peak,
               flash_launches=0, moe_launches=moe_counts,
               ssd_launches=ssd_counts)
    print(f"serve {SSM_ARCH} ({cfg.num_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B parameters) on {card}: "
          f"{row['tok_per_s']:.1f} tok/s, prefill {row['prefill_s']:.3f} s, "
          f"decode {row['decode_s']:.3f} s, wall {row['wall_s']:.3f} s, "
          f"peak {peak:.2f} GB, flash and MoE launches 0, SSD launches "
          f"{ssd_counts}")
    row["float32"] = consistency(torch, "float32", cfg)
    params = M.init_serving_params(cfg, torch.Generator(device=CARD)
                                   .manual_seed(0))
    row["bfloat16"] = consistency(torch, "bfloat16", cfg, params,
                                  limit=CONSIST_TOL["bfloat16"])
    check(not any(fa.launch_counts().values()), "the SSM consistency "
          "prefills launched flash attention")
    row["plain_path"] = ssm_plain_prefill(torch, cfg, params)
    row["ssd"] = ssd_times(torch, cfg, params)
    row["ssd"]["launches"] = {"apply": want_ssd["scan"],
                              "decode": want_ssd["step"]}
    row["profile"] = ssm_profile(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    return row


def _hybrid_plain_paths(torch, cfg, params, toks, ssm_layers: int) -> dict:
    """The hybrid's prefill of ``toks`` through the kernels against its
    plain paths: with only the MoE entries bound to their plain versions,
    bit for bit (logits and every cache leaf); with the SSD ops bound to
    theirs as well (the all-plain path), each of the kernel path's
    ``ssm_layers`` scans against the plain scan on its own inputs within
    SSD_TOL[cfg.dtype][0], and the whole prefill's difference from the
    all-plain path's (logits and every cache leaf) reported.  In fp32 the
    whole prefill is held as :func:`_prefill_bound` holds mamba2-130m's:
    its distance from the float64 prefill of the same parameters (the plain
    versions, the chunked attention; each weight cast at its use, so no
    float64 tree is made), key by key (:func:`_prefill_errs`), at most
    SSM_PREFILL_FACTOR times the farthest of the all-plain path and the
    same with its scans summed in SCAN_ORDERS."""
    import dataclasses

    calls: list = []
    logits_k, cache_k = _prefill_with(torch, cfg, params, toks,
                                      _checked_ssd_ops(torch, calls))
    logits_p, cache_p = _prefill_with(torch, cfg, params, toks,
                                      moe_ops=_plain_moe_ops())
    same = torch.equal(logits_k, logits_p) and all(
        torch.equal(t, cache_p["layers"][sub][key])
        for sub, leaves in cache_k["layers"].items()
        for key, t in leaves.items())
    check(same, f"{cfg.name} ({cfg.dtype}): the kernel path's prefill "
          "differs from the path with the MoE entries' plain versions")
    del logits_p, cache_p
    tol = SSD_TOL[cfg.dtype][0]
    check(len(calls) == ssm_layers and max(calls) <= tol,
          f"{cfg.name} ({cfg.dtype}): the prefill's scans against the plain "
          f"scan on the same inputs {calls} (limit {tol})")
    plain = _prefill_with(torch, cfg, params, toks, _plain_ssd_ops(),
                          _plain_moe_ops())
    logits_p, cache_p = plain
    v = cfg.vocab_size
    whole = {"logits": _ssd_err(torch, logits_k[:, :v], logits_p[:, :v])[0]}
    for sub, leaves in cache_k["layers"].items():
        for key, t in leaves.items():
            whole[f"{sub}.{key}"] = _ssd_err(torch, t,
                                             cache_p["layers"][sub][key])[0]
    out = {"moe_plain_equal": True, "scan_calls": calls, "scan_limit": tol,
           "all_plain_logits": whole["logits"], "all_plain": whole}
    held = ""
    if cfg.dtype == "float32":
        orders = _reordered_prefills(torch, cfg, params, toks,
                                     _plain_moe_ops())
        truth = _prefill_with(
            torch, dataclasses.replace(cfg, dtype="float64",
                                       use_kernels=False),
            params, toks, _plain_ssd_ops(), _plain_moe_ops())
        vs = {k: _prefill_errs(torch, cfg, p, truth) for k, p in
              (("kernel", (logits_k, cache_k)), ("plain", plain),
               *orders.items())}
        limit = _truth_limit(vs, ("plain", *orders))
        del truth, orders
        check(all(vs["kernel"][k] <= lim for k, lim in limit.items()),
              f"{cfg.name} (float32, {cfg.num_layers} layers): the prefill "
              f"through the kernels is {vs['kernel']} from the float64 "
              f"prefill, over its limits {limit}")
        out.update(vs_float64=vs, limit_vs_float64=limit)
        held = ("; against the float64 prefill of the same parameters: "
                + "; ".join(f"{k} " + ", ".join(
                    f"{n} {e:.2e}" for n, e in vs[k].items()) for k in vs)
                + f" (the kernel's limits: {SSM_PREFILL_FACTOR} x the "
                "farthest plain distance)")
    del logits_k, cache_k, logits_p, cache_p, plain
    torch.cuda.empty_cache()
    print(f"{cfg.name}: full-width prefill ({toks.shape[0]} x "
          f"{toks.shape[1]}, {cfg.dtype}, {cfg.num_layers} layers) through "
          "the kernels equals, bit for bit, the path with the MoE entries' "
          f"plain versions (logits and every cache leaf); each of its "
          f"{len(calls)} scans against the plain scan on the same inputs, "
          f"worst {max(calls):.2e} of the largest magnitude (limit {tol}); "
          "with the SSD's plain versions too, the logits differ by "
          f"{whole['logits']:.2e} of their largest magnitude, the cache "
          f"leaves by at most {max(whole.values()):.2e} (reported){held}")
    return out


def hybrid_serve(torch, card: str) -> dict:
    """jamba-v0.1-52b at full width and HYBRID_LAYERS layers through
    ``launch.serve.generate``, as granite-34b: every counter 0 just before;
    just after, the bf16 flash kernel launched attention layers x prefill
    batches times and each MoE forward entry MoE layers x prefill batches x
    SERVE_GEN times, scan SSM layers x batches and step SSM layers x
    batches x (SERVE_GEN - 1); the entries dropped; the decode time of each
    batch beside a warm batch's, and a ``torch.profiler`` trace of a
    prefill and a decode step (:func:`ssm_profile`); the kernel path
    against the plain paths (:func:`_hybrid_plain_paths`: bit for bit the
    path with the MoE's plain versions, each scan against the plain scan on
    the same inputs, the all-plain prefill's difference reported); bf16
    consistency under the MoE premise; at HYBRID_FP32's depth where it
    fits, the same in fp32, the whole prefill held against the float64
    prefill, and the fp32 consistency."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe import moe
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS, use_kernels=True)
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    batches = -(-8 // SERVE_BATCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_serving_params(cfg, torch.Generator(device=CARD)
                                   .manual_seed(0))
    rng = np.random.default_rng(0)
    batch_prefill, batch_decode = [], []
    finite, dropped = True, 0
    fa.reset_launch_count()
    moe.reset_launch_count()
    ssd.reset_launch_count()
    t0 = time.perf_counter()
    for _ in range(batches):
        prompt = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=CARD)
        g = serve.generate(cfg, params, prompt, SERVE_GEN,
                           SERVE_PROMPT + SERVE_GEN)
        batch_prefill.append(g.prefill_s)
        batch_decode.append(g.decode_s)
        finite = finite and g.finite
        dropped += g.prefill_dropped
    wall = time.perf_counter() - t0
    prefill_s, decode_s = sum(batch_prefill), sum(batch_decode)
    counts, moe_counts = fa.launch_counts(), moe.launch_counts()
    ssd_counts = ssd.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(finite, f"{HYBRID_ARCH}: non-finite logits")
    ssm_layers = cfg.num_layers - attn
    want_ssd = {"scan": ssm_layers * batches, "scan_grad": 0,
                "step": ssm_layers * batches * (SERVE_GEN - 1)}
    check(ssd_counts == want_ssd, f"{HYBRID_ARCH}: SSD launches "
          f"{ssd_counts}, expected {want_ssd}")
    want = attn * batches
    check(counts == {**dict.fromkeys(counts, 0), "sm90_bf16": want},
          f"{HYBRID_ARCH}: flash launches {counts}, expected {want} of "
          "sm90_bf16")
    want_moe = moe_layers * batches * SERVE_GEN
    check(moe_counts == {**dict.fromkeys(moe_counts, 0),
                         **dict.fromkeys(MOE_FORWARD, want_moe)},
          f"{HYBRID_ARCH}: MoE launches {moe_counts}, expected {want_moe} "
          "of each forward entry")
    row = {"layers": cfg.num_layers, "reduced": {
        "num_layers": f"{HYBRID_LAYERS} of {full.num_layers}"},
        "params": cfg.num_params(), "tok_per_s": 8 * SERVE_GEN / wall,
        "prefill_s": prefill_s, "decode_s": decode_s, "wall_s": wall,
        "prefill_dropped": dropped, "flash_launches": want,
        "moe_launches": moe_counts, "ssd_launches": ssd_counts,
        "peak_gb": peak}
    print(f"serve {HYBRID_ARCH} ({cfg.num_layers} of {full.num_layers} "
          f"layers, {cfg.num_params() / 1e9:.2f} B parameters) on {card}: "
          f"{row['tok_per_s']:.1f} tok/s, prefill {prefill_s:.3f} s, decode "
          f"{decode_s:.3f} s, wall {wall:.3f} s, flash launches {want} "
          f"(sm90_bf16), MoE launches {moe_counts}, SSD launches "
          f"{ssd_counts}, entries dropped in prefill {dropped}, peak "
          f"{peak:.1f} GB")

    # a warm batch after the counted ones: the first counted batch builds
    # nothing, but is the first at these shapes in this process
    warm = serve.generate(cfg, params, torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=CARD),
        SERVE_GEN, SERVE_PROMPT + SERVE_GEN)
    row.update(batch_prefill_s=batch_prefill, batch_decode_s=batch_decode,
               warm_prefill_s=warm.prefill_s, warm_decode_s=warm.decode_s)
    print(f"{HYBRID_ARCH}: decode s by batch {batch_decode}, then a warm "
          f"batch {warm.decode_s:.3f} s (prefill s {batch_prefill}, warm "
          f"{warm.prefill_s:.3f} s)")
    row["profile"] = ssm_profile(torch, cfg, params)

    gen = torch.Generator(device=CARD).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                         generator=gen, device=CARD)
    row["plain_path"] = _hybrid_plain_paths(torch, cfg, params, toks,
                                            ssm_layers)
    row.update(moe_consistency(torch, cfg, params,
                               batch=HYBRID_CONSIST_BATCH))
    del params
    torch.cuda.empty_cache()

    # fp32 at one period, where its tree fits beside its caches: the kernel
    # path against the plain paths as in bf16, then the consistency
    c32 = dataclasses.replace(cfg, num_layers=HYBRID_FP32["layers"],
                              dtype="float32")
    need = 4 * c32.num_params()
    free = torch.cuda.mem_get_info()[0]
    if need * 1.25 > free:
        why = (f"not run: the fp32 tree at {c32.num_layers} layers takes "
               f"{need / 1e9:.1f} GB, {free / 1e9:.1f} GB free")
        print(f"{HYBRID_ARCH} float32: {why}")
        row["float32"] = {"layers": c32.num_layers, "why": why}
    else:
        params = M.init_serving_params(c32, torch.Generator(device=CARD)
                                       .manual_seed(1))
        errs = _hybrid_plain_paths(torch, c32, params, toks,
                                   _ssm_layers(c32))
        row["float32"] = moe_consistency(torch, c32, params, "float32",
                                         batch=HYBRID_FP32["batch"])
        row["float32"].update(layers=c32.num_layers,
                              params=c32.num_params(), plain_path=errs)
        del params
    torch.cuda.empty_cache()
    return row


def ssm_phase(torch, card: str) -> dict:
    """The SSD kernels against their plain versions and timed
    (:func:`ssd_kernel_checks`), then the SSM and hybrid families served:
    :func:`ssm_serve` and :func:`hybrid_serve`."""
    out = {"ssd": ssd_kernel_checks(torch)}
    out.update(ssm=ssm_serve(torch, card), hybrid=hybrid_serve(torch, card))
    return out


def _tree_params(cfg) -> int:
    """The parameters of ``cfg``'s tree (``model.param_shapes``), counted
    exactly: the config's ``num_params`` counts a SwiGLU MLP where the
    encoder-decoder has a gelu one."""
    import math

    from repro_torch.models import model as M

    def walk(tree):
        return sum(walk(v) if isinstance(v, dict) else math.prod(v)
                   for v in tree.values())
    return walk(M.param_shapes(cfg))


def _encdec_train_flops(cfg, batch: int, seq: int) -> float:
    """6 B (T (N_enc + N_xkv) + S N_dec) + 12 B H Dh (L_enc T^2 + L S^2 + L S
    T): the matrix products forward and backward (T frames through the
    encoder's N_enc parameters and each decoder layer's cross k / v
    projections N_xkv; S tokens through the decoder's other N_dec, the tied
    head once) and attention's two products over the whole squares the
    chunked path computes (the encoder's, the decoder's self-attention
    and the cross-attention's S x T); norms and remat's recompute left
    out."""
    d, f, t, layers = cfg.d_model, cfg.d_ff, cfg.encoder_seq, cfg.num_layers
    hd = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    attn = 2 * d * hd + 2 * d * kv
    enc = cfg.encoder_layers * (attn + 2 * d * f)
    xkv = layers * 2 * d * kv
    dec = layers * (attn + 2 * d * hd + 2 * d * f) + cfg.padded_vocab * d
    att = hd * (cfg.encoder_layers * t * t + layers * seq * seq
                + layers * seq * t)
    return 6 * batch * (t * (enc + xkv) + seq * dec) + 12 * batch * att


def _vlm_train_flops(cfg, batch: int, seq: int) -> float:
    """6 B (S_all N_layers + S V d) + 12 L S_all^2 H Dh B: the layers'
    products over the vision prefix and the tokens (S_all = vision + S),
    the untied head over the S text positions that carry the loss (the
    input embedding is a gather, no product), attention as
    :func:`_train_flops`."""
    s_all = cfg.vision_tokens + seq
    layers = _tree_params(cfg) - 2 * cfg.padded_vocab * cfg.d_model
    att = 12 * cfg.num_layers * s_all * s_all * cfg.num_heads \
        * cfg.resolved_head_dim
    return batch * (6 * (s_all * layers + seq * cfg.padded_vocab
                         * cfg.d_model) + att)


def frontend_train_run(torch, card: str, cfg, run: dict, flops_fn,
                       cut: str) -> dict:
    """``cfg`` trained ``run["steps"]`` steps (:func:`timed_train`, AdamW
    at ``run["lr"]`` after ``run["warmup"]`` steps of warmup) on the
    pipeline's batches of ``run["batch"]`` x ``run["seq"]`` tokens with the
    stub frontend's seeded embeddings (``launch.train.data_config``): the
    flash counter 0 just before and 0 just after (training takes the
    chunked attention), :func:`check_losses`; step s, text tokens/s and
    positions/s (the tokens and the frontend's embeddings), peak GB and
    ``flops_fn(cfg, batch, seq)`` / step s."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw

    check(not cfg.use_kernels and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32" and cfg.remat == "full",
          f"{cfg.name}: not the trainer's config")
    steps, batch, seq = run["steps"], run["batch"], run["seq"]
    oc = adamw.OptConfig(lr=run["lr"], warmup_steps=run["warmup"],
                         total_steps=steps)
    data_cfg = LT.data_config(cfg, seq, batch)
    out = timed_train(torch, cfg, oc, data_cfg, steps, (fa,))
    launches = sum(out["counts"][0].values())
    check(launches == 0, f"{cfg.name}: training launched flash attention "
          f"{launches} times")
    losses, steady = out["losses"], out["step_s_median"]
    ln_v = check_losses(cfg.name, cfg, losses, out["grad_norms"])
    front = data_cfg.frontend[1] if data_cfg.frontend else 0
    flops = flops_fn(cfg, batch, seq)
    row = {"arch": cfg.name, "cut": cut, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers, "batch": batch, "seq": seq,
           "frontend_positions": front, "steps": steps, "losses": losses,
           "grad_norms": out["grad_norms"], "step_s": out["step_s"],
           "step_s_median": steady, "tokens_per_s": batch * seq / steady,
           "positions_per_s": batch * (seq + front) / steady,
           "peak_gb": out["peak_gb"], "flops_per_step": flops,
           "tflops": flops / steady / 1e12,
           "mfu_vs_bf16_peak": flops / steady / BF16_FLOP_PER_S,
           "flash_launches": launches, "params": _tree_params(cfg)}
    print(f"train {cfg.name} ({cut}, {row['params'] / 1e9:.3f} B parameters)"
          f" on {card}: batch {batch} x ({front} + {seq}), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (ln V {ln_v:.4f}), step "
          f"{steady:.3f} s (median of steps 2-{steps}; first "
          f"{out['step_s'][0]:.3f} s), {row['tokens_per_s']:.0f} text "
          f"tokens/s ({row['positions_per_s']:.0f} positions/s), peak "
          f"{row['peak_gb']:.1f} GB, ~{row['tflops']:.1f} TFLOP/s "
          f"({flops_fn.__name__}), {row['mfu_vs_bf16_peak']:.1%} of the bf16"
          f" dense peak; flash launches {launches}")
    return row


def encdec_phase(torch, card: str) -> dict:
    """whisper-medium (ENCDEC_*; served in :func:`serve_more`): its fp32
    prefill/decode consistency at full config over the 448-token text
    context with seeded audio frames, every flash counter 0 just before
    and 2 x layers launches of the fp32 kernel just after; trained at its
    full config (:func:`frontend_train_run`); the card against the CPU in
    fp32 at ENCDEC_CPU_CHECK's cut (:func:`train_cpu_check`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa

    base = get_config(ENCDEC_ARCH)
    fa.reset_launch_count()
    consist = consistency(torch, "float32", base,
                          seq=CONSIST_SEQ[ENCDEC_ARCH])
    consist["layers"] = base.num_layers
    counts = fa.launch_counts()
    check(counts == {**dict.fromkeys(counts, 0),
                     "sm90_fp32": 2 * base.num_layers},
          f"{ENCDEC_ARCH} fp32 consistency prefills launched {counts}")
    torch.cuda.empty_cache()
    train = frontend_train_run(
        torch, card, base, ENCDEC_TRAIN, _encdec_train_flops, "full config")
    cut = ENCDEC_CPU_CHECK
    small = dataclasses.replace(base, num_layers=cut["layers"],
                                encoder_layers=cut["layers"], dtype="float32")
    cpu_check = train_cpu_check(
        torch, small, cut["batch"], cut["seq"], f"{ENCDEC_ARCH} card vs CPU "
        f"({cut['layers']} + {cut['layers']} layers, {base.encoder_seq} "
        "frames)", adamw_too=True)
    check(cpu_check["held"] is True, f"{ENCDEC_ARCH}: card vs CPU not held")
    return {"consistency_fp32": consist, "train": train,
            "cpu_check": cpu_check}


def vlm_phase(torch, card: str) -> dict:
    """internvl2-76b at full width (VLM_*; served in :func:`serve_more`):
    its fp32 prefill/decode consistency at VLM_FP32_LAYERS over the vision
    prefix and CONSIST_SEQ's tokens, every flash counter 0 just before
    and 2 x layers launches of the fp32 kernel just after; trained at
    VLM_TRAIN's cut (:func:`frontend_train_run`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa

    base = get_config(VLM_ARCH)
    small = dataclasses.replace(base, num_layers=VLM_FP32_LAYERS)
    fa.reset_launch_count()
    consist = consistency(torch, "float32", small,
                          seq=CONSIST_SEQ[VLM_ARCH])
    consist["layers"] = small.num_layers
    counts = fa.launch_counts()
    check(counts == {**dict.fromkeys(counts, 0),
                     "sm90_fp32": 2 * small.num_layers},
          f"{VLM_ARCH} fp32 consistency prefills launched {counts}")
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(base, num_layers=VLM_TRAIN["layers"])
    train = frontend_train_run(
        torch, card, tcfg, VLM_TRAIN, _vlm_train_flops,
        f"full width, {tcfg.num_layers} of {base.num_layers} layers")
    return {"consistency_fp32": consist, "train": train}


def serve_phase(torch, card: str) -> dict:
    """qwen2-1.5b through ``launch.serve.main`` (SERVE_ARGS): every flash
    counter 0 just before and, just after, 28 layers x SERVE_BATCHES
    launches, all of the bf16 kernel; then its fp32 and bf16
    prefill/decode consistency, 2 x 28 launches of each dtype's kernel."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import serve

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
            fp32_launches = counts[name]
        torch.cuda.empty_cache()
    print(f"serve summary: {json.dumps(summary)}")
    return {"summary": summary, "launches": launches,
            "fp32_launches": fp32_launches}


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

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build", build_all, build)

    flash_row, fp32_row, fma_row = phase("flash", flash_phase, torch)

    # the serving path: counters at 0 just before, read just after
    served = phase("serve", serve_phase, torch, card)
    flash_row["launches"] = served["launches"]
    fp32_row["launches"] = served["fp32_launches"]

    # olmo-1b, granite-34b (16 of 88 layers), whisper-medium and
    # internvl2-76b (16 of 80 layers): counters at 0 just before each, read
    # just after
    more = phase("serve_more", serve_more, torch, card)
    flash_row["serve_launches"] = {"qwen2-1.5b": served["launches"], **{
        k: v["flash_launches"] for k, v in more.items()}}
    print(f"serve more: {json.dumps(more)}")

    # the MoE family: the dispatch/combine kernel against its plain version,
    # then both MoE configs served at full width (counters at 0 just before
    # each serve, read just after)
    moe = phase("moe", moe_phase, torch, card)
    flash_row["serve_launches"].update({
        k: v["flash_launches"] for k, v in moe["serve"].items()})
    print(f"moe summary: {json.dumps({k: moe[k] for k in ('checks', 'serve')})}")

    # the SSM and hybrid families: mamba2-130m through launch.serve.main,
    # jamba-v0.1-52b at full width and 16 layers (counters at 0 just before
    # each serve, read just after)
    ssm = phase("ssm", ssm_phase, torch, card)
    flash_row["serve_launches"][HYBRID_ARCH] = ssm["hybrid"]["flash_launches"]
    flash_row["serve_launches"][SSM_ARCH] = 0
    moe["row"]["serve_launches"][HYBRID_ARCH] = ssm["hybrid"]["moe_launches"]
    print(f"ssm summary: {json.dumps(ssm)}")

    # the dense training path: olmo-1b at its full config
    train = phase("train", train_phase, torch, card)
    flash_row["train_launches"] = train["main"]["flash_launches"]
    print(f"train summary: {json.dumps(train)}")

    # the MoE family's training: granite-moe-1b-a400m at its full config,
    # qwen2-moe-a2.7b at 2 layers (counters at 0 just before each run, read
    # just after), the backward entries against their plain versions
    moe_train = phase("train_moe", moe_train_phase, torch, card)
    flash_row["train_launches_moe"] = moe_train["train"]["flash_launches"]
    moe["row"]["train_launches"] = {
        k: moe_train["train"]["moe_launches"][k] for k in MOE_FORWARD}
    moe_train_out = {k: v for k, v in moe_train.items() if k != "row"}
    print(f"train moe summary: {json.dumps(moe_train_out)}")

    # the SSM family's training: mamba2-130m at its full config (counters
    # at 0 just before the run, read just after), card against CPU, the
    # kernel path against the plain path, the hybrid's smoke config
    ssm_train = phase("train_ssm", ssm_train_phase, torch, card)
    print(f"train ssm summary: {json.dumps(ssm_train)}")

    # the encoder-decoder and vision-language families' fp32 consistency
    # and training: whisper-medium at full config, internvl2-76b at full
    # width (flash counters at 0 just before each run, read just after)
    encdec = phase("encdec", encdec_phase, torch, card)
    vlm = phase("vlm", vlm_phase, torch, card)
    for arch, out in ((ENCDEC_ARCH, encdec), (VLM_ARCH, vlm)):
        flash_row.setdefault("train_launches_frontend", {})[arch] = \
            out["train"]["flash_launches"]
        fp32_row.setdefault("consistency_launches", {})[arch] = \
            2 * out["consistency_fp32"]["layers"]
    print(f"encdec summary: {json.dumps(encdec)}")
    print(f"vlm summary: {json.dumps(vlm)}")

    maxplus_row = phase("maxplus", maxplus_phase, torch)
    torch.cuda.empty_cache()

    # the ranking path: its counter at 0 just before, read just after
    ranks = phase("ranks", ranks_phase, torch)
    maxplus_row["launches"] = ranks["launches"]
    print(f"ranks summary: {json.dumps(ranks)}")

    # the replay path: its counter at 0 just before, read just after
    replay = phase("replay", replay_phase, torch)
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
    contention = phase("contention", contention_phase, torch)
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
    lp = phase("lp", lp_phase, torch)
    hybrid, lp_all = lp["hybrid"], lp["hybrid"] + lp["choice"]
    lp_row = {
        "name": "hlp_fo_solve", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hlp_fo_sm90.cu",
        "replaces": "src/repro/core/hlp_jax.py:122",
        "also_replaces": ["src/repro/core/hlp_jax.py:172"],
        "shape": f"{', '.join(r['name'] for r in hybrid)} on "
                 f"{LP_MACHINE}, {LP_ITERS} iterations, summed",
        "launches": lp["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in lp_all),
        "ms": sum(r["ms"] for r in hybrid),
        "plain_ms": sum(r["plain_ms"] for r in hybrid),
        "plain_on": "host",
        "bound_ms": sum(r["bound_ms"] for r in hybrid),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in hybrid) else "operations"),
        "library_ms": None,
        "chain_floor_ms": sum(r["chain_floor_ms"] for r in hybrid),
        "highs_ms": sum(r["highs_s"] for r in hybrid) * 1e3,
        "instance_ms": {r["name"]: r["ms"]
                        for r in lp_all + [lp["campaign_solve"]]},
        "split": {r["name"]: r["split"] for r in hybrid},
        "instances": lp_all + [lp["campaign_solve"]]}
    print(f"lp summary: {json.dumps(lp)}")

    # the port's campaign entry in a fresh process, then the pinned gate;
    # then the full sim grid against the reference's trajectory
    campaign = phase("campaign", campaign_phase)
    sm90_row["campaign_launches"] = sum(
        campaign[b]["launches"]["replay"] for b in ("sim", "search"))
    sm90_contention["campaign_launches"] = sum(
        campaign[b]["launches"]["contention"] for b in ("sim", "search"))
    lp_row["campaign_launches"] = campaign["full"]["launches"]["hlp_fo"]
    print(f"campaign summary: {json.dumps(campaign)}")

    # the paper's experiments and the kernels target in a fresh process
    # (its counters from 0 there), then the placement planner
    paper = phase("paper", paper_phase)
    maxplus_row["paper_launches"] = paper["kernels"]["launches"]["maxplus"]
    fp32_row["paper_launches"] = paper["kernels"]["launches"]["flash"]
    print(f"paper summary: {json.dumps(paper)}")

    # the open-system streams: the grids in fresh processes, then the
    # Chameleon stream at size, its rollouts replayed by the kernel (the
    # replay counter at 0 just before, in its own process)
    streams = phase("streams", streams_phase)
    cham = streams["chameleon"]["card"]["sim_in_the_loop"]
    sm90_row["streams_launches"] = cham["launches"]
    sm90_row["streams_kernel_ms"] = cham["kernel_ms"]
    sm90_row["streams_grid_launches"] = (streams["default"]["launches"]
                                         + streams["full"]["launches"])
    print(f"streams summary: {json.dumps(streams)}")

    print(f"phase seconds: {json.dumps(PHASE_S)}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the "
          "imports, build included")
    print(json.dumps({"kernels": [flash_row, fp32_row, fma_row,
                                  maxplus_row, sm90_row, sm90_contention,
                                  lp_row, moe["row"], moe_train["row"],
                                  *ssd_rows(ssm, ssm_train)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--chameleon-stream"]:
        sys.exit(chameleon_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--streams-entry"]:
        sys.exit(streams_entry_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--train-resume"]:
        sys.exit(train_resume_child(sys.argv[2]))
    if sys.argv[1:2] == ["--ssd-split"]:
        sys.exit(ssd_split_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--pair"]:
        sys.exit(pair_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
