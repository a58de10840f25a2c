"""Kernel microbenchmarks: each kernel against its plain version.

The counterpart of the JAX package's ``benchmarks/kernel_bench_impl.py``:
the same cases (the (max, +) product at 256³, and 512³ with ``--full``;
flash attention at s512 h4 d64 fp32 causal, s1024 h8 with ``--full``) and
the same CSV lines, ``kernels/<case>,<us per call>,ref_us=<plain>[;...]``.
On the card, times come from CUDA events; on the CPU (``--device cpu``) the
wrappers take the plain versions, so both columns time plain code on the
host clock.

  PYTHONPATH=src python -m repro_torch.launch.kernel_bench
  PYTHONPATH=src python -m repro_torch.launch.kernel_bench --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.maxplus.maxplus import maxplus_matmul
from repro_torch.kernels.maxplus.ref import maxplus_matmul_ref


def time_us(fn, dev: torch.device, reps: int = 3) -> float:
    """Mean microseconds per call of ``fn`` after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e6 / reps


def err_vs_plain(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|): 0 only where the two are equal,
    at most ``tol`` only where they agree within atol = rtol = ``tol``."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (1 + want.abs())).max())


def cases(full: bool, device: str = "cuda") -> list[dict]:
    """Each case's name, its kernel's and plain version's µs a call, and
    :func:`err_vs_plain` of the kernel's output against the plain
    version's on the same inputs."""
    dev = resolve_device(device)
    out = []
    rng = np.random.default_rng(0)
    sizes = [(256, 256, 256)] + ([(512, 512, 512)] if full else [])
    for (m, k, n) in sizes:
        a = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32), device=dev)
        b = torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32), device=dev)
        t_ker = time_us(lambda: maxplus_matmul(a, b), dev)
        t_ref = time_us(lambda: maxplus_matmul_ref(a, b), dev)
        got, want = maxplus_matmul(a, b), maxplus_matmul_ref(a, b)
        out.append({"name": f"kernels/maxplus_{m}x{k}x{n}", "us": t_ker,
                    "ref_us": t_ref, "shape": [m, k, n],
                    "max_abs_err": float((got - want).abs().max()),
                    "err_vs_plain": err_vs_plain(got, want)})

    s, h, d = (512, 4, 64) if not full else (1024, 8, 64)
    q, kk, v = (torch.as_tensor(rng.normal(size=(2, s, h, d)).astype(np.float32),
                                device=dev) for _ in range(3))
    t_ker = time_us(lambda: fops.flash_attention(q, kk, v, causal=True), dev)

    def fold(x):
        return x.transpose(1, 2).reshape(2 * h, s, d)

    fq, fk, fv = fold(q), fold(kk), fold(v)
    t_ref = time_us(lambda: attention_ref(fq, fk, fv, causal=True), dev)
    got = fold(fops.flash_attention(q, kk, v, causal=True))
    want = attention_ref(fq, fk, fv, causal=True)
    out.append({"name": f"kernels/flash_attn_s{s}", "us": t_ker,
                "ref_us": t_ref, "shape": [2, s, h, h, d],
                "max_abs_err": float((got - want).abs().max()),
                "err_vs_plain": err_vs_plain(got, want)})
    return out


def lines_of(results: list[dict]) -> list[str]:
    """The reference's CSV lines, ``kernels/<case>,<us>,ref_us=<plain>``
    (the (max, +) product's with ``;max_err=``)."""
    lines = []
    for c in results:
        line = f"{c['name']},{c['us']:.0f},ref_us={c['ref_us']:.0f}"
        if c["name"].startswith("kernels/maxplus"):
            line += f";max_err={c['max_abs_err']:.1e}"
        lines.append(line)
    return lines


def run(full: bool, device: str = "cuda") -> list[str]:
    lines = lines_of(cases(full, device))
    print(f"# kernels: {len(lines)} benchmarks ({resolve_device(device).type})")
    return lines


def main(argv: list[str] | None = None, device: str = "cuda") -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="add maxplus 512³ and flash at s1024 h8")
    ap.add_argument("--device", default=device,
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    lines = run(args.full, args.device)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
