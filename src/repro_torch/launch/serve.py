"""Serving driver: batched prefill + decode with the ER-LS dispatcher.

The counterpart of ``repro.launch.serve``.  Runs a real model on the card
while the dispatcher plans request placement across a simulated
heterogeneous fleet (the paper's on-line setting); reports per-phase
latencies, dispatcher decisions and tokens/s, and returns a summary dict.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --requests 8 --batch 4 --prompt 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --device cpu

The hand-written CUDA kernels are on exactly when the device is the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.models import model as M
from repro_torch.serve.dispatch import ERLSDispatcher, Pool, Request, \
    token_cost_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Generation:
    """One batch's greedy generation."""

    tokens: torch.Tensor        # (B, gen) generated ids
    finite: bool                # every logit row over the real vocab finite
    prefill_s: float
    decode_s: float


def generate(cfg: ModelConfig, params: M.Params, prompt: torch.Tensor,
             gen: int, max_len: int) -> Generation:
    """Prefill ``prompt`` (B, S), then decode greedily to ``gen`` tokens."""
    dev = prompt.device
    cache = M.init_cache(cfg, prompt.shape[0], max_len, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, prompt, cache)
    finite = torch.isfinite(logits[:, :cfg.vocab_size]).all()
    tok = logits.argmax(-1, keepdim=True)
    _sync(dev)
    t1 = time.perf_counter()
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok)
        finite &= torch.isfinite(logits[:, :cfg.vocab_size]).all()
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), bool(finite), t1 - t0, t2 - t1)


def main(argv: list[str] | None = None, device: str = "cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=device,
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, use_kernels=dev.type == "cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.serving_params(cfg, M.init_params(cfg, gen))
    max_len = args.prompt + args.gen

    # Dispatcher plans placement across a heterogeneous fleet model:
    # many "slow" host-class workers vs few "fast" accelerator workers.
    slow = Pool("cpu-pool", workers=16, speed=1.0)
    fast = Pool("gpu-pool", workers=4, speed=8.0)
    disp = ERLSDispatcher(slow, fast, token_cost_model(
        pool_flops={"cpu-pool": 5e11, "gpu-pool": 2e12}))

    rng = np.random.default_rng(0)
    launches0 = fa.launch_count()
    _sync(dev)
    t0 = time.time()
    total_tokens, prefill_s, decode_s, finite = 0, 0.0, 0.0, True
    for start in range(0, args.requests, args.batch):
        nb = min(args.batch, args.requests - start)
        reqs = [Request(rid=start + i, prompt_tokens=args.prompt,
                        decode_tokens=args.gen, arrival=time.time() - t0)
                for i in range(nb)]
        placements = [disp.submit(r) for r in reqs]
        prompt = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (nb, args.prompt)), device=dev)
        g = generate(cfg, params, prompt, args.gen, max_len)
        total_tokens += nb * args.gen
        prefill_s += g.prefill_s
        decode_s += g.decode_s
        finite = finite and g.finite
        routed_fast = sum(p.pool == fast.name for ps in placements for p in ps)
        print(f"batch {start // args.batch}: prefill {g.prefill_s:.2f}s "
              f"decode {g.decode_s:.2f}s ({nb * args.gen} toks) "
              f"| dispatcher sent {routed_fast}/{2*nb} phases to {fast.name}")
    dt = time.time() - t0
    print(f"served {args.requests} requests, {total_tokens} generated tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s) | "
          f"planned fleet makespan {disp.makespan:.3f}s")
    return {"arch": cfg.name, "smoke": args.smoke, "device": str(dev),
            "requests": args.requests, "batch": args.batch,
            "prompt": args.prompt, "gen": args.gen, "tokens": total_tokens,
            "prefill_s": prefill_s, "decode_s": decode_s, "wall_s": dt,
            "tok_per_s": total_tokens / dt, "makespan": disp.makespan,
            "flash_launches": fa.launch_count() - launches0,
            "logits_finite": finite}


if __name__ == "__main__":
    main()
