"""Training entry point: the config registry, seeded parameters, the data
pipeline, the train step and the resilient loop (checkpoint / restart /
watchdog).

The counterpart of ``repro.launch.train``, on one device: the card unless
``--device cpu``.  It trains every model family; a model with a stub
frontend (whisper-medium's audio frames, internvl2-76b's vision patches)
takes seeded 0.02 · N(0, 1) embeddings from the data pipeline
(:func:`data_config`), which the reference's trainer does not give it.
Flash attention stays off in training (``use_kernels`` False), as the
reference's trainer leaves ``use_pallas``: the flash kernel is forward
only, and attention trains through the chunked path.  The MoE and SSD ops
take their kernels on the card whatever ``use_kernels`` says, as in
serving: route, dispatch and combine forward, and the backward entries of
``kernels/csrc/moe_sm90.cu`` (the combine again for the dispatch's
cotangent, ``combine_grad`` and ``gate_grad``); the SSD scan and its
backward ``scan_grad`` of ``kernels/csrc/ssd_sm90.cu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --device cpu --steps 50 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 20 --batch 8 --seq 2048 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 20 --batch 8 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 20 --batch 8 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --smoke --device cpu --steps 30 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-medium \\
      --steps 10 --batch 8 --seq 448
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.fault import FaultConfig, resilient_train_loop
from repro_torch.train.step import make_train_step


def batch_on(batch: dict, device: torch.device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def data_config(cfg: ModelConfig, seq: int, batch: int,
                seed: int = 0) -> DataConfig:
    """The data pipeline's config for ``cfg``: ``batch`` sequences of
    ``seq`` tokens, and the stub frontend's embeddings where the model has
    one (``vision_tokens`` or ``encoder_seq`` positions of d_model)."""
    t = M.frontend_positions(cfg)
    frontend = (M.FRONTEND_KEYS[cfg.frontend], t, cfg.d_model) if t else None
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed, frontend=frontend)


def init_state(cfg: ModelConfig, device: torch.device, seed: int = 0) -> dict:
    """Seeded parameters on ``device`` and their zero AdamW state."""
    params = M.init_params(cfg, torch.Generator(device).manual_seed(seed))
    return {"params": params, "opt": adamw.init(params)}


def make_step(cfg: ModelConfig, oc: adamw.OptConfig, device: torch.device,
              num_microbatches: int = 1, compress: bool = False):
    """``one_step(state, batch) -> (state, metrics)`` on a numpy batch, the
    function the resilient loop drives."""
    step_fn = make_train_step(cfg, oc, num_microbatches=num_microbatches,
                              compress=compress)

    def one_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       batch_on(batch, device))
        return {"params": params, "opt": opt}, metrics

    return one_step


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    oc = adamw.OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    one_step = make_step(cfg, oc, device, args.microbatches)
    data_cfg = data_config(cfg, args.seq, args.batch)
    losses = []

    def on_metrics(step, metrics):
        if step % args.log_every == 0:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    if args.ckpt_dir:
        fc = FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
        state, metrics, info = resilient_train_loop(
            lambda: init_state(cfg, device), one_step, data_cfg, args.steps,
            fc, device=device, on_metrics=on_metrics)
        print(f"done in {time.time()-t0:.1f}s; restarts={info['restarts']}")
    else:
        state = init_state(cfg, device)
        pf = Prefetcher(data_cfg)
        try:
            for step in range(args.steps):
                _, batch = pf.next()
                state, metrics = one_step(state, batch)
                on_metrics(step, metrics)
        finally:
            pf.close()
        print(f"done in {time.time()-t0:.1f}s; "
              f"final loss {float(metrics['loss']):.4f}")
    return {"losses": losses, "final_loss": float(metrics["loss"]),
            "device": str(device)}


if __name__ == "__main__":
    main()
