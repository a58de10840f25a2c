"""Training-side fault tolerance: a step watchdog and checkpoint/restart.

The counterpart of ``repro.runtime.fault``.  ``resilient_train_loop`` wraps
a step function with
  * periodic async checkpointing (atomic; survives a kill mid-save),
  * automatic resume from the latest checkpoint after a (simulated or real)
    failure, replaying the deterministic data stream from the restored
    step,
  * a step watchdog that flags stragglers (wall time > factor x its EMA).
On restart the state is placed on ``device`` (the reference re-places it
with its current mesh's shardings; several cards wait for the port's
sharding).  The tests inject failures at chosen steps and hold the result
to an uninterrupted run, bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, make_batch


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    watchdog_factor: float = 5.0
    max_restarts: int = 10


class StepWatchdog:
    """Flags steps slower than ``factor`` x the exponential moving average."""

    def __init__(self, factor: float = 5.0, alpha: float = 0.1):
        self.factor, self.alpha = factor, alpha
        self.ema: float | None = None
        self.flagged: list[int] = []

    def observe(self, step: int, dt: float) -> bool:
        straggler = self.ema is not None and dt > self.factor * self.ema
        if straggler:
            self.flagged.append(step)
        else:  # stragglers don't poison the EMA
            self.ema = dt if self.ema is None else \
                (1 - self.alpha) * self.ema + self.alpha * dt
        return straggler


def resilient_train_loop(init_state: Callable[[], dict],
                         train_step: Callable[[dict, dict], tuple[dict, dict]],
                         data_cfg: DataConfig, num_steps: int,
                         fc: FaultConfig,
                         fail_at: Callable[[int], bool] | None = None,
                         device: torch.device | str = "cpu",
                         on_metrics: Callable[[int, dict], None] | None = None):
    """Run ``num_steps`` with checkpoint/restart; returns (state, metrics,
    info).  ``train_step(state, batch)`` takes the numpy batch of
    ``make_batch(data_cfg, step)``; a ``RuntimeError`` from it (or from
    ``fail_at(step)``) restarts from the latest checkpoint."""
    saver = ckpt.AsyncCheckpointer(fc.ckpt_dir, keep=fc.keep)
    watchdog = StepWatchdog(fc.watchdog_factor)
    restarts = 0
    info = {"restarts": 0, "resumed_from": [], "stragglers": watchdog.flagged}

    while True:
        step, state = ckpt.restore(fc.ckpt_dir, device=device)
        if state is None:
            step, state = 0, init_state()
        else:
            step += 1
            info["resumed_from"].append(step)
        metrics = {}
        try:
            while step < num_steps:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                batch = make_batch(data_cfg, step)
                state, metrics = train_step(state, batch)
                watchdog.observe(step, time.perf_counter() - t0)
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if (step + 1) % fc.ckpt_every == 0:
                    saver.save(step, state)
                step += 1
            saver.wait()
            saver.save(num_steps - 1, state)
            saver.wait()
            info["restarts"] = restarts
            return state, metrics, info
        except RuntimeError:
            restarts += 1
            saver.wait()
            if restarts > fc.max_restarts:
                raise
