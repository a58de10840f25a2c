"""Deterministic sharded synthetic-LM data pipeline with background prefetch.

A copy of ``repro.data.pipeline`` (numpy and a thread; the port imports
nothing of the JAX package), so the port's batches are the reference's bit
for bit.  It adds one option the reference's pipeline lacks: a stub
frontend's precomputed embeddings (``DataConfig.frontend``), drawn after
the tokens, which stay the reference's.

Every batch is a pure function of (seed, step, shard), so a restarted or
re-sharded job replays the exact token stream — the property checkpoint
resume and elastic re-scaling rely on (tests assert it).  The generator
synthesizes Zipf-distributed token streams with local n-gram structure so
that a language model actually has something to learn (loss decreases).
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    zipf_a: float = 1.2
    #: (batch key, positions, width) of a stub frontend's embeddings, 0.02 ·
    #: N(0, 1) in float32, or None for a batch of tokens alone
    frontend: tuple[str, int, int] | None = None


def _batch_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def make_batch(cfg: DataConfig, step: int) -> dict:
    """The shard-local slice of global batch ``step`` (host-resident numpy)."""
    per_shard = cfg.global_batch // cfg.num_shards
    rng = _batch_rng(cfg, step, cfg.shard)
    b, s, v = per_shard, cfg.seq_len, cfg.vocab_size
    # Zipf unigrams + deterministic bigram successor structure: with prob 0.5
    # token t is exactly (31·t_{prev} + 7) mod v — learnable by any LM.
    base = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64) % v
    mask = rng.random((b, s + 1)) < 0.5
    toks = base.copy()
    for t in range(1, s + 1):   # sequential so the bigram rule truly holds
        toks[:, t] = np.where(mask[:, t], (toks[:, t - 1] * 31 + 7) % v,
                              base[:, t])
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "targets": toks[:, 1:].astype(np.int32),
        "loss_mask": np.ones((b, s), np.float32),
    }
    if cfg.frontend is not None:
        key, t, d = cfg.frontend
        batch[key] = 0.02 * rng.standard_normal((b, t, d), dtype=np.float32)
    return batch


class Prefetcher:
    """Background-thread prefetch of upcoming batches (bounded queue)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
