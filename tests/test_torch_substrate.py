"""The port's training substrate: data pipeline, checkpoints, the step
watchdog, the resilient loop and the training entry point.

The counterparts of ``tests/test_substrate.py``'s data, checkpoint,
watchdog, resilient-loop and optimizer tests and of
``tests/test_elastic.py::test_checkpoint_preserves_empty_param_dicts``, run
on ``repro_torch``; beside them, against the JAX package: the pipeline's
batches bit for bit, a checkpoint the reference wrote restoring in the port
(and one the port wrote in the reference) to the same arrays, and the
resilient loop with injected failures ending bit for bit where an
uninterrupted run ends.  ``python -m repro_torch.launch.train --smoke
--device cpu`` runs in a subprocess.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.fault import (FaultConfig, StepWatchdog,  # noqa: E402
                                       resilient_train_loop)
from repro_torch.train.step import compress_grads_int8  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------- data
def test_batches_equal_the_references_bit_for_bit():
    for kw in (dict(vocab_size=256, seq_len=16, global_batch=4),
               dict(vocab_size=50304, seq_len=64, global_batch=8, seed=3),
               dict(vocab_size=997, seq_len=32, global_batch=6, num_shards=3,
                    shard=2, zipf_a=1.5)):
        for step in (0, 1, 17):
            a = make_batch(DataConfig(**kw), step)
            b = jdata.make_batch(jdata.DataConfig(**kw), step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


def test_data_sharding_partitions_batch():
    full = make_batch(DataConfig(128, 16, 8, num_shards=1, shard=0), 3)
    s0 = make_batch(DataConfig(128, 16, 8, num_shards=2, shard=0), 3)
    s1 = make_batch(DataConfig(128, 16, 8, num_shards=2, shard=1), 3)
    assert s0["tokens"].shape[0] == s1["tokens"].shape[0] == 4
    assert full["tokens"].shape[0] == 8
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_prefetcher_orders_batches():
    cfg = DataConfig(128, 8, 2)
    pf = Prefetcher(cfg, start_step=5)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], make_batch(cfg, s)["tokens"])


def test_data_has_learnable_structure():
    b = make_batch(DataConfig(vocab_size=997, seq_len=512, global_batch=4), 0)
    t = b["tokens"]
    assert (t[:, 1:] == (t[:, :-1] * 31 + 7) % 997).mean() > 0.3


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = {"a": {"b": torch.arange(6).reshape(2, 3)},
             "count": torch.tensor(3, dtype=torch.int32)}
    for step in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), step, state, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert len(os.listdir(tmp_path)) == 2          # gc keeps 2
    step, tree = ckpt.restore(str(tmp_path))
    assert step == 4
    assert torch.equal(tree["a"]["b"], state["a"]["b"])
    assert tree["count"].dtype == torch.int32 and int(tree["count"]) == 3
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json")
                          .read_text())
    assert manifest["step"] == 4 and manifest["keys"] == ["a/b", "count"]
    assert ckpt.restore(str(tmp_path / "none")) == (None, None)


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(10, {"x": torch.ones(4)})
    saver.wait()
    step, tree = ckpt.restore(str(tmp_path))
    assert step == 10 and torch.equal(tree["x"], torch.ones(4))
    with pytest.raises(TypeError, match="bfloat16"):
        ckpt.save(str(tmp_path), 11, {"x": torch.ones(2, dtype=torch.bfloat16)})


def test_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """``AsyncCheckpointer.save`` copies the state before it returns: an
    in-place update made while the file write is still pending (as
    ``adamw.apply`` makes the next step) does not reach the checkpoint."""
    go = threading.Event()
    write = ckpt._write

    def held_write(*args):
        go.wait()
        return write(*args)
    monkeypatch.setattr(ckpt, "_write", held_write)
    state = {"p": torch.arange(8, dtype=torch.float32),
             "opt": {"mu": torch.ones(3), "count": np.int32(1)}}
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(5, state)
    with torch.no_grad():
        state["p"].add_(100.0)
        state["opt"]["mu"].mul_(7.0)
    go.set()
    saver.wait()
    step, tree = ckpt.restore(str(tmp_path))
    assert step == 5
    assert torch.equal(tree["p"], torch.arange(8, dtype=torch.float32))
    assert torch.equal(tree["opt"]["mu"], torch.ones(3))
    assert int(tree["opt"]["count"]) == 1


def test_checkpoint_preserves_empty_param_dicts(tmp_path):
    """olmo-1b's non-parametric LN has {} param leaves — structure survives."""
    state = {"blocks": {"ln1": {}, "w": torch.ones(3)}}
    ckpt.save(str(tmp_path), 1, state)
    _, tree = ckpt.restore(str(tmp_path))
    assert tree["blocks"]["ln1"] == {}
    assert torch.equal(tree["blocks"]["w"], torch.ones(3))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's olmo-1b smoke training state (parameters with their
    empty norm dicts, AdamW's moments and int32 count) saved by
    ``repro.ckpt.checkpoint`` restores in the port to the same arrays, and
    the port's save of it restores in the reference."""
    cfg = jax_smoke("olmo-1b")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    opt = JA.init(params)
    opt["count"] = opt["count"] + 7
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    jckpt.save(str(tmp_path / "ref"), 5, state)
    step, tree = ckpt.restore(str(tmp_path / "ref"), device="cpu")
    assert step == 5
    assert tree["params"]["final_norm"] == {}
    assert tree["params"]["blocks"]["ln1"] == {}
    assert int(tree["opt"]["count"]) == 7
    ref_leaves = jax.tree.leaves(state)
    assert len(leaves(tree)) == len(ref_leaves)
    for a, b in zip(leaves(tree), ref_leaves):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    # the restored parameters are the port's parameter dict for the config
    tparams = params_from_jax(get_smoke_config("olmo-1b"), tree["params"])
    for a, b in zip(leaves(tparams), leaves(tree["params"])):
        assert torch.equal(a, b)
    ckpt.save(str(tmp_path / "port"), 6, tree)
    jstep, jtree = jckpt.restore(str(tmp_path / "port"))
    assert jstep == 6 and jtree["params"]["blocks"]["ln2"] == {}
    for a, b in zip(jax.tree.leaves(jtree), ref_leaves):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- fault tolerance
def test_resilient_loop_recovers_bit_exact(tmp_path):
    """A run with failures injected at steps 6 and 9 restarts twice from
    its checkpoints and ends on the uninterrupted run's parameters and
    optimizer state, bit for bit (the reference's test allows 1e-6)."""
    steps = 12
    cfg = LT.get_smoke_config("olmo-1b")
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "float32", "remat": "none"})
    oc = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    dev = torch.device("cpu")
    one_step = LT.make_step(cfg, oc, dev)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                          global_batch=2)

    def init_state():
        return LT.init_state(cfg, dev)

    clean, _, info = resilient_train_loop(
        init_state, one_step, data_cfg, steps,
        FaultConfig(ckpt_dir=str(tmp_path / "clean"), ckpt_every=4))
    assert info["restarts"] == 0
    failed = {6: True, 9: True}
    faulty, metrics, info = resilient_train_loop(
        init_state, one_step, data_cfg, steps,
        FaultConfig(ckpt_dir=str(tmp_path / "faulty"), ckpt_every=4),
        fail_at=lambda s: failed.pop(s, False), device=dev)
    assert info["restarts"] == 2 and info["resumed_from"] == [4, 8]
    assert torch.isfinite(metrics["loss"])
    for a, b in zip(leaves(clean), leaves(faulty)):
        assert torch.equal(a, b)
    assert int(faulty["opt"]["count"]) == steps


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0)
    for i in range(10):
        wd.observe(i, 0.1)
    assert wd.observe(10, 1.0)        # 10x the EMA
    assert wd.flagged == [10]
    assert not wd.observe(11, 0.1) and wd.flagged == [10]


# ---------------------------------------------------------------- optimizer
def test_adamw_decreases_loss_quadratic():
    oc = adamw.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                         weight_decay=0.0, schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply(oc, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_compression_roundtrip_accuracy():
    g = {"a": torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64)))}
    cg = compress_grads_int8(g)
    rel = float((cg["a"] - g["a"]).abs().max() / g["a"].abs().max())
    assert rel < 0.02                 # int8 quantization error bound


# ------------------------------------------------------------ entry point
def test_launch_train_smoke_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch olmo-1b --smoke --device
    cpu`` trains and lowers the loss, through the prefetcher and through the
    resilient loop (``--ckpt-dir``); without ``--device`` it asks for the
    card, which a host without one refuses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "olmo-1b", "--smoke", "--steps", "30", "--batch", "4", "--seq",
            "32", "--log-every", "10"]
    for extra in ([], ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
                       "10"]):
        out = subprocess.run(base + ["--device", "cpu"] + extra, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        losses = [float(line.split()[3]) for line in out.stdout.splitlines()
                  if line.startswith("step")]
        assert len(losses) == 3 and losses[-1] < losses[0], out.stdout
        assert "done in" in out.stdout
    assert ckpt.latest_step(str(tmp_path / "ck")) == 29
    if not torch.cuda.is_available():
        out = subprocess.run(base, env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and "is_available" in out.stderr
