"""Atomic, async checkpointing with resume, in the reference's layout.

The counterpart of ``repro.ckpt.checkpoint``.  Layout: ``<dir>/step_<N>/``
holds ``arrays.npz`` (the state flattened, keys joined with ``/``, an empty
dict kept as a ``__empty_dict__`` entry, as olmo's parameter-free norms
need) and ``manifest.json`` (step, keys, device count).  A write goes to a
temporary directory and is published by an atomic rename, so a failure
mid-save never corrupts the latest checkpoint; :class:`AsyncCheckpointer`
overlaps the file write with the next steps.  A checkpoint either package
writes restores in the other.  Restoring places the arrays on ``device``
(the reference re-places them with its mesh's shardings; elastic
re-placement over several cards waits for the port's sharding).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

_EMPTY = "__empty_dict__"   # preserves {} leaves (e.g. olmo's param-free LN)


def _host(v) -> np.ndarray:
    """A host copy of ``v`` that shares no storage with it: the optimizer
    updates its tensors in place while an async write is still running."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 tensor has no numpy dtype to save as")
        v = v.detach()
        return (v.clone() if v.device.type == "cpu" else v.cpu()).numpy()
    return np.array(v)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix + _EMPTY] = np.zeros(0)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] == _EMPTY:
            continue
        node[parts[-1]] = v
    return tree


def _devices(flat: dict) -> int:
    cards = {v.device for v in flat.values()
             if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    return max(len(cards), 1)


def _write(ckpt_dir: str, step: int, host: dict, devices: int,
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(host), "devices": devices}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state: dict, *, keep: int = 3) -> str:
    """Blocking atomic save of a nested dict of tensors ``state``."""
    flat = _flatten(state)
    return _write(ckpt_dir, step, {k: _host(v) for k, v in flat.items()},
                  _devices(flat), keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


class AsyncCheckpointer:
    """One-in-flight async writer: ``save`` copies the state to the host and
    returns; the file write runs on a thread, and the previous write is
    awaited first (bounded memory, ordered publishes)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, step: int, state: dict) -> None:
        self.wait()
        flat = _flatten(state)
        host = {k: _host(v) for k, v in flat.items()}
        devices = _devices(flat)
        self._thread = threading.Thread(
            target=_write, args=(self.dir, step, host, devices, self.keep),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, step: int | None = None, *,
            device: torch.device | str = "cpu"):
    """(step, state) of a checkpoint (the latest when ``step`` is None), its
    arrays as tensors on ``device``; (None, None) when there is none."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    return step, _unflatten(flat)
