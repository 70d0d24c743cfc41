"""Checkpointing: atomic, async, in the reference's file format.

Layout:  <dir>/step_<N>/<tree>.npz + manifest.json, written to a tmp dir and
renamed (atomic on POSIX).  Arrays are saved logically (whole host arrays
keyed by their path in the tree, joined with ``|``), with each array's dtype
name in the manifest, exactly as ``repro.checkpoint.checkpoint`` writes
them: a checkpoint of either package loads in the other.

numpy has no bfloat16.  The reference stores a bf16 leaf's raw bits as
uint16 and needs ``ml_dtypes`` to read them back; the port moves the same
bits through ``torch.Tensor.view(torch.int16)``, so it needs neither
``ml_dtypes`` nor ``jax``.  Loaded trees hold CPU tensors.

``AsyncCheckpointer`` snapshots to host memory synchronously (one copy off
the card) and does the disk I/O on a background thread, so the train loop
continues while bytes reach the disk; ``wait()`` surfaces any background
error.  The reference's ``restore_sharded`` (elastic restore onto a new
mesh) waits for the sharding rules (ROADMAP item 12).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.common import flatten, unflatten

_SEP = "|"


def _host(v) -> tuple[np.ndarray, str]:
    """A leaf as (the array written to the npz, the manifest's dtype name).
    A bf16 tensor's bits go as uint16 under the name "bfloat16", as the
    reference stores its ``ml_dtypes`` arrays."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, a.dtype.name


def _flat_np(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    arrays: dict[str, np.ndarray] = {}
    dtypes: dict[str, str] = {}
    for path, v in flatten(tree).items():
        key = _SEP.join(path)
        arrays[key], dtypes[key] = _host(v)
    return arrays, dtypes


def _restore(a: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: str, step: int, trees: dict[str, Any], *, keep: int = 3,
         extra_meta: dict | None = None) -> str:
    """trees: {"params": ..., "opt_state": ..., ...} (each a nested dict of
    tensors or arrays)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: dict[str, Any] = {"step": step, "trees": {}, "dtypes": {}, "time": time.time(),
                                "meta": extra_meta or {}}
    for name, tree in trees.items():
        arrays, dtypes = _flat_np(tree)
        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
        manifest["trees"][name] = sorted(arrays.keys())
        manifest["dtypes"][name] = dtypes
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load(ckpt_dir: str, step: int | None = None) -> tuple[int, dict[str, Any]]:
    """-> (step, {tree name: nested dict of CPU tensors})."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out: dict[str, Any] = {}
    for name in manifest["trees"]:
        dtypes = manifest.get("dtypes", {}).get(name, {})
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            flat = {tuple(k.split(_SEP)): _restore(z[k], dtypes.get(k, z[k].dtype.name))
                    for k in z.files}
        out[name] = unflatten(flat)
    return step, out


def _snapshot(v):
    """A host copy of a leaf that later in-place updates cannot reach (a CPU
    tensor's ``.cpu()`` would be the tensor itself)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return np.array(v)


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, trees: dict[str, Any], extra_meta: dict | None = None) -> None:
        self.wait()
        host_trees = {n: unflatten({p: _snapshot(v) for p, v in flatten(t).items()})
                      for n, t in trees.items()}

        def work():
            try:
                save(self.ckpt_dir, step, host_trees, keep=self.keep, extra_meta=extra_meta)
            except BaseException as e:  # noqa: BLE001 - surfaced via wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
