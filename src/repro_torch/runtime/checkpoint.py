"""Async, atomic checkpointing with restart support (counterpart of
``repro/runtime/checkpoint.py``).

Layout:  <dir>/step_<N>.tmp-<nonce>/   (write)  ->  <dir>/step_<N>/ (rename)
           leaf files  <flat-index>.npy
           manifest.json  {step, num_leaves, leaves: [{key, dtype, shape}]}

A state is a nested dict of tensors (the train state: {"params": {name:
tensor}, "opt": {"m": ..., "v": ..., "step": ...}}); its leaves are
flattened in sorted key order, as ``jax.tree.flatten`` orders a dict, and
each leaf's key path ("opt/m/embed") is recorded.

* ATOMIC: the tmp-dir rename is the commit point; a crash mid-write leaves
  only tmp dirs, which restore() ignores and cleanup_torn() removes -- a
  torn checkpoint can never be restored.
* ASYNC: save() copies every leaf to host memory synchronously (a copy
  also of a leaf already there) and writes the files on a background
  thread, overlapping I/O with the next steps.
* numpy has no bfloat16: such a leaf is stored as its uint16 bits, and the
  manifest's dtype says how to read it back.
* save() writes a DTensor leaf whole (gathered, as the reference writes
  ``np.asarray`` of a sharded array); restore() puts each leaf on the
  caller's device or, given a ``sharding_tree`` of
  ``distributed.sharding.named_sharding`` records, lays it out on that
  record's mesh as a DTensor: a restore onto another mesh reshards.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in flatten(tree[key], f"{prefix}{key}/")]
    return [(prefix[:-1], tree)]


def unflatten(like: Any, leaves: list, prefix: str = "") -> Any:
    """A nested dict shaped as ``like`` with ``leaves`` (in :func:`flatten`'s
    order) as its leaves; consumes ``leaves`` from the front."""
    if isinstance(like, dict):
        return {key: unflatten(like[key], leaves, f"{prefix}{key}/") for key in sorted(like)}
    return leaves.pop(0)


def _to_host(x) -> tuple[np.ndarray, str]:
    """A copy of the leaf in host memory, never a view of it (the next steps
    update a CPU state's parameters and moments in place while the writer
    thread runs), and its dtype's name."""
    t = sharding.full(torch.as_tensor(x)).detach().to("cpu", copy=True)
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.numpy()
    return (arr.view(np.uint16) if dtype == "bfloat16" else arr), dtype


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _subtree(tree: Any, key: str) -> Any:
    """The node of ``tree`` at key path ``key`` ("opt/m/embed"), or None
    where the path leaves it."""
    for part in key.split("/"):
        if not isinstance(tree, dict):
            return tree
        tree = tree.get(part)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()                      # one outstanding write at a time
        # Snapshot to host synchronously: it decouples the write from the
        # in-place updates of the next steps.
        pairs = flatten(tree)
        host = [(key,) + _to_host(x) for key, x in pairs]

        def write():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp-{uuid.uuid4().hex[:8]}")
                os.makedirs(tmp)
                for i, (_, arr, _) in enumerate(host):
                    np.save(os.path.join(tmp, f"{i}.npy"), arr)
                manifest = {
                    "step": step,
                    "num_leaves": len(host),
                    "leaves": [{"key": key, "dtype": dtype, "shape": list(arr.shape)}
                               for key, arr, dtype in host],
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                final = os.path.join(self.directory, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)                    # commit point
                self._gc()
            except BaseException as e:    # surfaced by wait()
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None, device=None,
                sharding_tree: Any = None) -> tuple[int, Any]:
        """(step, the state) in the structure of ``like`` (a nested dict whose
        leaves may be anything), each leaf on ``device`` (default: the CPU)
        or, where ``sharding_tree`` (nested dicts shaped as ``like``, or a
        prefix of it) holds a ``NamedSharding``, a DTensor laid out by it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        keys = [key for key, _ in flatten(like)]
        saved = [leaf["key"] for leaf in manifest["leaves"]]
        if keys != saved:
            raise ValueError(f"checkpoint step_{step} holds other leaves than asked: "
                             f"missing {sorted(set(keys) - set(saved))}, "
                             f"extra {sorted(set(saved) - set(keys))}")
        device = torch.device("cpu") if device is None else device
        leaves = []
        for i, (key, leaf) in enumerate(zip(keys, manifest["leaves"])):
            x = _from_host(np.load(os.path.join(path, f"{i}.npy")), leaf["dtype"], device)
            shard = _subtree(sharding_tree, key)
            leaves.append(x if shard is None else shard.place(x))
        return step, unflatten(like, leaves)

    # ------------------------------------------------------------------ gc
    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and ".tmp" not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def cleanup_torn(self) -> int:
        """Remove tmp dirs left by crashes. Returns count removed."""
        n = 0
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
                n += 1
        return n
