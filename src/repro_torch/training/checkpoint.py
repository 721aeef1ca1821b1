"""Atomic, async checkpointing with restart discovery —
``repro/training/checkpoint.py``.

Layout:  <dir>/step_<N>/
            manifest.json        {leaf path -> {shape, dtype, file}}
            <leaf>.bin           raw bytes
            COMMITTED            written last -> crash-safe atomicity marker

A tree is nested dicts (lists and tuples index by position) whose leaves are
tensors, numpy arrays or numbers; a leaf's path joins its keys with "/"
(``params/blocks.0.mix.wq.w``, ``opt/mu/...``). bfloat16 leaves are stored
as their raw 16-bit words under dtype ``bfloat16``. ``latest_step`` ignores
directories without the COMMITTED marker, so a checkpoint truncated by a
node failure is never restored. ``AsyncCheckpointer`` snapshots the tree to
host memory synchronously and writes it on a background thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

_COMMIT = "COMMITTED"


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += _leaf_paths(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def _to_numpy(leaf):
    """-> (array, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(tree, directory: str, step: int):
    tmp = os.path.join(directory, f"_tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for name, leaf in _leaf_paths(tree):
        arr, dtype = _to_numpy(leaf)
        fn = re.sub(r"[^A-Za-z0-9_.-]", "_", name) + ".bin"
        np.ascontiguousarray(arr).tofile(os.path.join(tmp, fn))
        manifest[name] = {"shape": list(arr.shape), "dtype": dtype,
                          "file": fn}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _load(path: str, meta: dict) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        arr = np.fromfile(path, dtype=np.int16)
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.fromfile(path, dtype=np.dtype(meta["dtype"])))
    return t.reshape(meta["shape"])


def restore(template, directory: str, step: int):
    """The tree saved at ``step``, shaped like ``template``: each leaf a
    tensor on the template leaf's device and in its dtype (a number or an
    array template gives a CPU tensor)."""
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        meta = manifest[prefix]
        t = _load(os.path.join(d, meta["file"]), meta)
        if isinstance(tree, torch.Tensor):
            return t.to(device=tree.device, dtype=tree.dtype)
        return t
    return rebuild(template, "")


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, _COMMIT)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def gc_old(directory: str, keep: int = 3):
    if not os.path.isdir(directory):
        return
    steps = sorted([int(m.group(1)) for d in os.listdir(directory)
                    if (m := re.fullmatch(r"step_(\d+)", d))])
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, tree, step: int):
        snapshot = _snapshot(tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(snapshot, step), daemon=True)
        self._thread.start()

    def _write(self, snapshot, step):
        save(snapshot, self.directory, step)
        gc_old(self.directory, self.keep)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
