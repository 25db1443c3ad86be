"""Checkpoints in the reference's on-disk format, so that each package
restores the other's.

Layout per step:  <dir>/step_<n>/
    manifest.json        leaf names + shapes/dtypes (committed LAST ->
                         a crashed save is never picked up by restore)
    <a__b__c>.npy        one file per leaf of the nested state dict

``save`` copies every leaf to host numpy in the caller's thread, before the
background write starts, so the next step's in-place update (on the card
or on the CPU) cannot race the write; ``keep_last`` old checkpoints are
garbage-collected. ``restore(device=...)`` puts the leaves on a device of
the caller's choice (the reference's ``shardings=``); without it they stay
numpy.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.device import resolve_device


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}, keys sorted at every level."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1] if prefix.endswith("/") else prefix] = tree
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        d = tree
        for p in parents:
            d = d.setdefault(p, {})
        d[leaf] = v
    return tree


def to_host(x) -> np.ndarray:
    """A copy of ``x`` (tensor, numpy array or scalar) as host numpy that
    shares no storage with it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: dict, block: bool = False):
        """``state``: a nested dict whose leaves are tensors or arrays (a
        key may hold "/": it nests as the reference's tree does)."""
        host_state = {k: to_host(v) for k, v in flatten(state).items()}
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_state)

    def _write(self, step: int, flat: dict):
        path = os.path.join(self.dir, f"step_{step}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for name, arr in flat.items():
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                        "dtype": str(arr.dtype)}
        # commit marker: manifest written last, then atomic rename
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, device=None):
        """(step, nested state) of ``step`` (the latest when None), or
        (None, None) when there is none. With ``device`` every leaf is a
        tensor there, else a numpy array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        dev = None if device is None else resolve_device(device)
        flat = {}
        for name, meta in manifest["leaves"].items():
            a = np.load(os.path.join(path, meta["file"]))
            flat[name] = a if dev is None else torch.as_tensor(a, device=dev)
        return step, unflatten(flat)
