"""Atomic step checkpoints with keep-k garbage collection and async
writes (port of :mod:`repro.checkpoint.manager`).

The on-disk layout is the reference's, so a checkpoint written by either
package restores in the other::

    <root>/step_00001000.tmp/...   (written, then renamed with os.replace)
    <root>/step_00001000/
        manifest.json              step, extra, leaves (path/file/shape/dtype)
        arrays/<leaf__path>.npy    one file per leaf

Leaf paths are the state's keys joined by ``/`` (``params/embed/table``,
``opt/m/...``, ``step``).  bfloat16 leaves are written as float32 (numpy
has no bfloat16) and cast back to the target's dtype on restore, as the
reference casts every leaf.  ``save_async`` copies to host memory at
once and writes from a thread (joined by the next save or ``wait``).
Single-process: the reference's resharding onto another mesh has nothing
to do here.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_flatten, tree_unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = str(root)
        self.keep = keep
        os.makedirs(self.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, extra: Optional[dict] = None):
        """Blocking save: copy every leaf to host, then write atomically."""
        paths, leaves = tree_flatten(state)
        self._write(step, [(p, _host(l)) for p, l in zip(paths, leaves)],
                    extra or {})

    def save_async(self, step: int, state: Any,
                   extra: Optional[dict] = None):
        """Host copy now, file writes in a background thread."""
        self.wait()
        paths, leaves = tree_flatten(state)
        host = [(p, _host(l)) for p, l in zip(paths, leaves)]
        self._thread = threading.Thread(
            target=self._write, args=(step, host, dict(extra or {})),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, extra: dict):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        arrays = os.path.join(tmp, "arrays")
        os.makedirs(arrays, exist_ok=True)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for path, arr in host_leaves:
            fname = path.replace("/", "__") + ".npy"
            np.save(os.path.join(arrays, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname,
                 "shape": list(arr.shape), "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: int, like: Any) -> Any:
        """A new tree shaped like ``like``: each tensor leaf takes its
        dtype and device from ``like``, an int leaf comes back an int."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {l["path"]: l for l in manifest["leaves"]}
        paths, leaves = tree_flatten(like)
        out = []
        for path, leaf in zip(paths, leaves):
            entry = by_path.get(path)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {path!r}")
            arr = np.load(os.path.join(d, "arrays", entry["file"]))
            if isinstance(leaf, torch.Tensor):
                out.append(torch.from_numpy(np.array(arr)).to(
                    device=leaf.device, dtype=leaf.dtype))
            elif isinstance(leaf, int):
                out.append(int(arr))
            else:
                out.append(arr)
        return tree_unflatten(paths, out)

    def extra(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f).get("extra", {})
