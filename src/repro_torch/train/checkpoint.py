"""Lightweight fault-tolerant checkpointing, in the reference's layout.

* **layout**: ``<dir>/step_%010d/arrays.npz`` keyed by the tree's
  ``/``-joined paths (dict keys sorted: ``params/layers/wq``,
  ``opt/m/embed``, ``opt/step``) and ``meta.json`` with ``step``,
  ``time``, ``extra`` and the sorted ``keys`` — the reference package's
  layout, so a checkpoint either one writes restores in the other;
* **dtypes**: numpy has no bfloat16, so such leaves are widened to
  float32 on disk; ``restore`` casts back to the template's dtype;
* **atomic**: write to ``<dir>/.tmp-<step>-<pid>`` then ``os.replace`` — a
  crash mid-save never corrupts the latest checkpoint;
* **async**: ``save_async`` snapshots the tensors to host memory (cheap)
  and serializes on a worker thread, so the training loop keeps stepping;
* **restore**: each array goes to its template leaf's device and dtype
  (and keeps its ``requires_grad``);
* **retention**: ``keep`` most-recent checkpoints are retained, the rest
  garbage-collected.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import tree as tr


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a copy even of a CPU tensor: the trainer
    updates its tensors in place while an async save writes)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    try:
        return leaf.numpy().copy()
    except TypeError:                    # bfloat16, fp8: widened on disk
        return leaf.float().numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[dict] = None) -> str:
        return self._write(step, self._snapshot(tree), extra or {})

    def save_async(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        # snapshot to host memory synchronously (the tensors change in place)
        host = self._snapshot(tree)

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:   # surfaced on next save/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(tree) -> Dict[str, np.ndarray]:
        return {k: _to_host(v) for k, v in tr.flatten_with_paths(tree)}

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               extra: dict) -> str:
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "time": time.time(), "extra": extra,
                "keys": sorted(flat.keys())}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            # same-step overwrite: replace atomically via a rename dance
            os.replace(os.path.join(tmp, "arrays.npz"),
                       os.path.join(final, "arrays.npz"))
            os.replace(os.path.join(tmp, "meta.json"),
                       os.path.join(final, "meta.json"))
            os.rmdir(tmp)
        else:
            os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            path = os.path.join(self.dir, f"step_{s:010d}")
            for f in os.listdir(path):
                os.unlink(os.path.join(path, f))
            os.rmdir(path)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None):
        """Restore into the structure of ``template``: each leaf comes back
        with its template tensor's shape, dtype, device and
        ``requires_grad`` (a numpy template leaf: its dtype)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = dict(data)
        leaves = []
        for key, tmpl in tr.flatten_with_paths(template):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = flat[key]
            want_shape = tuple(getattr(tmpl, "shape", arr.shape))
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != {want_shape}")
            if isinstance(tmpl, torch.Tensor):
                out = torch.from_numpy(arr).to(device=tmpl.device,
                                               dtype=tmpl.dtype)
                out.requires_grad_(tmpl.requires_grad)
            else:
                out = arr.astype(getattr(tmpl, "dtype", arr.dtype))
            leaves.append(out)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return tr.unflatten_like(template, leaves), meta
