"""Checkpoint manager: atomic, integrity-checked, async-capable.

Port of ``repro/checkpoint/manager.py``, with the reference's on-disk
layout, so a checkpoint either package writes restores in the other:

* ``step_N/`` holds one ``NNNNN.npy`` per leaf, in the reference's leaf
  order, and ``manifest.json``: ``{"step": N, "leaves": [{"name",
  "file", "shape", "dtype", "sha256"}, ...]}``, a leaf named by its key
  path (:func:`repro_torch.tree.flatten_with_names`, the names of the
  reference's ``_tree_paths``) and hashed over its bytes.
* **Atomicity** — writes land in ``step_N.tmp`` and are renamed only
  after the manifest is fsynced; a crash mid-save never corrupts the
  latest checkpoint.
* **Retention** — keep_k GC, never deleting the newest complete step.
* **Async** — leaves are copied to host memory on the caller's thread,
  then one background thread writes them, so the train loop only blocks
  on the previous save.
* **Sharded state** — a DTensor leaf is gathered whole before it is
  written (a collective: every rank of its mesh calls ``save``, and with
  a default process group only its rank 0 writes), and ``restore`` puts
  a leaf back under any target sharding: a DTensor target's mesh and
  placements (``distribute_tensor``), a plain target's device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as _tree


def _host(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _writer() -> bool:
    """Whether this process writes: rank 0 of the default process group,
    or the one process when there is none."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _like(arr: np.ndarray, like):
    """``arr`` placed as ``like`` lies: a DTensor's mesh and placements,
    a tensor's device, else the CPU."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    t = torch.from_numpy(arr)
    if isinstance(like, DTensor):
        return distribute_tensor(t.to(like.to_local().device),
                                 like.device_mesh, like.placements)
    return t.to(like.device if isinstance(like, torch.Tensor) else "cpu")


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_k = keep_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # --- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, block: bool = False):
        names, leaves, _ = _tree.flatten_with_names(state)
        host = [_host(x) for x in leaves]
        if not _writer():
            return
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, names, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, names, host)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, names, host):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr) in enumerate(zip(names, host)):
            fn = f"{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "name": name, "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                verify: bool = True):
        """Restore into the structure of ``target``: each leaf by its
        name, in the saved dtype, where ``target``'s leaf lies (a
        DTensor's mesh and placements, whatever the mesh the state was
        saved from; a tensor's device).  Returns (state, step); a checksum
        mismatch raises ``IOError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        names, leaves, treedef = _tree.flatten_with_names(target)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        out = []
        for name, like in zip(names, leaves):
            entry = by_name[name]
            arr = np.load(os.path.join(path, entry["file"]))
            if verify:
                h = hashlib.sha256(arr.tobytes()).hexdigest()
                if h != entry["sha256"]:
                    raise IOError(f"checksum mismatch for {name}")
            out.append(_like(arr, like))
        return _tree.unflatten(treedef, out), step
