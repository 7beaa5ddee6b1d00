"""Resumable checkpoints of tensor trees (counterpart of
``repro.checkpoint.checkpoint``, the same layout on disk).

Layout:  <dir>/step_<N>/
           manifest.json            — step, the leaves' ``/``-joined key
                                      paths, shapes and dtypes, extra
                                      data (a data cursor), process count
           shard_<p>.npz            — this process's arrays

A tree is nested dicts (keys visited sorted), lists, tuples and named
tuples of tensors; a leaf's key path joins its dict keys, indices and
field names with ``/``, as the reference's flatten-with-path does, so a
checkpoint written by either package restores into the other's tree.

* **Async save** — ``save`` copies every leaf to host memory before it
  returns (the state may then change in place), and writes to disk on a
  background thread when ``blocking=False``; ``wait()`` joins it, and the
  next save waits for the last.
* **Atomic** — writes go to a tmp dir renamed into place, so a crash
  during a save never corrupts the latest checkpoint.
* **GC** — only the newest ``keep`` checkpoints stay.
* **Resume equality** — with the seekable data pipeline, restoring step N
  reproduces the uninterrupted run bit for bit (tested).

A leaf numpy cannot hold (bf16) raises ``TypeError`` naming the leaf: the
train state is f32 and int32.

* **Sharded state** — a DTensor leaf is saved whole (``full_tensor``), so
  each ``shard_<rank>.npz`` holds the full state, as the reference's
  single-host layout does, and a checkpoint restores onto any mesh and
  any plan (elastic restore): ``restore(shardings=)`` places each leaf on
  its NamedSharding; a DTensor target leaf without one is placed as the
  target is.  Under a multi-rank process group rank 0 makes and renames
  the step's directory, the ranks meeting at a barrier between, and the
  save is synchronous; a rank whose file is missing (a larger world than
  the saver's) reads rank 0's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

PyTree = Any
_SEP = "/"


def process_index_count():
    """(process index, process count) of a ``torch.distributed`` job, or
    (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten_with_paths(tree: PyTree, prefix=()) -> Dict[str, Any]:
    """{key path: leaf}, in the reference's flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {_SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, prefix + (k,)))
    return out


def _rebuild(tree: PyTree, flat: Dict[str, Any], prefix=()) -> PyTree:
    """``tree``'s structure with each leaf replaced by ``flat``'s value at
    its key path."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, flat, prefix + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return flat[_SEP.join(prefix)]


def _barrier():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        dist.barrier()


def _to_host(key: str, leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory as a numpy array (a DTensor's
    whole value)."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        t = leaf.detach()
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if t.dtype not in (torch.float64, torch.float32, torch.float16,
                           torch.int64, torch.int32, torch.int16, torch.int8,
                           torch.uint8, torch.bool):
            raise TypeError(f"checkpoint leaf {key!r} is {t.dtype}, which "
                            f"numpy cannot hold; save it in float32")
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: PyTree, extra: Optional[Dict] = None,
             blocking: bool = True):
        """Snapshot to host memory synchronously; write to disk (optionally)
        in the background."""
        self.wait()
        host = {k: _to_host(k, v)
                for k, v in _flatten_with_paths(state).items()}
        if blocking or process_index_count()[1] > 1:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        index, count = process_index_count()
        if index == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        _barrier()
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "extra": extra,
            "process_count": count,
        }
        np.savez(os.path.join(tmp, f"shard_{index}.npz"), **flat)
        _barrier()
        if index == 0:
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
        _barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: PyTree, step: Optional[int] = None,
                shardings: Optional[PyTree] = None):
        """Restore into the structure of ``target``, a tree of tensors:
        each leaf comes back on its target's device in its dtype.
        ``shardings``: an optional tree of NamedShardings
        (``distributed.sharding``) — the elastic path (any mesh, any
        plan); a DTensor target leaf without one comes back placed as it.
        Returns (state, extra)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        index, _ = process_index_count()
        path = os.path.join(d, f"shard_{index}.npz")
        if not os.path.exists(path):
            path = os.path.join(d, "shard_0.npz")
        data = np.load(path)

        flat_target = _flatten_with_paths(target)
        missing = [k for k in flat_target if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint {d} missing keys {missing[:5]}...")
        flat_shard = _flatten_with_paths(shardings) if shardings else {}

        def build(key, like):
            from torch.distributed.tensor import DTensor

            from repro_torch.distributed.sharding import place
            arr = data[key]
            want_shape = tuple(like.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != {want_shape}")
            sh = flat_shard.get(key)
            if isinstance(like, DTensor):
                dev = like.to_local().device
                if sh is None:
                    sh = like
            else:
                dev = like.device
            t = torch.from_numpy(arr).to(device=dev, dtype=like.dtype)
            return t if sh is None else place(t, sh)

        restored = {k: build(k, v) for k, v in flat_target.items()}
        return _rebuild(target, restored), manifest.get("extra", {})
