"""Fault-tolerant checkpointing: atomic, manifested, optionally async.

A port of ``repro.checkpoint.ckpt`` onto ``torch.save`` / ``torch.load``.
Layout::

    <dir>/step_000123/
        arrays.pt           # the tree's tensors, leaf_0 .. leaf_{n-1}
        manifest.json       # leaf names, shapes, dtypes, step, extras
    <dir>/LATEST            # atomic pointer file (write-temp + rename)

Guarantees, as in the reference:

* a checkpoint is visible (pointed to by LATEST) only after all bytes
  are on disk (a temporary directory, then ``os.replace``);
* an interrupted save leaves the previous LATEST intact;
* :class:`AsyncCheckpointer` copies the tensors to host memory
  synchronously (the only part that must agree with the training state)
  and writes them on a background thread.

Trees are the port's containers (:mod:`repro_torch.tree`): nested
dicts, lists and tuples (``TrainState`` and ``OptState`` included) of
tensors.  A restore gives back the saved bits exactly, on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]


def _names(tree: Any, prefix: str = "") -> List[str]:
    """Leaf paths in :func:`tree_leaves` order (``.params['embed']`` ...)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [n for f, x in zip(tree._fields, tree)
                for n in _names(x, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in _names(x, f"{prefix}[{i}]")]
    return [prefix]


def _host_copy(x: Any) -> torch.Tensor:
    if not torch.is_tensor(x):
        raise TypeError(f"checkpoint leaves must be tensors, got {type(x)}")
    return x.detach().to("cpu", copy=True)


def save(directory: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous checkpoint.  Returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    names = _names(tree)
    host = [x.detach().cpu() for x in tree_leaves(tree)]
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        torch.save({f"leaf_{i}": t for i, t in enumerate(host)},
                   os.path.join(tmp, "arrays.pt"))
        manifest = {
            "step": int(step),
            "names": names,
            "shapes": [list(t.shape) for t in host],
            "dtypes": [str(t.dtype) for t in host],
            "extras": extras or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    """The step LATEST points at, or None when there is no checkpoint."""
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(directory: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a template tree).

    Leaves come back as CPU tensors with the saved dtypes and bits;
    callers move them to their device (which is what lets a restore
    follow an elastic restart onto another mesh).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = torch.load(os.path.join(path, "arrays.pt"), map_location="cpu",
                      weights_only=True)
    leaves = [data[f"leaf_{i}"] for i in range(len(manifest["names"]))]
    flat_like = tree_leaves(like)
    if len(flat_like) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the template "
                         f"{len(flat_like)}")
    for name, a, b in zip(manifest["names"], flat_like, leaves):
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"checkpoint leaf {name} is {tuple(b.shape)}, "
                             f"the template's {tuple(a.shape)}")
    return tree_unflatten(like, leaves), manifest["step"], manifest["extras"]


def _checkpoint_bytes(path: str) -> int:
    """Bytes on disk under one checkpoint directory."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointing.

    ``save`` copies the tensors to host memory synchronously, then a
    writer thread writes them.  ``wait()`` joins the write in flight; a
    new save waits for the previous one (one writer at a time).
    ``last`` describes the last finished save: its step, path, bytes,
    and the seconds of the host snapshot and of the write.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last: Optional[Dict[str, Any]] = None

    def save(self, step: int, tree: Any,
             extras: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        snap = obs.tracer().timer("checkpoint.snapshot", step=step)
        with snap:
            host_tree = tree_map(_host_copy, tree)

        def work():
            try:
                write = obs.tracer().timer("checkpoint.write", step=step)
                with write:
                    path = save(self.directory, step, host_tree, extras)
                self.last = {"step": int(step), "path": path,
                             "bytes": _checkpoint_bytes(path),
                             "snapshot_s": snap.elapsed,
                             "write_s": write.elapsed}
            except BaseException as e:  # surfaced on the next wait()
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
