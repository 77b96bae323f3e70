"""Fault-tolerant checkpointing: atomic, async, restore onto any device.

The port of the reference's ``train/checkpoint.py``, with the same commit
protocol:

  * **atomic**: a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
    renamed to ``step_XXXXXXXX/`` only when complete, the manifest last: a
    crash mid-write never corrupts the restore point (``latest_step``
    ignores ``.tmp``).
  * **async**: ``save_async`` copies every tensor to host memory (the only
    synchronous part) and writes in a background thread, so training
    continues through the I/O. The copy is a real one even for a CPU
    tensor, so the next in-place step cannot reach the snapshot.
  * **restore anywhere**: ``restore`` places each tensor on the device
    asked for (default: that of the matching tensor of ``like``).
  * **self-describing**: a manifest records the names, shapes, dtypes and
    user metadata (data cursor, step).

A tree is nested dicts, lists, tuples and NamedTuples (``OptState``) of
tensors; a leaf's file name joins its keys with ``__``, and a None subtree
holds nothing. numpy has no bfloat16, so a bf16 tensor is saved as its
int16 bits and the manifest records ``bfloat16``; ``restore`` views the
bits back.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "gc_checkpoints",
           "wait_for_pending", "flatten"]

_MANIFEST = "manifest.json"
_pending: list[threading.Thread] = []


def flatten(tree, prefix: tuple = ()) -> list:
    """[(name, tensor)] in the tree's order; a name joins the keys with ``__``."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [("__".join(prefix) or "leaf", tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"checkpoint: cannot store a {type(tree).__name__}")
    return [leaf for key, sub in items for leaf in flatten(sub, prefix + (str(key),))]


def _unflatten(like, leaves):
    """``like``'s structure with its tensors taken in order from the iterator
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(sub, leaves) for sub in like))
    if isinstance(like, dict):
        return {key: _unflatten(sub, leaves) for key, sub in like.items()}
    return type(like)(_unflatten(sub, leaves) for sub in like)


def _ckpt_dir(root: Path, step: int) -> Path:
    return root / f"step_{step:08d}"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that shares no memory with ``t``."""
    return t.detach().to("cpu", copy=True)


def _write(root: Path, step: int, flat: list, metadata: Optional[dict], keep: int) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    final = _ckpt_dir(root, step)
    tmp = final.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    names = []
    for name, t in flat:
        t = t.detach().cpu()
        dtype = str(t.dtype).removeprefix("torch.")
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        np.save(tmp / f"{name}.npy", arr)
        names.append({"name": name, "shape": list(t.shape), "dtype": dtype})
    manifest = {"step": step, "leaves": names, "metadata": metadata or {}}
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # the atomic commit
    gc_checkpoints(root, keep=keep)
    return final


def save(root: str | Path, step: int, tree: Any, metadata: Optional[dict] = None,
         keep: int = 3) -> Path:
    """Synchronous atomic checkpoint write."""
    return _write(Path(root), step, flatten(tree), metadata, keep)


def save_async(root: str | Path, step: int, tree: Any,
               metadata: Optional[dict] = None, keep: int = 3) -> threading.Thread:
    """Copy to host now, write in the background."""
    snapshot = [(name, _host(t)) for name, t in flatten(tree)]
    t = threading.Thread(target=_write, args=(Path(root), step, snapshot, metadata, keep),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_for_pending():
    for t in list(_pending):
        t.join()
        _pending.remove(t)


def _steps(root: Path) -> list:
    """The committed steps under ``root``, ascending."""
    if not root.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in root.iterdir()
                  if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp")
                  and (d / _MANIFEST).exists())


def latest_step(root: str | Path) -> Optional[int]:
    steps = _steps(Path(root))
    return steps[-1] if steps else None


def restore(root: str | Path, step: int, like: Any, device=None):
    """Load checkpoint ``step`` shaped like ``like``: each tensor in the
    dtype of ``like``'s tensor of that name, on ``device`` (None: that
    tensor's device). Returns (tree, metadata)."""
    d = _ckpt_dir(Path(root), step)
    manifest = json.loads((d / _MANIFEST).read_text())
    dtypes = {leaf["name"]: leaf["dtype"] for leaf in manifest["leaves"]}
    leaves = []
    for name, t in flatten(like):
        arr = torch.from_numpy(np.load(d / f"{name}.npy"))
        if dtypes[name] == "bfloat16":
            arr = arr.view(torch.bfloat16)
        leaves.append(arr.to(device=t.device if device is None else device, dtype=t.dtype))
    return _unflatten(like, iter(leaves)), manifest["metadata"]


def gc_checkpoints(root: str | Path, keep: int = 3):
    root = Path(root)
    for s in _steps(root)[:-keep] if keep else []:
        shutil.rmtree(_ckpt_dir(root, s), ignore_errors=True)
