"""Checkpoints of the port's training state: twin of
``repro/ckpt/checkpoint.py`` (manifest + one ``.npy`` per leaf, atomic,
asynchronous), with the elastic ``restore_sharded``: the host leaves
placed as DTensors on whatever ``DeviceMesh`` is current.

Layout of a checkpoint directory, the reference's::

    <root>/step_000123/
        MANIFEST.json     # step, tree description, leaf paths, shapes, dtypes
        leaf_00000.npy ...

Leaves are numbered in ``repro_torch.tree``'s flattening order (depth
first, dict keys sorted, list and tuple entries in order). numpy has no
bfloat16, so a bf16 leaf is stored as its int16 bits and the manifest
records ``bfloat16``. Writes go to ``<root>/.tmp_<step>`` and are renamed
into place, so a crash mid-save never leaves a partial ``step_*``
directory (``latest_step`` counts only those). ``AsyncSaver`` copies the
tree to the host on the caller's thread and writes on another.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist import sharding

_BITS = {torch.bfloat16: torch.int16}
_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int8,
    torch.int16, torch.int32, torch.int64, torch.uint8, torch.bool)}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(leaf) -> torch.Tensor:
    """The leaf as one whole tensor (a DTensor gathered from its mesh)."""
    t = torch.as_tensor(leaf).detach()
    return t.full_tensor() if sharding._is_dtensor(t) else t


def _to_numpy(leaf) -> np.ndarray:
    t = _host(leaf).cpu()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _describe(state: Any) -> str:
    """The tree's structure with ``*`` for each leaf."""
    return repr(tree.unflatten(state, ["*"] * len(tree.leaves(state))))


def save(root: str, step: int, state: Any) -> str:
    """Synchronous atomic save. Returns the final directory."""
    flat = tree.flatten(state)
    tmp = os.path.join(root, f".tmp_{step}")
    final = os.path.join(root, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "treedef": _describe(state),
                "n_leaves": len(flat), "leaves": []}
    for i, (path, leaf) in enumerate(flat):
        t = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), _to_numpy(t))
        manifest["leaves"].append({"path": list(map(str, path)),
                                   "shape": list(t.shape),
                                   "dtype": _name(t.dtype)})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncSaver:
    """One in-flight save at a time; join() before exit."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, root: str, step: int, state: Any) -> None:
        self.join()
        host = tree.map_(lambda t: _host(t).to("cpu", copy=True),
                         state)                        # snapshot on caller
        self._thread = threading.Thread(target=save, args=(root, step, host),
                                        daemon=True)
        self._thread.start()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(root: str, gc_tmp: bool = False) -> Optional[int]:
    """Newest COMPLETE checkpoint step, or None. ``.tmp_<step>`` dirs (a
    crash mid-save leaves one) are never counted; with ``gc_tmp`` they are
    also swept, which is safe exactly when no save is in flight (the
    restore at loop start)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_"):
            steps.append(int(d.split("_")[1]))
        elif gc_tmp and d.startswith(".tmp_"):
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    return max(steps) if steps else None


def restore(root: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf checked against
    the like leaf's shape and dtype and placed on its device."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    refs = tree.leaves(like)
    if manifest["n_leaves"] != len(refs):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"restore target has {len(refs)}")
    out = []
    for i, (ref, meta) in enumerate(zip(refs, manifest["leaves"])):
        ref = torch.as_tensor(ref)
        dtype = _DTYPES[meta["dtype"]]
        if dtype != ref.dtype:
            raise ValueError(f"leaf {i}: dtype {meta['dtype']} != "
                             f"{_name(ref.dtype)}")
        t = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy")))
        if dtype in _BITS:
            t = t.view(dtype)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"{tuple(ref.shape)}")
        out.append(t.to(ref.device))
    return tree.unflatten(like, out), step


def restore_sharded(root: str, like: Any, spec_tree: Any, mesh,
                    step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore, then place every leaf on the current ``mesh`` (a
    ``DeviceMesh`` of the current process group) with the placements of
    its spec in ``spec_tree`` (``dist.sharding.placements``; a ``None``
    spec replicates): the elastic re-shard, whatever layout the checkpoint
    was saved from. The leaves must lie on the mesh's device type."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding
    host, step = restore(root, like, step)
    placed = [distribute_tensor(x, mesh, sharding.placements(mesh, spec))
              for x, spec in sharding.spec_leaves(host, spec_tree)]
    return tree.unflatten(host, placed), step


def prune(root: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(root):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(root)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)
