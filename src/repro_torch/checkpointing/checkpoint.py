"""Checkpointing: pytree save/restore with a manifest, and async saves,
in the reference's on-disk format, so a checkpoint written by either
package restores in the other.

Layout per step:
    <dir>/step_<k>/manifest.json       key paths, logical shapes, dtypes
    <dir>/step_<k>/arrays.npz          flattened leaves
    <dir>/step_<k>/COMMIT              written last — torn saves are
                                       invisible to ``latest_step``

Counterpart of ``repro/checkpointing/checkpoint.py``.  Keys are the
reference's (``repro_torch.tree``: dict keys sorted, dataclass fields
in order, joined by ``/``), and a group — a leaf the reference stacks
over periods of layers — is stacked on save and split on restore, so
the manifest holds the reference's logical shapes.  bfloat16 (and
float8_e4m3fn) go to the npz file as raw ``uint16`` (``uint8``) views
with the logical dtype in the manifest; the views go through torch's
own integer views, so no ``ml_dtypes`` is needed.  Async saves
snapshot to host memory on the caller's thread and write in a
background thread; ``wait()`` joins it.

Elastic checkpoints: ``save(..., shardings=)`` takes a tree of this
rank's blocks, with a ``distributed.sharding.NamedSharding`` (mesh,
spec) per leaf: each leaf is gathered over the mesh and rank 0 writes
the whole, logical leaves — the reference's format, whatever the mesh.
``restore(..., shardings=)`` places each leaf's block for the current
mesh on this rank, so a checkpoint written on N ranks (or by the
reference on N devices) restores on M.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import block, gather_block

from repro_torch.tree import is_group, key_of, leaf_shape, \
    leaves_with_paths, map_leaves, stacked, unstacked

#: logical dtype → (its torch dtype, the torch integer view, the same
#: view in numpy, the unsigned type the npz file stores)
_VIEW_DTYPES = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.int8, np.uint8),
}


def _to_host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf (tensor, group, array or scalar) → (the array the npz file
    holds, its logical dtype)."""
    if isinstance(leaf, (torch.Tensor, list)):
        t = stacked(leaf).detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _VIEW_DTYPES:
            _, view, _, stored = _VIEW_DTYPES[name]
            return t.view(view).numpy().view(stored), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_host(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _VIEW_DTYPES:
        dt, _, view, _ = _VIEW_DTYPES[logical]
        return torch.from_numpy(np.ascontiguousarray(arr).view(view)) \
            .view(dt)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def save(directory: str, step: int, tree: Any,
         shardings: Any = None) -> Optional[str]:
    """Synchronous commit-protocol save.  With ``shardings`` (a tree of
    ``NamedSharding`` congruent with ``tree``, whose leaves are this
    rank's blocks) every rank of the mesh must call it: the leaves are
    gathered, rank 0 writes them, and every rank returns once the step
    is committed (rank 0 with its directory, the others with None)."""
    if shardings is not None:
        tree = map_leaves(gather_block, tree, shardings)
        mesh = next(sh.mesh for _, sh in leaves_with_paths(shardings))
        out = save(directory, step, tree) if mesh.rank == 0 else None
        if mesh.bound:
            dist.barrier()
        return out
    step_dir = os.path.join(directory, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    manifest = {"step": step, "leaves": []}
    arrays = {}
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        if isinstance(leaf, _Host):
            arr, logical = leaf.arr, leaf.logical
        else:
            arr, logical = _to_host(leaf)
        name = f"a{i}"
        arrays[name] = arr
        manifest["leaves"].append({
            "key": key_of(path), "name": name, "shape": list(arr.shape),
            "dtype": logical})
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    return step_dir


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "COMMIT")):
                best = max(best or -1, int(d[5:]))
    return best


def restore(directory: str, step: int, target: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``target``: a tree of tensors or
    groups (``device="meta"`` tensors serve as shape/dtype specs) of the
    whole, logical leaves.  Each leaf comes back as a new tensor of the
    target's dtype, split where the target leaf is a group, on the
    target's device (the CPU for a meta target).  With ``shardings``
    (a tree of ``NamedSharding`` congruent with ``target``) each leaf is
    this rank's block of it on its mesh — the elastic-resume path."""
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: (leaf["name"], leaf["dtype"])
              for leaf in manifest["leaves"]}

    tgt_leaves = list(leaves_with_paths(target))
    missing = [key_of(p) for p, _ in tgt_leaves if key_of(p) not in by_key]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]} ...")

    def load(path, tgt):
        key = key_of(path)
        name, logical = by_key[key]
        t = _from_host(data[name], logical)
        like = tgt[0] if is_group(tgt) else tgt
        if tuple(t.shape) != leaf_shape(tgt):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"target {leaf_shape(tgt)}")
        dev = "cpu" if like.device.type == "meta" else like.device
        sh = placed.get(key)
        if sh is not None:
            t = block(sh.mesh, sh.spec, t).clone()
        return unstacked(t.to(dtype=like.dtype, device=dev), tgt)

    placed = {} if shardings is None else {
        key_of(p): sh for p, sh in leaves_with_paths(shardings)}
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        return map_leaves(load, target, with_path=True)


class _Host:
    """A leaf already copied to host memory: its array and logical
    dtype."""

    def __init__(self, leaf: Any) -> None:
        self.arr, self.logical = _to_host(leaf)


class AsyncCheckpointer:
    """Background-thread saver with the same commit protocol."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: list[int] = []

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host memory on the caller's thread (the live
        # tensors change at the next step), then write in background
        host_tree = map_leaves(_Host, tree)

        def work():
            save(self.directory, step, host_tree)
            self.saved.append(step)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(d[5:]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
