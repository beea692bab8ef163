"""Atomic, manifest-driven checkpoints (port of ``repro/train/checkpoint.py``,
same on-disk layout, so either package reads the other's):

    <dir>/step_<N>/            (written to step_<N>.tmp, then renamed)
        manifest.json          (step, leaf paths, shapes, dtypes, meta)
        <i>.npy                (one file per leaf)
    <dir>/LATEST               (the last durable step)

Leaves are found and named by :mod:`repro_torch.tree` (the reference's
``keystr`` paths). Tensors are written from wherever they live: a host
tensor straight from host memory, a device tensor through one copy.
``restore`` returns numpy leaves; the caller places them (the serving
lifecycle puts them on its template's devices). numpy has no bfloat16:
a bf16 tensor is written as its int16 bits (the manifest says
``bfloat16``) and comes back as a bf16 CPU tensor. ``restore_distributed``
places them itself: the counterpart of the reference's ``NamedSharding``
is a device, or :class:`RowShard` -- this rank's row slice under a process
group -- so a checkpoint written under one placement (or by the reference
under one mesh) restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree

__all__ = ["save", "restore", "latest_step", "available_steps",
           "restore_distributed", "RowShard"]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree_: Any,
         meta: Optional[Dict] = None) -> str:
    """Write a checkpoint atomically; returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    paths, leaves, _ = tree.flatten_with_paths(tree_)
    manifest = {"step": step, "leaves": [], "meta": meta or {}}
    for i, (p, leaf) in enumerate(zip(paths, leaves)):
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        manifest["leaves"].append(
            {"path": p, "file": f"{i}.npy", "shape": list(arr.shape),
             "dtype": "bfloat16" if bf16 else str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def available_steps(ckpt_dir: str):
    """Ascending durable step numbers (renamed ``step_<N>`` directories;
    ``.tmp`` partial writes excluded): the chain a restore of a corrupted
    snapshot walks backwards."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name[len("step_"):]))
            except ValueError:
                continue
    return sorted(steps)


def restore(ckpt_dir: str, target_tree: Any, step: Optional[int] = None,
            strict_shapes: bool = True):
    """Load into the structure of ``target_tree``; shapes must match unless
    ``strict_shapes=False``, when the template gives the structure only and
    the manifest the shapes. Returns ``(tree, step, meta)`` with numpy
    leaves; template leaves that are python scalars come back as their own
    type."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}
    paths, leaves, treedef = tree.flatten_with_paths(target_tree)
    missing = [p for p in paths if p not in by_path]
    if missing:
        raise ValueError(f"checkpoint is missing leaves {missing[:4]} "
                         f"(of {len(missing)})")
    out = []
    for p, leaf in zip(paths, leaves):
        arr = np.load(os.path.join(d, by_path[p]["file"]))
        if strict_shapes:
            expect = tuple(leaf.shape) if hasattr(leaf, "shape") \
                else np.shape(leaf)
            if tuple(arr.shape) != expect:
                raise ValueError(f"checkpoint leaf {p} shape {arr.shape} != "
                                 f"target {expect}")
        if isinstance(leaf, (bool, int, float)):
            out.append(type(leaf)(arr))
        elif by_path[p]["dtype"] == "bfloat16" and arr.dtype == np.int16:
            out.append(torch.from_numpy(arr).view(torch.bfloat16))
        else:
            out.append(arr)
    return treedef.unflatten(out), manifest["step"], manifest["meta"]


class RowShard:
    """Placement of a leaf as one rank's equal contiguous row slice:
    rows ``[r n / S, (r + 1) n / S)`` of its first dimension, on
    ``device``. ``r`` and ``S`` come from a ``torch.distributed`` process
    ``group`` (its rank and size) or are given as ``rank`` and
    ``n_shards``."""

    __slots__ = ("device", "rank", "n_shards")

    def __init__(self, device, group=None, rank: Optional[int] = None,
                 n_shards: Optional[int] = None):
        if group is not None:
            import torch.distributed as dist
            rank, n_shards = dist.get_rank(group), dist.get_world_size(group)
        if rank is None or not n_shards or not 0 <= rank < n_shards:
            raise ValueError("RowShard needs a group, or a rank below "
                             "n_shards")
        self.device = torch.device(device)
        self.rank, self.n_shards = int(rank), int(n_shards)

    def __repr__(self):
        return (f"RowShard({self.device}, rank={self.rank}, "
                f"n_shards={self.n_shards})")

    def place(self, arr: np.ndarray) -> torch.Tensor:
        n = arr.shape[0]
        if n % self.n_shards:
            raise ValueError(f"{n} rows do not split into {self.n_shards} "
                             "equal shards")
        per = n // self.n_shards
        rows = arr[self.rank * per:(self.rank + 1) * per]
        if isinstance(rows, torch.Tensor):          # a bf16 leaf
            return rows.contiguous().to(self.device)
        return torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)


def _place(leaf, placement):
    if not isinstance(leaf, (np.ndarray, torch.Tensor)):
        return leaf                     # a python scalar of the template
    if isinstance(placement, RowShard):
        return placement.place(leaf)
    if isinstance(leaf, torch.Tensor):  # a bf16 leaf
        return leaf.to(torch.device(placement))
    return torch.from_numpy(np.ascontiguousarray(leaf)).to(
        torch.device(placement))


def restore_distributed(ckpt_dir: str, target_tree: Any, placements: Any,
                        step: Optional[int] = None):
    """Elastic restore: :func:`restore`, then each leaf placed where
    ``placements`` says -- one placement for every leaf, or a tree of the
    target's structure with a placement at each leaf. A placement is a
    device (``"cuda:0"``, ``torch.device``) or a :class:`RowShard`. The
    placement that wrote the checkpoint does not matter. Returns
    ``(tree, step, meta)``."""
    restored, step, meta = restore(ckpt_dir, target_tree, step)
    leaves, treedef = tree.flatten(restored)
    if isinstance(placements, (str, torch.device, RowShard)):
        places = [placements] * len(leaves)
    else:
        places, pdef = tree.flatten(placements)
        if pdef != treedef:
            raise ValueError("placements must have the target's structure")
    return (treedef.unflatten([_place(x, p) for x, p in zip(leaves, places)]),
            step, meta)
