"""Checkpointing: npz shards + manifest, atomic writes, resume (see
``repro.checkpoint.store``).

Fault-tolerance contract:

* every save is atomic: arrays land in ``<dir>/tmp.<step>.<process>`` and
  the directory is renamed to ``<dir>/step_<N>`` only after the manifest
  (per-leaf checksums, the caller's meta) is fully written;
* ``latest_step`` ignores partial directories, so a crash mid-save never
  corrupts a restart;
* each process writes ``shard_<process_index>.npz``.

A tree is nested dicts of tensors (or numpy arrays); a leaf's key is its
path joined by ``/``.  A saved leaf may also be a function that returns
the tensor, called when the leaf is written: a sharded run gathers each
leaf whole as rank 0 writes it, while the other ranks run the same
gathers (:func:`gather_leaves`), so a checkpoint holds a one-rank run's
tree whatever the grid.  A loaded leaf may be an object with ``shape``
(the whole leaf's) and ``copy_``, which keeps a rank's piece.  Leaves
are written and read one at a time, so the host holds one leaf at once,
not the whole state.  A bfloat16 leaf is
stored as its 16-bit pattern (numpy has no bfloat16) and the manifest
names its dtype.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import zipfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "gather_leaves", "latest_step",
           "read_manifest", "load_checkpoint", "config_hash"]

_MANIFEST = "manifest.json"


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, key + "/")
        else:
            yield key, v


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).data).hexdigest()[:16]


def _world() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def save_checkpoint(ckpt_dir: str, step: int, tree, meta: Optional[Dict] = None,
                    process_index: int = 0) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{process_index}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = {}
    shard_path = os.path.join(tmp, f"shard_{process_index}.npz")
    # np.savez's layout, one leaf at a time
    with zipfile.ZipFile(shard_path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in _leaves(tree):
            arr, dtype = _to_numpy(leaf() if callable(leaf) else leaf)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, arr, allow_pickle=False)
            leaves[key] = {"shape": list(arr.shape), "dtype": dtype,
                           "sha": _sha(arr)}
            del arr
    manifest = {"step": step, "leaves": leaves, "meta": meta or {},
                "n_processes": _world()}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic on POSIX
    return final


def gather_leaves(tree) -> None:
    """Call each function leaf of ``tree`` in the order
    :func:`save_checkpoint` writes the leaves, and drop what it returns:
    what a rank of a sharded run that writes no checkpoint runs while
    rank 0 saves (each call a collective that gathers one leaf)."""
    for _, leaf in _leaves(tree):
        if callable(leaf):
            leaf()


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
            steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None
                  ) -> Tuple[int, Dict]:
    """(step, manifest) of the newest complete checkpoint, or of ``step``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        return step, json.load(f)


def _restore(arr: np.ndarray, dtype: str, like, inplace: bool):
    """``arr`` as a leaf like ``like`` (its dtype and device), or copied
    into ``like`` when ``inplace`` (a tensor, or any object with ``shape``
    and ``copy_``: a sharded run's piece of the leaf)."""
    if torch.is_tensor(like) or (inplace and hasattr(like, "copy_")):
        t = torch.from_numpy(arr)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        if inplace:
            with torch.no_grad():
                return like.copy_(t)
        return t.to(device=like.device, dtype=like.dtype)
    if inplace:
        like[...] = arr
        return like
    return arr.astype(np.asarray(like).dtype)


def load_checkpoint(ckpt_dir: str, like, step: Optional[int] = None,
                    process_index: int = 0, inplace: bool = False
                    ) -> Tuple[int, Any, Dict]:
    """Restore the tree shaped like ``like`` from the newest checkpoint (or
    ``step``) -> (step, tree, meta); each leaf on ``like``'s device and in
    its dtype.  ``inplace`` copies each leaf into ``like``'s own tensor
    (no second copy of the state on the device).  A leaf whose checksum
    does not match raises ``IOError`` (leaves before it may already have
    been copied)."""
    step, manifest = read_manifest(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")

    def build(sub, prefix, z):
        out = {}
        for k in sorted(sub):
            key = f"{prefix}{k}"
            if isinstance(sub[k], dict):
                out[k] = build(sub[k], key + "/", z)
                continue
            if key not in z.files:
                raise KeyError(f"checkpoint {path} has no leaf {key}")
            arr = z[key]
            want = manifest["leaves"][key]
            if _sha(arr) != want["sha"]:
                raise IOError(f"checksum mismatch for {key} in {path}")
            if tuple(arr.shape) != tuple(sub[k].shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(sub[k].shape)}")
            out[k] = _restore(arr, want["dtype"], sub[k], inplace)
        return out

    with np.load(os.path.join(path, f"shard_{process_index}.npz")) as z:
        tree = build(like, "", z)
    return step, tree, manifest.get("meta", {})


def config_hash(cfg) -> str:
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
