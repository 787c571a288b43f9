"""Sharded, atomic, resumable checkpointing (no external deps).

A port of the JAX package's ``train/checkpoint.py``, in its layout and
bytes, so a checkpoint written by either package restores in the other::

    <dir>/step_000042/
        meta.json            # step, leaf count, shard index, dtypes, extras
        shard_00000.npz      # flat arrays leaf_<i> (split across shards)
    <dir>/LATEST             # atomically-updated pointer file

Writes go to ``step_xxx.tmp`` then ``os.replace`` to the final name, so a
crash mid-write never corrupts the latest checkpoint: the restart path
reads ``LATEST`` and falls back to the newest complete directory. Arrays
are saved logically unsharded.

The leaves are a tree's in ``jax.tree_util`` order (dict keys sorted,
lists by index); a train state (:mod:`repro_torch.train.step`) is written
as the reference's ``{"opt": {"mu", "nu", "step"}, "params"[,
"residual"]}`` with an LM's layers stacked, one stacked leaf built at a
time. bfloat16 leaves are written as their ``uint16`` bits and named in
``exotic_dtypes``, and decoded from those bits (the reference decodes
them with ``ml_dtypes``). The reference writes its tree structure as a
JAX proto under ``treedef``; the port writes ``null`` there, and neither
restore reads it.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "available_steps"]

_MAX_SHARD_BYTES = 1 << 30

# dtype name -> (the unsigned view written, the torch dtype read back)
_EXOTIC = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
           "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.int8}


def _is_state(tree) -> bool:
    from repro_torch.optim.optimizer import AdamW
    return isinstance(tree, dict) and isinstance(tree.get("opt"), AdamW)


def _leaf_getters(tree) -> list:
    from repro_torch.train.step import state_leaves, tree_leaves
    if _is_state(tree):
        return [get for _, get in state_leaves(tree)]
    return [lambda x=x: x for _, x in tree_leaves(tree)]


def _encode(x) -> tuple[np.ndarray, str | None]:
    """npz can't store bf16/f8: view as uint + remember the dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        name = str(x.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            view, _ = _EXOTIC[name]
            bits = x.view(_SIGNED[view]).cpu().numpy().view(view)
            return bits, name
        return x.cpu().numpy(), None
    arr = np.asarray(x)
    if arr.dtype.name in _EXOTIC:
        return arr.view(_EXOTIC[arr.dtype.name][0]), arr.dtype.name
    return arr, None


def _decode(arr: np.ndarray, name: str | None) -> torch.Tensor:
    if name is None:
        return torch.from_numpy(np.array(arr))
    view, dtype = _EXOTIC[name]
    signed = np.array(arr).view(np.dtype(view).str.replace("u", "i"))
    return torch.from_numpy(signed).view(dtype)


def save_checkpoint(directory: str, step: int, tree, *, extras: dict | None
                    = None, keep: int = 3) -> str:
    """Write ``tree`` (a train state, or nested dicts/lists of tensors or
    arrays) as checkpoint ``step`` under ``directory``; keep the newest
    ``keep``. -> the checkpoint's directory."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    # shard arrays into ~1GB npz files, each written when it is full
    shard: dict[str, np.ndarray] = {}
    size, n_shards = 0, 0
    index, exotic = [], []

    def flush():
        np.savez(os.path.join(tmp, f"shard_{n_shards:05d}.npz"), **shard)

    for i, get in enumerate(_leaf_getters(tree)):
        arr, dtype_name = _encode(get())
        if size + arr.nbytes > _MAX_SHARD_BYTES and shard:
            flush()
            shard, size, n_shards = {}, 0, n_shards + 1
        shard[f"leaf_{i}"] = arr
        size += arr.nbytes
        index.append(n_shards)
        exotic.append(dtype_name)
    flush()

    meta = {
        "step": step,
        "treedef": None,
        "n_leaves": len(index),
        "shard_of_leaf": index,
        "exotic_dtypes": exotic,
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    # atomic LATEST pointer
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))

    # retention
    steps = available_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    return final


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.isfile(os.path.join(directory, d, "meta.json")):
            out.append(int(d[5:]))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if os.path.isfile(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        if os.path.isfile(os.path.join(directory, name, "meta.json")):
            return int(name[5:])
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like``; -> (tree, extras), or
    (None, None) when there is no checkpoint.

    A train state is written into in place (its parameters, moments,
    residuals and step, on their devices) and returned; any other tree
    gives a tree of its structure holding CPU tensors of the saved
    dtypes. Raises ``ValueError`` when the leaf count, or a train state's
    leaf shape or dtype, differs: the structure changed.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    n_like = len(_leaf_getters(tree_like))
    if meta["n_leaves"] != n_like:
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, "
                         f"expected {n_like}: structure changed?")
    exotic = meta.get("exotic_dtypes") or [None] * meta["n_leaves"]
    shard_files: dict = {}
    out = []
    try:
        for i in range(meta["n_leaves"]):
            si = meta["shard_of_leaf"][i]
            if si not in shard_files:
                shard_files[si] = np.load(
                    os.path.join(path, f"shard_{si:05d}.npz"))
            out.append(_decode(shard_files[si][f"leaf_{i}"], exotic[i]))
    finally:
        for f in shard_files.values():
            f.close()
    if _is_state(tree_like):
        from repro_torch.train.step import load_state_leaves
        return load_state_leaves(tree_like, out), meta["extras"]
    return _rebuild(tree_like, iter(out)), meta["extras"]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)
