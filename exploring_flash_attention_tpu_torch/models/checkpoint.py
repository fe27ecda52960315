"""Checkpoint and resume of the port's training state.

Counterpart of ``models/checkpoint.py`` in the JAX package, in its file
format, so that a checkpoint written by either package restores in the
other, bit for bit:

- one ``ckpt_{step}.npz`` holding ``__meta__`` (JSON: ``step``,
  ``n_leaves`` and ``dtype_{i}`` = ``"bfloat16"`` for each bf16 leaf) and
  the leaves as ``leaf_{i}`` in ``jax.tree_util`` order (``models/tree.py``:
  dictionary keys sorted, lists in order), bf16 stored as uint16 views;
- the write is atomic: a temporary file in the same directory, then
  ``os.replace``, so a save cut short leaves the previous checkpoint whole;
- ``latest_checkpoint`` picks the highest step;
- restore checks the leaf count and every shape against ``tree_like`` and
  raises ``ValueError`` (the JAX wording) on a mismatch.

JAX's ``treedef`` string is not written: only ``n_leaves`` and the shapes
are checked, as JAX checks them.

**Optimizer state stays port-native.**  A ``torch.optim.Optimizer`` in the
tree stands for its state, stored as further leaves in this order: its
parameters in ``param_groups`` order (the order of the leaf list it was
built over, ``param_leaves``), and for each one its state tensors by key
name (``exp_avg``, ``exp_avg_sq``, ``step`` for Adam and AdamW).  The
hyperparameters are not stored; they come from the code that builds the
optimizer, as optax keeps them out of its state.  On restore, an
optimizer in ``tree_like`` (one that has taken a step, so that its state
exists) gives a ``state_dict`` that ``Optimizer.load_state_dict`` takes,
for example on an optimizer built over the restored parameters.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from exploring_flash_attention_tpu_torch.models.tree import (
    tree_leaves,
    tree_unflatten,
)

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _expand(tree: Any) -> Any:
    """``tree`` with every optimizer replaced by its per-parameter state,
    by parameter index as ``state_dict()["state"]`` numbers it (its
    ``param_groups`` order)."""
    if isinstance(tree, torch.optim.Optimizer):
        return tree.state_dict()["state"]
    if isinstance(tree, dict):
        return {k: _expand(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_expand(x) for x in tree)
    return tree


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, bool]:
    """(array to store, whether it is a bf16 leaf's uint16 view)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":             # an ml_dtypes array
        return arr.view(np.uint16), True
    return arr, False


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically write ``tree`` as ``ckpt_dir/ckpt_{step}.npz`` and return
    its path.  ``tree`` is a nested dict/list of tensors (or arrays), and
    may hold optimizers (see the module note)."""
    leaves = tree_leaves(_expand(tree))
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    meta = {"step": step, "n_leaves": len(leaves)}
    for i, leaf in enumerate(leaves):
        arrays[f"leaf_{i}"], is_bf16 = _to_numpy(leaf)
        if is_bf16:
            meta[f"dtype_{i}"] = "bfloat16"
    path = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)                      # atomic publish
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint in ``ckpt_dir`` (None if there
    is none, or no such directory)."""
    best, best_step = None, -1
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return None
    for name in names:
        m = _STEP_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = name, int(m.group(1))
    return os.path.join(ckpt_dir, best) if best else None


def _restore_leaf(arr: np.ndarray, bf16: bool, like: Any) -> torch.Tensor:
    """The stored array as a tensor of its stored dtype, on ``like``'s
    device (the CPU for a leaf that is no tensor), with ``like``'s
    ``requires_grad``."""
    t = (torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
         if bf16 else torch.from_numpy(np.array(arr)))
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
        if like.requires_grad:
            t.requires_grad_(True)
    return t


def _collapse(restored: Any, like: Any) -> Any:
    """``restored`` (``_expand(like)``'s structure) with each optimizer's
    state turned into a ``state_dict`` for ``load_state_dict``."""
    if isinstance(like, torch.optim.Optimizer):
        return {"state": restored,
                "param_groups": like.state_dict()["param_groups"]}
    if isinstance(like, dict):
        return {k: _collapse(restored[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_collapse(r, v) for r, v in zip(restored, like))
    return restored


def restore_checkpoint(path: str, tree_like: Any) -> Tuple[Any, int]:
    """Restore ``(tree, step)``.  ``tree_like`` supplies the structure and
    validates the leaf count and shapes; every leaf comes back as a new
    tensor of the stored dtype on the device of ``tree_like``'s leaf, and
    every optimizer as a ``state_dict`` (see the module note)."""
    expanded = _expand(tree_like)
    leaves_like = tree_leaves(expanded)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["n_leaves"] != len(leaves_like):
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, expected "
                f"{len(leaves_like)} — model/optimizer config mismatch"
            )
        leaves = []
        for i, like in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            like_shape = tuple(like.shape if isinstance(like, torch.Tensor)
                               else np.shape(like))
            if tuple(arr.shape) != like_shape:
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != expected "
                    f"{like_shape}"
                )
            leaves.append(_restore_leaf(
                arr, meta.get(f"dtype_{i}") == "bfloat16", like))
    return _collapse(tree_unflatten(expanded, leaves), tree_like), meta["step"]
