"""Tiny pytree checkpointing: npz payload + JSON treedef manifest.

Port of ``repro.checkpoint.ckpt``, in its layout:
``<dir>/step_%08d/arrays.npz`` + ``manifest.json``. Trees are dicts,
lists and tuples nested to any depth with tensors, numpy arrays or
numbers as leaves. Leaf keys are the ``"/"``-joined paths in the order
``jax.tree_util`` flattens (dict keys sorted), and the manifest's
``treedef`` is the string a ``PyTreeDef`` prints, so a checkpoint
written by either package restores in the other. bfloat16 tensors are
stored as their raw 2-byte words (numpy's ``|V2``), as the reference's
bfloat16 arrays are. Restores to host numpy; ``convert.params_from_numpy``
puts a restored tree on a device.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _flatten_with_paths(tree: Pytree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _treedef_str(tree: Pytree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it."""
    def fmt(x):
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(fmt(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(fmt(v) for v in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def save_pytree(tree: Pytree, directory: str, step: int) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(tree)}
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrays),
                   "treedef": _treedef_str(tree)}, f)
    return d


def restore_pytree(template: Pytree, directory: str,
                   step: Optional[int] = None) -> Pytree:
    """The checkpoint at ``step`` (default: the latest) as a tree shaped
    like ``template``, with numpy arrays as leaves."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        leaves = iter([data[k] for k, _ in _flatten_with_paths(template)])

    def rebuild(x):
        if isinstance(x, dict):
            return {k: rebuild(x[k]) for k in sorted(x)}
        if _is_node(x):
            return type(x)(rebuild(v) for v in x)
        return next(leaves)
    return rebuild(template)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for n in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", n))]
    return max(steps) if steps else None
