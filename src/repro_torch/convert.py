"""Carrying parameters between ``repro``'s pytrees and the port.

The port keeps ``repro``'s layouts (HWIO conv weights, the same dict
keys, the transformer's list of stacked super-blocks), so a conversion
is a per-leaf copy through numpy: nothing is transposed or renamed, and
a round trip is exact. Trees are dicts and lists nested to any depth:
the CNN's flat dict, the transformer's list of blocks, or the D3QN
agent's ``{"bilstm": {"fwd": {"wx", "wh", "b"}, "bwd": ...}, "trunk":
{"w", "b"}, "v_head": ..., "a_head": ...}``.

The HFL engines train a flat ``{name: tensor}`` dict. A nested payload
(a sequence classifier's ``{"blocks": [{"mix": {...}, ...}], "embed",
...}``) crosses that boundary through :func:`flatten_params`, keyed by
path strings whose sorted order is JAX's leaf order (dict keys sorted at
every level, lists by index), and back through
:func:`unflatten_params`. A flat dict flattens to itself.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map

# Path separator of the flat keys: below every character of a key
# (digits, letters, "_"), so "norm1/scale" sorts before "norm1_x/..." as
# "norm1" sorts before "norm1_x" in JAX's order.
SEP = "/"


def _to_tensor(v, dev):
    if isinstance(v, torch.Tensor):
        return v.detach().to(dev, torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)


def params_from_numpy(tree, device="cuda"):
    """A tree of array-likes (e.g. ``repro`` params passed through
    ``np.asarray``, or the port's own tensors) -> the same tree of f32
    tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda v: _to_tensor(v, dev), tree)


def params_to_numpy(tree):
    """A tree of the port's tensors -> the same tree of numpy arrays."""
    return tree_map(lambda v: v.detach().cpu().numpy(), tree)


def lanes_from_numpy(trees, device="cuda"):
    """S parameter trees of array-likes (one a sweep lane, e.g. the
    reference's initial weights through ``np.asarray``) -> one flat dict
    of lane-stacked f32 tensors, each leaf (S, ...), on ``device``."""
    trees = [flatten_params(t) for t in trees]
    dev = resolve_device(device)
    return {k: torch.stack([_to_tensor(t[k], dev) for t in trees])
            for k in trees[0]}


def flatten_params(tree) -> dict:
    """A nested params tree -> a flat dict keyed by path strings
    (``"blocks/0/mix/wq"``), in JAX's leaf order; the leaves are the
    tree's own (no copies). List indices are zero-padded to one width
    per list, so they sort by value. A flat dict (the CNN's, or one made
    here) comes back with the same keys."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                if not k or k.isdigit():
                    raise ValueError(f"key {k!r} cannot be a path segment")
                walk(node[k], prefix + (k,))
        elif isinstance(node, (list, tuple)):
            width = len(str(len(node) - 1))
            for i, v in enumerate(node):
                walk(v, prefix + (str(i).zfill(width),))
        else:
            out[SEP.join(prefix)] = node

    walk(tree, ())
    return out


def unflatten_params(flat) -> dict:
    """Inverse of :func:`flatten_params`: path strings -> the nested tree
    (a node whose segments are all digits is a list). The leaves are the
    flat dict's own, so unflattening is free inside a traced or vmapped
    function."""
    root: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(SEP)
        node = root
        for seg in parents:
            node = node.setdefault(seg, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)
