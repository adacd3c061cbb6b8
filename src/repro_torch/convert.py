"""Carrying parameters between ``repro``'s pytrees and the port.

The port keeps ``repro``'s layouts (HWIO conv weights, the same dict
keys, the transformer's list of stacked super-blocks), so a conversion
is a per-leaf copy through numpy: nothing is transposed or renamed, and
a round trip is exact. Trees are dicts and lists nested to any depth:
the CNN's flat dict, the transformer's list of blocks, or the D3QN
agent's ``{"bilstm": {"fwd": {"wx", "wh", "b"}, "bwd": ...}, "trunk":
{"w", "b"}, "v_head": ..., "a_head": ...}``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


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
    """S parameter dicts of array-likes (one a sweep lane, e.g. the
    reference's initial weights through ``np.asarray``) -> one dict of
    lane-stacked f32 tensors, each leaf (S, ...), on ``device``."""
    trees = list(trees)
    dev = resolve_device(device)
    return {k: torch.stack([_to_tensor(t[k], dev) for t in trees])
            for k in trees[0]}
