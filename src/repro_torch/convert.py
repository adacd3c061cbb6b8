"""Carrying parameters between ``repro``'s pytrees and the port.

The port keeps ``repro``'s layouts (HWIO conv weights, the same dict
keys, the transformer's list of stacked super-blocks), so a conversion
is a per-leaf copy through numpy: nothing is transposed or renamed, and
a round trip is exact. Trees are dicts and lists nested to any depth.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device="cuda"):
    """A tree of array-likes (e.g. ``repro`` params passed through
    ``np.asarray``) -> the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return _map(lambda v: torch.from_numpy(np.array(v, dtype=np.float32))
                .to(dev), tree)


def params_to_numpy(tree):
    """A tree of the port's tensors -> the same tree of numpy arrays."""
    return _map(lambda v: v.detach().cpu().numpy(), tree)
