"""Per-device local training (paper eq. (1)) — full-batch GD, batched
over the cohort with ``torch.func.vmap`` of ``torch.func.grad``.

Port of ``repro.core.local_train``. Device datasets are padded to a
common ``Dmax`` with a validity mask so the whole scheduled cohort trains
as one batched computation.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch import trace
from repro_torch.utils import Params


def masked_loss(apply_fn: Callable, params: Params, X, y, mask):
    """Mean CE over valid samples only. X: (Dmax, ...), mask: (Dmax,)."""
    logits = apply_fn(params, X)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[:, None])[:, 0]
    per = (lse - gold) * mask
    return torch.sum(per) / torch.clamp_min(torch.sum(mask), 1.0)


def _sgd(grad_fn, params: Params, X, y, mask, L: int, lr: float) -> Params:
    for _ in range(L):
        g = grad_fn(params, X, y, mask)
        params = {k: params[k] - lr * g[k] for k in params}
    return params


def local_sgd(apply_fn: Callable, params: Params, X, y, mask, L: int,
              lr: float) -> Params:
    """L full-batch GD steps (eq. (1)) on one device."""
    return _sgd(grad(functools.partial(masked_loss, apply_fn)),
                params, X, y, mask, L, lr)


def cohort_local_sgd(apply_fn: Callable, params_per_dev: Params, X, y,
                     mask, L: int, lr: float) -> Params:
    """``local_sgd`` on every device of the cohort at once.

    params_per_dev: leaves with a leading device axis H; X: (H, Dmax, ...),
    y and mask (H, Dmax). Each step is one vmapped gradient over H.
    Counts the sample-steps it computes, padding included
    (``train.sample_steps``, from the shapes), and the real ones
    (``train.real_sample_steps``, the mask summed on its device).
    """
    tracer = trace.current()
    if tracer is not None:
        tracer.count("train.sample_steps", mask.numel() * L)
        tracer.count("train.real_sample_steps", mask.sum() * L)
    return _sgd(vmap(grad(functools.partial(masked_loss, apply_fn))),
                params_per_dev, X, y, mask, L, lr)
