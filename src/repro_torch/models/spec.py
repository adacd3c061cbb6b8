"""ModelSpec — the payload contract the HFL engine trains over.

Port of ``repro.models.spec`` for the paper CNN. The scheduling and
assignment machinery only reads ``model_bits`` from the payload, so the
framework binds to a spec instead of a concrete model:

* ``init_fn(generator, fed, device) -> params`` — init shaped by the
  federated task (input geometry, ``fed.n_classes``).
* ``apply_fn(params, X) -> logits``.
* ``eval_fn(params, X_test, y_test) -> float`` — batched test accuracy.
* ``mini_init_fn`` / ``mini_apply_fn`` / ``mini_preprocess_fn`` — the
  IKC auxiliary model ξ and its input crop; ``mini_preprocess_fn(X,
  generator)`` maps the padded (N, Dmax, ...) tensor to the clustering
  inputs, drawing one crop offset per device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core.hfl import evaluate_in_batches
from repro_torch.models import cnn


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    arch: str                       # registry id (``hfl-cnn``)
    family: str                     # cnn
    init_fn: Callable               # (generator, fed, device) -> params
    apply_fn: Callable              # (params, X) -> logits
    eval_fn: Callable               # (params, X_test, y_test) -> accuracy
    mini_init_fn: Callable          # (generator, fed, device) -> aux params
    mini_apply_fn: Callable         # (params, crop) -> logits
    mini_preprocess_fn: Callable    # (X (N, Dmax, ...), generator) -> crops


def _cnn_init(generator: torch.Generator, fed, device):
    return cnn.cnn_init(generator, fed.X_test.shape[1:3],
                        fed.X_test.shape[3], fed.n_classes, device=device)


def _cnn_mini_init(generator: torch.Generator, fed, device):
    return cnn.mini_init(generator, fed.n_classes, device=device)


def _cnn_mini_preprocess(X: torch.Tensor, generator: torch.Generator):
    """Channel 0, random 10x10 crop per device (IKC preprocessing)."""
    offsets = cnn.crop_offsets(generator, X.shape[0], X.shape[2:4])
    return cnn.mini_preprocess(X, offsets)


def cnn_spec() -> ModelSpec:
    return ModelSpec(
        arch="hfl-cnn", family="cnn",
        init_fn=_cnn_init, apply_fn=cnn.cnn_apply,
        eval_fn=functools.partial(evaluate_in_batches, cnn.cnn_apply),
        mini_init_fn=_cnn_mini_init, mini_apply_fn=cnn.mini_apply,
        mini_preprocess_fn=_cnn_mini_preprocess)
