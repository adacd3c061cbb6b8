"""ModelSpec — the payload contract the HFL engine trains over.

Port of ``repro.models.spec``: the paper CNN (``cnn_spec``) and the
registry's decoders as sequence classifiers (``seq_spec``). The
scheduling and assignment machinery only reads ``model_bits`` from the
payload, so the engines bind to a spec instead of a concrete model:

* ``init_fn(generator, fed, device) -> params`` — init shaped by the
  federated task (input geometry, ``fed.n_classes``).
* ``apply_fn(params, X) -> logits``.
* ``eval_fn(params, X_test, y_test) -> float`` — batched test accuracy.
* ``mini_init_fn`` / ``mini_apply_fn`` / ``mini_preprocess_fn`` — the
  IKC auxiliary model ξ and its input crop; ``mini_preprocess_fn(X,
  generator)`` maps the padded (N, Dmax, ...) tensor to the clustering
  inputs, drawing one crop offset per device.

The engines train flat ``{name: tensor}`` dicts. A sequence
classifier's params are nested (a list of stacked super-blocks), so
``seq_spec``'s ``init_fn`` returns them flattened
(``convert.flatten_params``: path keys in JAX's leaf order) and its
``apply_fn`` rebuilds the nested view from the same tensors before it
runs the model. The CNN's dict is flat already.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import flatten_params, unflatten_params
from repro_torch.core.hfl import evaluate_in_batches
from repro_torch.models import cnn
from repro_torch.models import seq_classifier as seqc


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    arch: str                       # registry id (``hfl-cnn``, ...)
    family: str                     # cnn | dense | moe | ssm | hybrid
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


# ----------------------------------------------- registry decoder archs

@dataclasses.dataclass(frozen=True)
class FlatApply:
    """``apply(unflatten_params(params), X)``: a nested model over the
    engines' flat params (equal for equal ``apply``)."""
    apply: Callable

    def __call__(self, params, X):
        return self.apply(unflatten_params(params), X)


@dataclasses.dataclass(frozen=True)
class _SeqInit:
    cfg: ModelConfig

    def __call__(self, generator: torch.Generator, fed, device):
        return flatten_params(seqc.seq_cls_init(generator, self.cfg,
                                                fed.n_classes, device))


@dataclasses.dataclass(frozen=True)
class _SeqMiniInit:
    vocab: int

    def __call__(self, generator: torch.Generator, fed, device):
        return seqc.seq_mini_init(generator, self.vocab, fed.n_classes,
                                  device=device)


def _seq_mini_preprocess(X: torch.Tensor, generator: torch.Generator):
    """A random contiguous crop per device (IKC preprocessing)."""
    offsets = seqc.seq_crop_offsets(generator, X.shape[0], X.shape[2])
    return seqc.seq_mini_preprocess(X, offsets)


def seq_spec(arch: str, cfg: ModelConfig) -> ModelSpec:
    """Sequence-classification spec over a registry ``ModelConfig``."""
    apply_fn = FlatApply(seqc.SeqClassifierApply(cfg))
    return ModelSpec(
        arch=arch, family=cfg.family,
        init_fn=_SeqInit(cfg), apply_fn=apply_fn,
        eval_fn=functools.partial(evaluate_in_batches, apply_fn),
        mini_init_fn=_SeqMiniInit(cfg.vocab_size),
        mini_apply_fn=seqc.seq_mini_apply,
        mini_preprocess_fn=_seq_mini_preprocess)
