"""Sequence-classification heads over the decoder backbone.

Port of ``repro.models.seq_classifier``. The HFL engines train
``apply_fn(params, X) -> logits`` classifiers; this module wraps
``models/transformer`` (one ``ModelConfig`` covering the dense, MoE,
SSM and hybrid registry families) as such a classifier: embed int
tokens, run the super-block backbone with the plain attention, RMS-norm,
mean-pool over the sequence, project to ``n_classes``. The MoE router
aux loss is dropped (the engines' loss is plain softmax cross-entropy),
as in the reference.

``SeqClassifierApply`` is a frozen dataclass, so two specs of one
``ModelConfig`` hold equal callables, as the reference's static-jit
argument requires.

The IKC auxiliary path gets a sequence mini model ξ (embed + mean-pool
+ linear) trained on a random ``SEQ_MINI_CROP``-token crop; the crop
offsets are drawn from a ``torch.Generator`` (:func:`seq_crop_offsets`)
or passed in (e.g. the reference's ``jax.random`` draws).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as transformer_lib
from repro_torch.models.layers import embed_init, he_normal, rmsnorm

SEQ_MINI_DIM = 8        # mini-model embedding width
SEQ_MINI_CROP = 8       # tokens kept by the IKC preprocessing crop


def seq_cls_init(generator: torch.Generator, cfg: ModelConfig,
                 n_classes: int, device="cuda") -> Dict:
    """Backbone params + ``cls_head`` (the lm_head is dropped)."""
    params = transformer_lib.init(generator, cfg, device=device)
    params.pop("lm_head", None)
    params["cls_head"] = he_normal(generator, (cfg.d_model, n_classes),
                                   fan_in=cfg.d_model, device=device)
    return params


@dataclasses.dataclass(frozen=True)
class SeqClassifierApply:
    """``(params, tokens (B, S)) -> logits (B, n_classes)``.

    Tokens are cast to integers on entry, so float-padded cohort tensors
    index the embedding safely."""
    cfg: ModelConfig

    def __call__(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = params["embed"][tokens.long()].to(cfg.compute_dtype)
        x, _aux = transformer_lib.backbone(params, x, cfg)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x.mean(dim=1).float() @ params["cls_head"]


def seq_mini_init(generator: torch.Generator, vocab: int, n_classes: int,
                  d_model: int = SEQ_MINI_DIM, device="cuda") -> Dict:
    """Mini model ξ for IKC clustering: embed + mean-pool + linear."""
    return {
        "embed": embed_init(generator, vocab, d_model, device),
        "fc": he_normal(generator, (d_model, n_classes), fan_in=d_model,
                        device=device),
    }


def seq_mini_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S_crop) -> logits (B, n_classes)."""
    return params["embed"][tokens.long()].mean(dim=1) @ params["fc"]


def seq_crop_offsets(generator: torch.Generator, n: int, seq_len: int
                     ) -> torch.Tensor:
    """(n,) random start of the contiguous crop, one per device, uniform
    over [0, seq_len - crop]."""
    crop = min(seq_len, SEQ_MINI_CROP)
    return torch.randint(0, seq_len - crop + 1, (n,), generator=generator)


def seq_mini_preprocess(X: torch.Tensor, offsets) -> torch.Tensor:
    """IKC preprocessing: device n keeps tokens [offsets[n], offsets[n] +
    crop) of each of its samples. X (N, Dmax, S) -> (N, Dmax, min(S,
    crop))."""
    N, Dmax, S = X.shape
    crop = min(S, SEQ_MINI_CROP)
    off = torch.as_tensor(offsets, dtype=torch.int64).to(X.device)
    idx = off[:, None, None] + torch.arange(crop, device=X.device)
    return torch.gather(X, 2, idx.expand(N, Dmax, crop))
