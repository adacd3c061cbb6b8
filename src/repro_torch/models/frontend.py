"""Modality-frontend stubs (port of ``repro.models.frontend``).

VLM (InternVL2): the vision encoder and projector are not reproduced;
``vision_patch_embeds`` emits patch embeddings with the interface the
language model consumes, (B, n_prefix_embeds, d_model).

Audio (MusicGen): the EnCodec codec is not reproduced;
``encodec_tokens`` emits K parallel codebook token streams (B, S, K) in
[0, vocab). The decoder over these tokens is implemented.

Both draw from a ``torch.Generator`` on its own device; ``jax.random``
draws cannot be matched, so a test that needs the reference's stub
output carries it across as an array.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import resolve_device


def vision_patch_embeds(generator: torch.Generator, batch: int,
                        cfg: ModelConfig, dtype=torch.float32,
                        device="cuda") -> torch.Tensor:
    """Stub ViT output: (B, cfg.n_prefix_embeds, d_model), N(0, 0.02²)."""
    x = torch.randn((batch, cfg.n_prefix_embeds, cfg.d_model),
                    generator=generator, device=generator.device) * 0.02
    return x.to(device=resolve_device(device), dtype=dtype)


def encodec_tokens(generator: torch.Generator, batch: int, seq: int,
                   cfg: ModelConfig, device="cuda") -> torch.Tensor:
    """Stub EnCodec tokens: (B, S, n_codebooks) int32, uniform over the
    vocabulary."""
    t = torch.randint(0, cfg.vocab_size, (batch, seq, cfg.n_codebooks),
                      generator=generator, device=generator.device,
                      dtype=torch.int32)
    return t.to(resolve_device(device))
