"""Serving step factories (port of ``repro.launch.steps``:
``make_serve_step`` and ``make_prefill_step``).

On one card the reference's mesh sharder is its no-op, so the port's
factories take no mesh. ``input_specs``, the optimizers and the train
steps come with the training slice (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens, pos) -> (logits, cache): one
    decode step on the KV caches (plain attention, no kernel) and the
    SSM caches (the Mamba-2 recurrence) of ``T.init_cache``."""

    def serve_step(params, cache, tokens, pos):
        return T.decode(params, tokens, cache, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "plain"):
    """prefill_step(params, batch) -> logits: the full-sequence forward.
    ``impl="kernel"`` runs each attention layer through the
    flash-attention kernel (the reference's ``impl="pallas"``)."""
    if impl not in attn.IMPLS:
        raise ValueError(f"impl must be one of {attn.IMPLS}, got {impl!r}")

    def prefill_step(params, batch):
        logits, _ = T.forward(params, batch, cfg, impl=impl)
        return logits

    return prefill_step
