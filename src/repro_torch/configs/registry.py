"""Architecture registry: ``--arch <id>`` resolution.

Port of ``repro.configs.registry``. The attention-only decoders (dense,
vlm, audio) and the paper CNN (``hfl-cnn``) resolve to their ``CONFIG``
/ ``smoke_config()``; the MoE and SSM/hybrid archs raise
``NotImplementedError`` until their layers are ported (ROADMAP Queue 1
item 8), and any other name is unknown.
``get_hfl_spec`` resolves the paper CNN (``hfl-cnn``) only.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib

from repro_torch.configs.base import InputShape, ModelConfig

_MODULES = {
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "hfl-cnn": "repro_torch.configs.hfl_cnn",
}
_UNPORTED = ("jamba-1.5-large-398b", "mamba2-2.7b", "llama4-scout-17b-a16e",
             "qwen3-moe-235b-a22b")

ARCH_IDS = (
    "jamba-1.5-large-398b", "internvl2-26b", "mamba2-2.7b", "chatglm3-6b",
    "mistral-nemo-12b", "musicgen-medium", "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b", "llama3-405b", "mistral-large-123b")


def _module(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} (MoE or SSM layers) is not ported to repro_torch "
            "yet; see ROADMAP Queue 1 item 8")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-conditioned config variant: long_500k decode runs any config
    with attention layers on a sliding-window KV cache (window 8192), as
    the reference does."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return dataclasses.replace(cfg, sliding_window=8192)
    return cfg


def decode_supported(cfg: ModelConfig) -> bool:
    """All registered archs are decoders."""
    return True


@functools.lru_cache(maxsize=None)
def get_hfl_spec(arch: str):
    """Resolve ``arch`` to the :class:`repro_torch.models.spec.ModelSpec`
    the HFL engine trains over (cached: one spec object per arch)."""
    from repro_torch.models import spec as spec_lib
    if arch == "hfl-cnn":
        return spec_lib.cnn_spec()
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch as an HFL payload "
            "yet; the sequence classifier is queued in ROADMAP Queue 1 "
            "item 8")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(ARCH_IDS + ('hfl-cnn',))}")
