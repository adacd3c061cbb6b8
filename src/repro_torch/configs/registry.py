"""Architecture registry: ``--arch <id>`` resolution.

Port of ``repro.configs.registry``: every arch of the reference (the
dense, vlm, audio, MoE, SSM and hybrid decoders and the paper CNN
``hfl-cnn``) resolves to its ``CONFIG`` / ``smoke_config()``, and
``get_hfl_spec`` to the payload the HFL engines train.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib

from typing import Tuple

from repro_torch.configs.base import InputShape, ModelConfig

_MODULES = {
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "hfl-cnn": "repro_torch.configs.hfl_cnn",
}

ARCH_IDS = tuple(a for a in _MODULES if a != "hfl-cnn")

# HFL payloads of the reference's tier-1 tests: the paper CNN plus one
# arch per decoder family (dense / ssm / moe). Every registry id
# resolves through get_hfl_spec.
HFL_SMOKE_ARCHS: Tuple[str, ...] = (
    "hfl-cnn", "mistral-nemo-12b", "mamba2-2.7b", "qwen3-moe-235b-a22b")


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
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
    the HFL engines train over (cached: one spec object per arch).

    ``hfl-cnn`` is the paper's CNN (the default). Every other registry
    id maps to its ``smoke_config()`` with remat off, in f32, trained as
    a sequence classifier over ``make_seq_dataset``, as in the
    reference."""
    from repro_torch.models import spec as spec_lib
    if arch == "hfl-cnn":
        return spec_lib.cnn_spec()
    cfg = dataclasses.replace(get_smoke_config(arch), remat=False,
                              dtype="float32")
    return spec_lib.seq_spec(arch, cfg)
