"""Architecture registry: ``FrameworkConfig.arch`` resolution.

Port of ``repro.configs.registry.get_hfl_spec``. Only the paper CNN
(``hfl-cnn``) is ported so far; the other ids of the reference registry
resolve to ``NotImplementedError`` (their port, the model zoo, is queued
in ROADMAP.md), and any other name is unknown.
"""
from __future__ import annotations

import functools

ARCH_IDS = (
    "jamba-1.5-large-398b", "internvl2-26b", "mamba2-2.7b", "chatglm3-6b",
    "mistral-nemo-12b", "musicgen-medium", "llama4-scout-17b-a16e",
    "qwen3-moe-235b-a22b", "llama3-405b", "mistral-large-123b")


@functools.lru_cache(maxsize=None)
def get_hfl_spec(arch: str):
    """Resolve ``arch`` to the :class:`repro_torch.models.spec.ModelSpec`
    the HFL engine trains over (cached: one spec object per arch)."""
    from repro_torch.models import spec as spec_lib
    if arch == "hfl-cnn":
        return spec_lib.cnn_spec()
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet; the model zoo "
            "is queued in ROADMAP.md")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(ARCH_IDS + ('hfl-cnn',))}")
