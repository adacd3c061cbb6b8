"""mistral-nemo-12b — dense decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40 layers, d_model 5120, 32 q heads
with explicit head_dim 128 (q proj 5120->4096), GQA kv=8, d_ff 14336,
vocab 131072. rope_theta 1e6 for long context.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    microbatches=16,
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemo-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=48, d_ff=256, vocab_size=277,
        rope_theta=1e6, dtype="float32", citation=CONFIG.citation)
