"""mistral-large-123b — dense decoder.

[hf:mistralai/Mistral-Large-Instruct-2407] 88 layers, d_model 12288,
96 q heads (GQA kv=8, head_dim 128), d_ff 28672, vocab 32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    microbatches=16,
    seq_shard=True,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-smoke", family="dense", n_layers=2, d_model=192,
        n_heads=6, n_kv_heads=2, head_dim=32, d_ff=384, vocab_size=263,
        dtype="float32", citation=CONFIG.citation)
