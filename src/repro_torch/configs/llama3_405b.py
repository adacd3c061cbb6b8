"""llama3-405b — dense decoder, the largest assigned config.

[arXiv:2407.21783] 126 layers, d_model 16384, 128 q heads (GQA kv=8,
head_dim 128), d_ff 53248, vocab 128256 (=1002*128), rope_theta 5e5.
long_500k decode runs with a sliding-window KV-cache variant (window
8192) — full-attention 500k cache is deliberately out of scope (DESIGN.md
§Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    microbatches=8,
    seq_shard=True,
    citation="arXiv:2407.21783 (Llama 3 405B)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", family="dense", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=509,
        rope_theta=5e5, dtype="float32", citation=CONFIG.citation)
