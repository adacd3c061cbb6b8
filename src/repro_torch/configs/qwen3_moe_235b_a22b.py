"""qwen3-moe-235b-a22b — fine-grained MoE (128 experts, top-8).

[hf:Qwen/Qwen3-30B-A3B family scaled per assignment] 94 layers, d_model
4096, 64 q heads (GQA kv=4, head_dim 128), expert d_ff 1536, vocab
151936 (=1187*128), MoE 128 experts top-8 every layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, every=1, capacity_factor=1.25),
    microbatches=16,
    citation="hf:Qwen/Qwen3-235B-A22B",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=269,
        moe=MoEConfig(num_experts=4, top_k=2, every=1),
        dtype="float32", citation=CONFIG.citation)
