"""llama4-scout-17b-a16e — MoE decoder (16 experts, top-1), early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48 layers, d_model 5120, 40 q heads
(GQA kv=8), expert d_ff 8192, vocab 202048 (padded to 202752 = 99*2048),
MoE 16 experts top-1 every layer. Early-fusion multimodality is out of
scope of the assigned backbone (text path only). 40 heads are not
divisible by 16-way TP -> feature-dim tensor parallelism.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202752,
    unpadded_vocab=202048,
    moe=MoEConfig(num_experts=16, top_k=1, every=1, capacity_factor=1.25),
    tp_strategy="feature",
    microbatches=16,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="scout-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab_size=241,
        moe=MoEConfig(num_experts=4, top_k=1, every=1),
        tp_strategy="feature", dtype="float32", citation=CONFIG.citation)
