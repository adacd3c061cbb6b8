"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE.

[arXiv:2403.19887 / 2408.12570] 72 layers, d_model 8192, 64 q heads (GQA
kv=8), d_ff 24576, vocab 65536, MoE 16 experts top-2 every other layer;
attention appears once per 8-layer block (Jamba's 1:7 attn:mamba ratio).
Mamba-2-style SSM sublayers (d_state 128, head_dim 64, expand 2).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, every=2, capacity_factor=1.25),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    hybrid_period=8,
    hybrid_attn_pos=4,
    sliding_window=0,
    microbatches=16,
    citation="arXiv:2403.19887 (Jamba-1.5)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=503,
        moe=MoEConfig(num_experts=4, top_k=2, every=2),
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=16),
        hybrid_period=2, hybrid_attn_pos=0, dtype="float32",
        citation=CONFIG.citation)
