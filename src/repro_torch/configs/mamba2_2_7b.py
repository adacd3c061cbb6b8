"""mamba2-2.7b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64 layers, d_model 2560, d_inner 5120 (expand 2),
80 SSD heads of head_dim 64, d_state 128, vocab 50280 (padded to
50304 = 393*128 for 16-way TP). No attention; d_ff=0 (the Mamba block is
the whole layer — our layer wrapper still applies a dense MLP when
d_ff>0, so d_ff=0 disables it via mlp identity).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50304,
    unpadded_vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    microbatches=8,
    citation="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm", n_layers=2, d_model=128,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=257,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=16),
        dtype="float32", citation=CONFIG.citation)
