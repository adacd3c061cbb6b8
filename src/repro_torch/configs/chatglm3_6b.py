"""chatglm3-6b — dense decoder with 2-group GQA (MQA-ish) and 2d RoPE.

[arXiv:2406.12793 (GLM-4 report, ChatGLM family)] 28 layers, d_model
4096, 32 q heads, GQA kv=2, d_ff 13696, vocab 65024. ChatGLM applies
rotary embeddings to half the head dims (2d RoPE); we implement standard
full-dim RoPE and note the deviation (frequency layout does not change
any system-level property measured here).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    microbatches=8,
    citation="arXiv:2406.12793 (ChatGLM)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=288, vocab_size=251,
        dtype="float32", citation=CONFIG.citation)
