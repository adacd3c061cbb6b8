"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48 layers, d_model 1536, 24 heads MHA (kv=24),
d_ff 6144, vocab 2048 per codebook, 4 parallel codebooks (delay pattern
handled at the data layer; the model embeds the 4 streams additively and
predicts 4 heads — MusicGen's parallel-with-delay interleave).

The EnCodec codec itself is a STUB (carve-out): ``input_specs`` provides
the (B, S, 4) token streams.

24 heads are not divisible by the 16-way model axis -> feature-dim
(row-parallel) tensor parallelism instead of head sharding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    n_codebooks=4,
    tp_strategy="feature",
    microbatches=8,
    citation="arXiv:2306.05284 (MusicGen medium)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=6, d_ff=192, vocab_size=67, n_codebooks=4,
        tp_strategy="feature", dtype="float32", citation=CONFIG.citation)
