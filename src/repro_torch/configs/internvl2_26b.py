"""internvl2-26b — VLM: InternViT (stub) + InternLM2-20B language decoder.

[arXiv:2404.16821] 48 layers, d_model 6144, 48 q heads (GQA kv=8),
d_ff 16384, vocab 92553 (padded to 92672 = 724*128 for 16-way TP).
Vision frontend is a STUB: ``input_specs`` provides 256 patch embeddings
(one tile) of width d_model via the projector interface.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92672,
    unpadded_vocab=92553,
    n_prefix_embeds=256,
    microbatches=16,
    citation="arXiv:2404.16821 (InternVL2; InternLM2-20B backbone)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=499,
        n_prefix_embeds=16, dtype="float32", citation=CONFIG.citation)
