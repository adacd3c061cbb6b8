"""Architecture and input-shape configuration dataclasses.

Plain copies of ``repro.configs.base`` (no JAX): the same fields, the
same defaults and the same analytic parameter counts, so a config of
the port and its reference describe one model. ``compute_dtype`` is a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    # every `every` layers one MoE MLP (1 = all layers MoE)
    every: int = 1
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: period-P blocks, attn at index attn_pos within the block
    hybrid_period: int = 0
    hybrid_attn_pos: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # tensor-parallel layout of the reference's sharded runs ("heads" or
    # "feature"); on one card it only picks the long-prefill branch
    tp_strategy: str = "heads"
    sliding_window: int = 0          # 0 = full attention; >0 = SWA window
    # modality frontend stub: number of prefix embedding positions supplied
    # directly as dense vectors (vlm patches / audio frames)
    n_prefix_embeds: int = 0
    n_codebooks: int = 1             # audio: parallel codebooks
    dtype: str = "bfloat16"
    remat: bool = True
    microbatches: int = 1            # grad-accumulation splits per train step
    unroll_layers: bool = False
    seq_shard: bool = False
    unpadded_vocab: int = 0          # true vocab before TP padding (0 = exact)
    citation: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kind(self, idx: int) -> str:
        """'attn' or 'ssm' for the token-mixing sublayer of layer idx."""
        if self.family == "ssm":
            return "ssm"
        if self.hybrid_period > 0:
            return ("attn" if idx % self.hybrid_period == self.hybrid_attn_pos
                    else "ssm")
        return "attn"

    def mlp_kind(self, idx: int) -> str:
        """'moe' | 'dense' | 'none' for the channel-mixing sublayer."""
        if self.d_ff == 0:
            return "none"          # pure SSM blocks (mamba2): no MLP sublayer
        if self.is_moe and idx % self.moe.every == self.moe.every - 1:
            return "moe"
        return "dense"

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        total = V * D                                     # embed
        if not self.tie_embeddings:
            total += D * V                                # lm head
        total += D                                        # final norm
        if self.family == "audio" and self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * V * D       # extra codebook embeds
            total += (self.n_codebooks - 1) * D * V       # extra heads
        ssm = self.ssm or SSMConfig()
        di = ssm.d_inner(D)
        nh = ssm.n_heads(D)
        for i in range(self.n_layers):
            total += 2 * D                                # two norms
            if self.layer_kind(i) == "attn":
                total += D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D
            else:
                # in_proj -> [z, x, B, C, dt], conv, A, D, norm, out_proj
                conv_dim = di + 2 * ssm.n_groups * ssm.d_state
                total += D * (2 * di + 2 * ssm.n_groups * ssm.d_state + nh)
                total += conv_dim * ssm.conv_width + 2 * nh + di
                total += di * D
            if self.mlp_kind(i) == "moe":
                m = self.moe
                total += D * m.num_experts                # router
                total += m.num_experts * 3 * D * F
            else:
                total += 3 * D * F
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if not self.is_moe:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.mlp_kind(i) == "moe")
        unused = (n_moe_layers * (m.num_experts - m.top_k) * 3
                  * self.d_model * self.d_ff)
        return full - unused


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
