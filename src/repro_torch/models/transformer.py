"""Decoder-only model over one ``ModelConfig`` (port of
``repro.models.transformer``: dense, MoE, SSM, hybrid, vlm and audio
decoders from one code path).

* Parameters keep the reference's tree: ``blocks`` is a list of
  super-block dicts whose leaves carry a leading ``n_layers / sb`` axis,
  so weights cross between the packages unchanged (``convert``). A
  Python loop over that axis takes the place of ``lax.scan``. With
  ``cfg.remat`` and grad mode on, each super-block runs under
  ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
  backward recomputes its activations instead of keeping them, which
  changes memory and no value (MoE routing and the SSD intermediates
  are deterministic functions of the block's input, so the recompute
  rebuilds them unchanged).
* Mixed precision: parameters live in f32 and are cast to
  ``cfg.compute_dtype`` at each use; RMSNorm and RoPE run in f32.
* ``vlm`` prepends ``n_prefix_embeds`` dense embeddings (stripped again
  before the head); ``audio`` embeds K codebooks additively (codebook k
  uses embedding rows [kV, (k+1)V)) and predicts K heads.
* Layers come in super-blocks of ``lcm(hybrid_period, moe.every)``
  templates: a token-mixing sublayer (attention, or a Mamba-2 block for
  ``layer_kind == "ssm"``) and a channel-mixing one (SwiGLU, an MoE for
  ``mlp_kind == "moe"``, or none). MoE layers add their router aux loss
  to the forward's ``aux``, and ``loss_fn`` adds
  ``router_aux_weight · aux``. Decode caches hold a KV cache for each
  attention position of the super-block and an SSM cache (SSD state and
  rolling conv state) for each SSM position.

* ``sharder`` (``NOOP`` by default) takes the reference's activation
  kinds at the reference's points (``act_resid`` after the embedding
  and each layer, ``logits``, ``act_resid_decode``); under a mesh the
  params and batch are DTensors and a ``MeshSharder`` places them
  (``repro_torch.launch.steps``).

API:
  init(generator, cfg, device)                      -> params
  forward(params, batch, cfg, sharder=, impl=)      -> (logits, aux_loss)
  loss_fn(params, batch, cfg, sharder=, impl=)      -> (scalar, metrics)
  init_cache(cfg, batch, max_len, device)           -> decode cache
  decode(params, tokens, cache, pos, cfg, sharder=) -> (logits, cache)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, rmsnorm, rmsnorm_init,
                                       rows_local)
from repro_torch.parallel.sharder import NOOP, Sharder
from repro_torch.utils import resolve_device


def super_block(cfg: ModelConfig) -> int:
    """Layers per super-block (distinct layer templates)."""
    p = cfg.hybrid_period if cfg.hybrid_period > 0 else 1
    e = cfg.moe.every if cfg.is_moe else 1
    sb = math.lcm(p, e)
    if cfg.n_layers % sb:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the super-block {sb}")
    return sb


def _at(tree, b: int):
    """Layer b of a stacked parameter (or cache) tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _at(v, b) for k, v in tree.items()}
    return tree[b]


# ------------------------------------------------------------------ init

def _layer_init(generator, cfg: ModelConfig, idx: int, nb: int, device,
                dtype) -> Dict[str, Any]:
    mix = attn.attn_init if cfg.layer_kind(idx) == "attn" else m2.mamba2_init
    p: Dict[str, Any] = {
        "norm1": rmsnorm_init(cfg.d_model, device, (nb,)),
        "mix": mix(generator, cfg, device, dtype, (nb,))}
    kind = cfg.mlp_kind(idx)
    if kind != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, device, (nb,))
        p["mlp"] = (moe_lib.moe_init(generator, cfg, device, dtype, (nb,))
                    if kind == "moe" else
                    mlp_init(generator, cfg.d_model, cfg.d_ff, device, dtype,
                             (nb,)))
    return p


def init(generator: torch.Generator, cfg: ModelConfig, device="cuda",
         dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters of the reference's tree. Values are drawn where
    ``generator`` lives (a CUDA generator draws on the card) and then
    moved to ``device``; ``jax.random`` draws cannot be matched, so
    parity tests carry the reference's weights across instead. On
    ``device="meta"`` nothing is drawn: the tree holds the shapes and
    dtypes alone (``launch.steps.params_struct``)."""
    device = resolve_device(device)
    sb = super_block(cfg)
    nb = cfg.n_layers // sb
    rows = cfg.vocab_size * max(1, cfg.n_codebooks)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, rows, cfg.d_model, device, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, rows, device,
                                       dtype)
    params["blocks"] = [_layer_init(generator, cfg, j, nb, device, dtype)
                        for j in range(sb)]
    return params


# ----------------------------------------------------------------- embed

def _embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """tokens (B, S), or (B, S, K) for audio -> (B, S, D) in the compute
    dtype."""
    emb = params["embed"]

    def lookup(idx, table):
        if isinstance(table, DTensor):
            return rows_local(F.embedding, idx, table, whole=True)
        return F.embedding(idx, table)

    if cfg.family == "audio" and cfg.n_codebooks > 1:
        offs = torch.arange(cfg.n_codebooks, device=tokens.device) \
            * cfg.vocab_size
        x = lookup(tokens.long() + offs, emb).sum(dim=2)
    else:
        x = lookup(tokens.long(), emb)
    return x.to(cfg.compute_dtype)


def _lm_head(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.family == "audio" and cfg.n_codebooks > 1:
        B, S, _ = logits.shape
        return logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_size)
    return logits


# --------------------------------------------------------------- forward

def _mlp_sublayer(p, x: torch.Tensor, cfg: ModelConfig, idx: int,
                  sharder: Sharder = NOOP
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The channel-mixing sublayer with its residual -> (x, the MoE aux
    loss or None)."""
    kind = cfg.mlp_kind(idx)
    if kind == "none":
        return x, None
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if kind == "moe":
        h, aux = moe_lib.moe_apply(p["mlp"], h, cfg, sharder=sharder)
        return x + h, aux
    return x + mlp_apply({k: w.to(h.dtype) for k, w in p["mlp"].items()},
                         h), None


def _apply_layer(p, x: torch.Tensor, cfg: ModelConfig, idx: int, impl: str,
                 sharder: Sharder = NOOP
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.layer_kind(idx) == "attn":
        h = attn.attn_forward(p["mix"], h, cfg, sharder=sharder, impl=impl)
    else:
        h = m2.mamba2_forward(p["mix"], h, cfg, sharder=sharder)
    x, aux = _mlp_sublayer(p, x + h, cfg, idx, sharder)
    return sharder.act(x, "act_resid"), aux


def backbone(params, x: torch.Tensor, cfg: ModelConfig, *,
             sharder: Sharder = NOOP, impl: str = "plain"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) embedded input -> (hidden, the MoE layers' summed aux
    loss; zero without MoE layers). Super-blocks are rematerialised
    under ``cfg.remat`` when grad mode is on. ``torch.func``'s ``grad``
    refuses the saved-tensor hooks of ``checkpoint``, so what it trains
    runs with remat off (``registry.get_hfl_spec``'s payloads)."""
    sb = super_block(cfg)

    def block(b, x, aux):
        for j in range(sb):
            x, a = _apply_layer(_at(params["blocks"][j], b), x, cfg, j, impl,
                                sharder)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(cfg.n_layers // sb):
        if remat:
            x, aux = checkpoint(block, b, x, aux, use_reentrant=False)
        else:
            x, aux = block(b, x, aux)
    return x, aux


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            sharder: Sharder = NOOP, impl: str = "plain"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward. batch: tokens (+ prefix_embeds for vlm).
    Returns (logits over the token positions, aux loss)."""
    x = _embed_tokens(params, batch["tokens"], cfg)
    n_prefix = 0
    if cfg.n_prefix_embeds > 0 and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(x.dtype)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    x = sharder.act(x, "act_resid")
    x, aux = backbone(params, x, cfg, sharder=sharder, impl=impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if n_prefix > 0:
        x = x[:, n_prefix:]
    return sharder.act(_lm_head(params, x, cfg), "logits"), aux


def _token_nll(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's next-token NLL: logsumexp minus the gold logit."""
    lse = torch.logsumexp(lf, dim=-1)
    return lse - torch.gather(lf, -1, labels[..., None])[..., 0]


def loss_fn(params, batch, cfg: ModelConfig, *, sharder: Sharder = NOOP,
            impl: str = "plain"):
    """Mean next-token NLL over ``batch["labels"]``, plus
    ``router_aux_weight · aux`` for MoE configs."""
    logits, aux = forward(params, batch, cfg, sharder=sharder, impl=impl)
    lf = logits.float()
    labels = batch["labels"].long()
    if isinstance(lf, DTensor):
        # per rank, on its rows with the vocabulary whole
        nll = rows_local(lambda y, lf: _token_nll(lf, y), labels, lf,
                          whole=False)
    else:
        nll = _token_nll(lf, labels)
    nll = nll.mean()
    total = nll
    if cfg.is_moe:
        total = total + cfg.moe.router_aux_weight * aux
    return total, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------- decode

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """Per-super-block-position caches stacked over the blocks (the
    reference's layout): a KV cache at each attention position, an SSM
    cache at each SSM position."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    sb = super_block(cfg)
    nb = cfg.n_layers // sb
    return [attn.init_kv_cache(cfg, batch, max_len, dtype, device, (nb,))
            if cfg.layer_kind(j) == "attn" else
            m2.init_ssm_cache(cfg, batch, dtype, device, (nb,))
            for j in range(sb)]


def decode(params, tokens: torch.Tensor, cache, pos: int, cfg: ModelConfig,
           *, sharder: Sharder = NOOP):
    """One decode step. tokens (B, 1) or (B, 1, K); pos: the position of
    these tokens (int). The cache is updated in place and returned. An
    MoE layer fills its capacity from the B tokens of this step alone."""
    x = sharder.act(_embed_tokens(params, tokens, cfg), "act_resid_decode")
    sb = super_block(cfg)
    for b in range(cfg.n_layers // sb):
        for j in range(sb):
            p = _at(params["blocks"][j], b)
            c = _at(cache[j], b)
            hn = rmsnorm(p["norm1"], x, cfg.norm_eps)
            if cfg.layer_kind(j) == "attn":
                hn, _ = attn.attn_decode(p["mix"], hn, c, pos, cfg,
                                         sharder=sharder)
            else:
                hn, new = m2.mamba2_decode(p["mix"], hn, c, cfg,
                                           sharder=sharder)
                for k, v in new.items():
                    c[k].copy_(v)
            x, _ = _mlp_sublayer(p, x + hn, cfg, j, sharder)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, x, cfg), cache
