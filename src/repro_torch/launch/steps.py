"""Step factories and shape structs (port of ``repro.launch.steps``).

On one card the reference's mesh sharder is its no-op, so the port's
factories take no mesh and its structs carry no sharding: a struct is a
tree of ``device="meta"`` tensors (shape and dtype, no storage) in the
reference's tree, where the reference gives ``jax.ShapeDtypeStruct``s.

Train-step semantics, as the reference's:
  * the global batch is split along its leading axis into
    ``mb = max(1, cfg.microbatches)`` microbatches (microbatch i is rows
    ``[i·B/mb, (i+1)·B/mb)``), the paper's L local iterations fused into
    one step;
  * the gradient of ``T.loss_fn`` is taken at the same params for every
    microbatch and summed in f32 (:func:`accumulate_grads`); each
    microbatch's graph is dropped before the next one is built;
  * ``make_train_step`` hands the mean gradient to the optimizer (adam,
    adafactor above ``BIG_MODEL_PARAMS``), ``make_hfl_train_step`` takes
    one SGD step per pod and then the cloud aggregation of eq. (3).

Training runs the plain attention: the flash-attention kernel has no
backward (nor has the reference's, which has no ``custom_vjp``), so
``impl="kernel"`` raises here rather than train through a kernel whose
output would carry no gradient.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.convert import flatten_params, unflatten_params
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor, adam
from repro_torch.utils import tree_leaves, tree_map

BIG_MODEL_PARAMS = 20e9      # adafactor above this


# ------------------------------------------------------------ structs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of ``shape``: tokens
    and labels (train/prefill, the text positions after the vlm prefix),
    ``prefix_embeds`` in the compute dtype, or one decode token and its
    position."""
    B, S = shape.global_batch, shape.seq_len
    books = ((cfg.n_codebooks,) if cfg.family == "audio"
             and cfg.n_codebooks > 1 else ())
    if shape.kind in ("train", "prefill"):
        n_pre = cfg.n_prefix_embeds
        batch = {"tokens": _meta((B, S - n_pre, *books), torch.int32),
                 "labels": _meta((B, S - n_pre, *books), torch.int32)}
        if n_pre > 0:
            batch["prefix_embeds"] = _meta((B, n_pre, cfg.d_model),
                                           cfg.compute_dtype)
        return batch
    return {"tokens": _meta((B, 1, *books), torch.int32),
            "pos": _meta((), torch.int32)}


def cache_specs_struct(cfg: ModelConfig, shape: InputShape):
    """The decode caches of ``shape`` as meta tensors."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def params_struct(cfg: ModelConfig):
    """The f32 parameter tree as meta tensors: ``T.init`` on the meta
    device, which draws nothing."""
    return T.init(None, cfg, device="meta")


def opt_state_struct(cfg: ModelConfig, opt):
    """``opt.init`` of :func:`params_struct`: the moments as meta tensors
    (the step counter is the optimizers' host int)."""
    return opt.init(params_struct(cfg))


# ------------------------------------------------------------- optimizers

def make_optimizer(cfg: ModelConfig, lr: float = 1e-4):
    if cfg.param_count() > BIG_MODEL_PARAMS:
        return adafactor(lr)
    return adam(lr)


# -------------------------------------------------------------- steps

def _check_train_impl(impl: str) -> None:
    """Training runs the plain attention; ``"kernel"`` names the one
    attention it cannot run."""
    if impl == "kernel":
        raise NotImplementedError(
            "training through the flash-attention kernel needs its "
            "backward, which neither the kernel nor the reference's "
            "flash_attention_pallas (no custom_vjp) has; train with "
            "impl='plain'")
    if impl not in attn.IMPLS:
        raise ValueError(f"impl must be one of {attn.IMPLS}, got {impl!r}")


def accumulate_grads(cfg: ModelConfig, params,
                     batch: Dict[str, torch.Tensor]):
    """(gradient, loss) of ``T.loss_fn`` (plain attention) at ``params``,
    each summed over the ``mb = max(1, cfg.microbatches)`` microbatches
    of ``batch`` (divide by mb for the means): f32 gradients in the
    params' tree. Every leaf must get a gradient (``torch.autograd.grad``
    raises on an unused one). Runs with grad mode on whatever the
    caller's mode."""
    mb = max(1, cfg.microbatches)
    B = tree_leaves(batch)[0].shape[0]
    if B % mb:
        raise ValueError(f"batch {B} is not a multiple of the "
                         f"{mb} microbatches")
    n = B // mb
    live = flatten_params(tree_map(
        lambda p: p.detach().requires_grad_(), params))
    g_sum = loss_sum = None
    with torch.enable_grad():
        for i in range(mb):
            micro = tree_map(lambda x: x[i * n:(i + 1) * n], batch)
            loss, _ = T.loss_fn(unflatten_params(live), micro, cfg)
            grads = torch.autograd.grad(loss, list(live.values()))
            loss = loss.detach()
            if g_sum is None:
                # contiguous: a gradient autograd hands over as a
                # broadcast view cannot be accumulated into in place
                g_sum = [g.float().contiguous() for g in grads]
                loss_sum = loss
            else:
                for acc, g in zip(g_sum, grads):
                    acc.add_(g)
                loss_sum = loss_sum + loss
            del grads, loss
    return unflatten_params(dict(zip(live, g_sum))), loss_sum


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-4,
                    impl: str = "plain"):
    """Returns ``(train_step, opt)``; ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss": mean microbatch loss})`` with
    the optimizer's update under ``torch.no_grad()``."""
    _check_train_impl(impl)
    opt = make_optimizer(cfg, lr)
    mb = max(1, cfg.microbatches)

    def train_step(params, opt_state, batch):
        grads, loss_sum = accumulate_grads(cfg, params, batch)
        with torch.no_grad():
            grads = tree_map(lambda g: g.div_(mb), grads)
            new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss_sum / mb}

    return train_step, opt


def _cloud_sync(pod_params, do_cloud_sync):
    """eq. (3) where ``do_cloud_sync``: every pod's params replaced by
    their mean over the pod axis (``torch.where(do_cloud_sync, mean,
    params)``). No host synchronisation: a device bool selects on the
    device, a host bool (or CPU tensor) is read on the host and the mean
    is then written over ``pod_params`` in place."""
    if (isinstance(do_cloud_sync, torch.Tensor)
            and do_cloud_sync.device.type != "cpu"):
        return tree_map(lambda x: torch.where(
            do_cloud_sync, x.mean(dim=0, keepdim=True), x), pod_params)
    if bool(do_cloud_sync):
        tree_map(lambda x: x.copy_(x.mean(dim=0, keepdim=True)), pod_params)
    return pod_params


def make_hfl_train_step(cfg: ModelConfig, *, lr: float = 1e-4,
                        impl: str = "plain"):
    """Paper-faithful two-tier step. Every pod (edge cohort) holds its own
    replica: params leaves are (n_pods, ...), batch leaves (n_pods,
    B/pods, ...). ``hfl_train_step(pod_params, batch, do_cloud_sync)``
    takes one microbatch-accumulated SGD step ``p - lr·g/mb`` per pod on
    its own slice (pods in a loop, the reference's ``vmap``), then, where
    ``do_cloud_sync`` (a bool or a 0-d bool tensor) is true, replaces
    every pod's params with their mean over pods (eq. (3))."""
    _check_train_impl(impl)
    mb = max(1, cfg.microbatches)

    def hfl_train_step(pod_params, batch, do_cloud_sync):
        n_pods = tree_leaves(pod_params)[0].shape[0]
        new_pp = tree_map(torch.empty_like, pod_params)
        for i in range(n_pods):
            params = tree_map(lambda x: x[i], pod_params)
            g_sum, _ = accumulate_grads(cfg, params,
                                        tree_map(lambda x: x[i], batch))
            with torch.no_grad():
                tree_map(lambda out, p, g: out[i].copy_(p - lr * g / mb),
                         new_pp, params, g_sum)
            del g_sum
        with torch.no_grad():
            return _cloud_sync(new_pp, do_cloud_sync)

    return hfl_train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens, pos) -> (logits, cache): one
    decode step on the KV caches (plain attention, no kernel) and the
    SSM caches (the Mamba-2 recurrence) of ``T.init_cache``."""

    def serve_step(params, cache, tokens, pos):
        return T.decode(params, tokens, cache, pos, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "plain"):
    """prefill_step(params, batch) -> logits: the full-sequence forward.
    ``impl="kernel"`` runs each attention layer through the
    flash-attention kernel (the reference's ``impl="pallas"``)."""
    if impl not in attn.IMPLS:
        raise ValueError(f"impl must be one of {attn.IMPLS}, got {impl!r}")

    def prefill_step(params, batch):
        logits, _ = T.forward(params, batch, cfg, impl=impl)
        return logits

    return prefill_step
