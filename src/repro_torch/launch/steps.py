"""Step factories and shape structs (port of ``repro.launch.steps``).

Without a mesh (``mesh=None``, the default) a factory runs on one
device, as the reference does on its one-device debug mesh, where its
sharder is the no-op; a struct is then a tree of ``device="meta"``
tensors (shape and dtype, no storage) in the reference's tree, where
the reference gives ``jax.ShapeDtypeStruct``s.

With a ``DeviceMesh`` (``repro_torch.launch.mesh``; the default process
group must be initialised, else the factory raises) the reference's
``NamedSharding``s become DTensor placements:

* params are DTensors placed by ``parallel.sharding.param_specs``, the
  batch by its batch axes (``input_shardings``); :func:`shard_tree`
  moves the plain trees that ``repro_torch.convert`` makes onto the
  mesh and :func:`full_tree` gathers them back;
* the models run on DTensors with a ``MeshSharder`` of
  ``act_rules(cfg, mesh)``, inside ``implicit_replication`` (a plain
  tensor made in the model code, a mask or a position, counts as
  replicated); DTensor's propagation inserts the collectives: the mean
  gradient over ``data`` (and ``pod``) is the reduction it gives;
* each microbatch's gradient is moved to its parameter's placements
  before it is summed (the reference pins its f32 carry to the param
  shardings), so gradients stay sharded;
* the structs are meta DTensors with those placements; moments inherit
  their parameter's.

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

import contextlib
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.convert import flatten_params, unflatten_params
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor, adam
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharder import NOOP, MeshSharder
from repro_torch.utils import tree_leaves, tree_map

BIG_MODEL_PARAMS = 20e9      # adafactor above this


# ------------------------------------------------------------ structs

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _map2(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its tree of
    :class:`~repro_torch.parallel.sharding.Sharding` (a named tuple, so
    the shardings stop the walk)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, shardings)]
    return fn(tree, shardings)


def _meta_dtensor(x: torch.Tensor, sharding: shd.Sharding) -> DTensor:
    """A meta DTensor of x's shape and dtype with ``sharding``'s
    placements (its local block is a meta tensor: no storage)."""
    return distribute_tensor(_meta(x.shape, x.dtype), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def _batch_spec(x, mesh, pods: bool = False) -> shd.PartitionSpec:
    lead = ("pod", "data") if pods else (shd.batch_axes(mesh),)
    return shd.fit_spec(mesh, x.shape, shd.P(*lead[:x.dim()]))


def input_shardings(batch, mesh, *, pods: bool = False):
    """Tree of shardings of a model input tree: leading batch dimension
    over the batch axes (``pods=True``: the two-tier step's (n_pods,
    B/pods, ...) leaves over ("pod", "data")), the rest replicated; a
    scalar (the decode position) replicated."""
    return tree_map(lambda x: shd.Sharding(
        mesh, shd.placements(mesh, _batch_spec(x, mesh, pods))), batch)


def input_specs(cfg: ModelConfig, shape: InputShape, *, mesh=None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of ``shape``: tokens
    and labels (train/prefill, the text positions after the vlm prefix),
    ``prefix_embeds`` in the compute dtype, or one decode token and its
    position; with a mesh, meta DTensors placed by
    :func:`input_shardings`."""
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
    else:
        batch = {"tokens": _meta((B, 1, *books), torch.int32),
                 "pos": _meta((), torch.int32)}
    if mesh is None:
        return batch
    return _map2(_meta_dtensor, batch, input_shardings(batch, mesh))


def cache_specs_struct(cfg: ModelConfig, shape: InputShape, *, mesh=None):
    """The decode caches of ``shape`` as meta tensors; with a mesh, meta
    DTensors placed by ``cache_specs``."""
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device="meta")
    if mesh is None:
        return cache
    return _map2(_meta_dtensor, cache, shd.cache_shardings(cache, cfg, mesh))


def params_struct(cfg: ModelConfig, *, mesh=None):
    """The f32 parameter tree as meta tensors: ``T.init`` on the meta
    device, which draws nothing; with a mesh, meta DTensors placed by
    ``param_specs``."""
    params = T.init(None, cfg, device="meta")
    if mesh is None:
        return params
    return _map2(_meta_dtensor, params,
                 shd.param_shardings(params, cfg, mesh))


def opt_state_struct(cfg: ModelConfig, opt, *, mesh=None):
    """``opt.init`` of :func:`params_struct`: the moments as meta tensors
    (the step counter is the optimizers' host int). With a mesh each
    moment takes its parameter's spec, as ``opt.init`` of DTensor params
    places it in the step; adafactor's row/column factors take it with
    the reduced dimension dropped. (The reference matches moments to
    params by shape, which hands a moment the spec of the first param of
    its shape: wq's moments get wo's.)"""
    state = opt.init(params_struct(cfg))
    if mesh is None:
        return state
    ps = params_struct(cfg)

    def place(x, spec):
        spec = shd.fit_spec(mesh, x.shape, spec)
        return _meta_dtensor(x, shd.Sharding(mesh, shd.placements(mesh,
                                                                  spec)))

    def walk(node, p, spec):
        if isinstance(p, dict):
            return {k: walk(node[k], p[k], spec[k]) for k in p}
        if isinstance(p, list):
            return [walk(n, q, sp) for n, q, sp in zip(node, p, spec)]
        if isinstance(node, dict):          # adafactor's factors
            ent = list(spec) + [None] * (p.dim() - len(spec))
            cut = {"vr": ent[:-1], "vc": ent[:-2] + ent[-1:], "v": ent}
            return {k: place(v, shd.P(*cut[k])) for k, v in node.items()}
        return place(node, spec)

    specs = shd.param_specs(ps, cfg, mesh)
    return {k: walk(v, ps, specs) if isinstance(v, (dict, list)) else v
            for k, v in state.items()}


# ------------------------------------------------------ trees on a mesh

def shard_tree(tree, shardings):
    """Plain tensors -> DTensors placed by ``shardings`` (a tree of
    :class:`~repro_torch.parallel.sharding.Sharding`). Every rank passes
    the same full tree (as ``repro_torch.convert`` makes it) and keeps
    its own block (``distribute_tensor`` with no source rank): no
    communication. A block split along dim 0 is a view of the full
    tensor, one split along another dim a copy; on one rank the tensor
    itself is the block."""
    return _map2(lambda x, sh: distribute_tensor(
        x, sh.mesh, sh.placements, src_data_rank=None), tree, shardings)


def full_tree(tree):
    """DTensors -> whole plain tensors on every rank (a collective: every
    rank calls it); other leaves pass unchanged."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)


def pod_param_shardings(pod_params, cfg: ModelConfig, mesh):
    """Shardings of the two-tier step's (n_pods, ...) params: the pod
    dimension over ``pod``, each replica by its parameter's spec."""
    one = tree_map(lambda x: _meta(x.shape[1:], x.dtype), pod_params)

    def spec(x, s):
        return shd.Sharding(mesh, shd.placements(
            mesh, shd.fit_spec(mesh, x.shape, shd.P("pod", *s))))

    return _map2(spec, pod_params, shd.param_specs(one, cfg, mesh))


def _check_mesh(mesh):
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh-sharded step needs an initialised process group "
            "(repro_torch.launch.mesh.init_group)")
    if getattr(mesh, "mesh_dim_names", None) is None:
        raise TypeError(f"mesh must be a named DeviceMesh, got {mesh!r}")
    return mesh


def _dtensor_leaves(tree, what: str):
    for x in tree_leaves(tree):
        if not isinstance(x, DTensor):
            raise TypeError(f"a mesh-sharded step takes {what} as DTensors "
                            "(shard_tree), got a plain tensor")


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


def _micro_rows(batch, mb: int):
    """Microbatch i of ``batch``: rows ``[i·n, (i+1)·n)``. A DTensor
    batch is gathered once and each microbatch placed again on the batch
    axes, so every microbatch is split over the data ranks as the whole
    batch was."""
    B = tree_leaves(batch)[0].shape[0]
    if B % mb:
        raise ValueError(f"batch {B} is not a multiple of the "
                         f"{mb} microbatches")
    n = B // mb
    if mb == 1:
        return lambda i: batch
    if not isinstance(tree_leaves(batch)[0], DTensor):
        return lambda i: tree_map(lambda x: x[i * n:(i + 1) * n], batch)
    whole = tree_map(lambda x: x.redistribute(
        x.device_mesh, [Replicate()] * x.device_mesh.ndim), batch)

    def rows(i):
        def one(x, full):
            part = full[i * n:(i + 1) * n]
            return part.redistribute(x.device_mesh, x.placements)
        return tree_map(one, batch, whole)
    return rows


def accumulate_grads(cfg: ModelConfig, params,
                     batch: Dict[str, torch.Tensor], *, sharder=NOOP):
    """(gradient, loss) of ``T.loss_fn`` (plain attention) at ``params``,
    each summed over the ``mb = max(1, cfg.microbatches)`` microbatches
    of ``batch`` (divide by mb for the means): f32 gradients in the
    params' tree. Every leaf must get a gradient (``torch.autograd.grad``
    raises on an unused one). Runs with grad mode on whatever the
    caller's mode. On DTensor params each microbatch's gradient is moved
    to its parameter's placements before it is summed, so the sum stays
    sharded as the params are."""
    mb = max(1, cfg.microbatches)
    micro = _micro_rows(batch, mb)
    live = flatten_params(tree_map(
        lambda p: p.detach().requires_grad_(), params))

    def pinned(g, p):
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
        return g

    g_sum = loss_sum = None
    with torch.enable_grad():
        for i in range(mb):
            loss, _ = T.loss_fn(unflatten_params(live), micro(i), cfg,
                                sharder=sharder)
            grads = torch.autograd.grad(loss, list(live.values()))
            loss = loss.detach()
            grads = [pinned(g, p) for g, p in zip(grads, live.values())]
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


def _on_mesh(mesh):
    """The context a mesh-sharded step runs in: plain tensors made inside
    it count as replicated DTensors."""
    return implicit_replication() if mesh is not None \
        else contextlib.nullcontext()


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(cfg: ModelConfig, *, mesh=None, lr: float = 1e-4,
                    impl: str = "plain"):
    """Returns ``(train_step, opt)``; ``train_step(params, opt_state,
    batch) -> (params, opt_state, {"loss": mean microbatch loss})`` with
    the optimizer's update under ``torch.no_grad()``.

    With ``mesh`` (a ``DeviceMesh`` with "data" and "model" axes, and
    "pod" for a multi-pod mesh) params and moments are DTensors placed by
    ``param_specs`` (``shard_tree(params, param_shardings(...))``,
    ``opt.init`` of those) and the batch by :func:`input_shardings`; the
    returned params and moments keep those placements, and the loss is a
    plain tensor on every rank."""
    _check_train_impl(impl)
    opt = make_optimizer(cfg, lr)
    mb = max(1, cfg.microbatches)
    sharder = NOOP
    if mesh is not None:
        sharder = MeshSharder(_check_mesh(mesh), shd.act_rules(cfg, mesh))

    def train_step(params, opt_state, batch):
        if mesh is not None:
            _dtensor_leaves(params, "params")
            _dtensor_leaves(batch, "the batch")
        with _on_mesh(mesh):
            grads, loss_sum = accumulate_grads(cfg, params, batch,
                                               sharder=sharder)
            with torch.no_grad():
                grads = tree_map(lambda g: g.div_(mb), grads)
                new_params, new_opt = opt.update(grads, opt_state, params)
                loss = _whole(loss_sum / mb)
        return new_params, new_opt, {"loss": loss}

    return train_step, opt


def _cloud_sync(pod_params, do_cloud_sync):
    """eq. (3) where ``do_cloud_sync``: every pod's params replaced by
    their mean over the pod axis (``torch.where(do_cloud_sync, mean,
    params)``). No host synchronisation: a device bool selects on the
    device, a host bool (or CPU tensor) is read on the host and the mean
    is then written over ``pod_params`` in place. On DTensors whose pod
    dimension is split over ``pod``, the mean is an all-reduce over
    ``pod``."""
    if (isinstance(do_cloud_sync, torch.Tensor)
            and do_cloud_sync.device.type != "cpu"):
        return tree_map(lambda x: torch.where(
            do_cloud_sync, x.mean(dim=0, keepdim=True), x), pod_params)
    if bool(do_cloud_sync):
        tree_map(lambda x: x.copy_(x.mean(dim=0, keepdim=True)), pod_params)
    return pod_params


def _pod_local(x: DTensor, j: int, inner):
    """Pod j of this rank's block of a (n_pods, ...) DTensor, as a DTensor
    on the pod's own (data, model) mesh."""
    pls = [type(p)(p.dim - 1) if p.is_shard() else p
           for p in x.placements[1:]]
    return DTensor.from_local(x.to_local()[j], inner, pls, run_check=False,
                              shape=x.shape[1:],
                              stride=_meta(x.shape[1:], x.dtype).stride())


def make_hfl_train_step(cfg: ModelConfig, *, mesh=None, lr: float = 1e-4,
                        impl: str = "plain"):
    """Paper-faithful two-tier step. Every pod (edge cohort) holds its own
    replica: params leaves are (n_pods, ...), batch leaves (n_pods,
    B/pods, ...). ``hfl_train_step(pod_params, batch, do_cloud_sync)``
    takes one microbatch-accumulated SGD step ``p - lr·g/mb`` per pod on
    its own slice (pods in a loop, the reference's ``vmap``), then, where
    ``do_cloud_sync`` (a bool or a 0-d bool tensor) is true, replaces
    every pod's params with their mean over pods (eq. (3)).

    With ``mesh`` (axes "pod", "data", "model") the pod dimension is
    split over ``pod`` (:func:`pod_param_shardings`, the batch by
    ``input_shardings(batch, mesh, pods=True)``): each rank steps only
    the pods of its block, each on the pod's (data, model) sub-mesh with
    the reference's per-pod step (no activation rules, MoE layers
    dispatching in one chunk, as the reference's ``one_pod_step``), and
    the cloud mean is an all-reduce over ``pod``."""
    _check_train_impl(impl)
    mb = max(1, cfg.microbatches)
    if mesh is not None:
        _check_mesh(mesh)
        if "pod" not in mesh.mesh_dim_names:
            raise ValueError("the two-tier step needs a mesh with a 'pod' "
                             f"axis, got {mesh.mesh_dim_names}")
        inner = mesh["data", "model"]

    def sgd(params, batch):
        g_sum, _ = accumulate_grads(cfg, params, batch)
        with torch.no_grad():
            return tree_map(lambda p, g: p - lr * g / mb, params, g_sum)

    def hfl_train_step(pod_params, batch, do_cloud_sync):
        if mesh is None:
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
        _dtensor_leaves(pod_params, "params")
        _dtensor_leaves(batch, "the batch")
        with implicit_replication():
            n_local = tree_leaves(pod_params)[0].to_local().shape[0]
            blocks = tree_map(lambda x: torch.empty_like(x.to_local()),
                              pod_params)
            for j in range(n_local):
                new = sgd(tree_map(lambda x: _pod_local(x, j, inner),
                                   pod_params),
                          tree_map(lambda x: _pod_local(x, j, inner), batch))
                with torch.no_grad():
                    tree_map(lambda out, p: out[j].copy_(p.to_local()),
                             blocks, new)
                del new
            new_pp = tree_map(lambda x, b: DTensor.from_local(
                b, mesh, x.placements, run_check=False, shape=x.shape,
                stride=x.stride()), pod_params, blocks)
            with torch.no_grad():
                return _cloud_sync(new_pp, do_cloud_sync)

    return hfl_train_step


def make_serve_step(cfg: ModelConfig, *, mesh=None):
    """serve_step(params, cache, tokens, pos) -> (logits, cache): one
    decode step on the KV caches (plain attention, no kernel) and the
    SSM caches (the Mamba-2 recurrence) of ``T.init_cache``, updated in
    place. With ``mesh``: params, cache and tokens as DTensors
    (``param_specs``, ``cache_specs``, :func:`input_shardings`), logits
    a DTensor (``.full_tensor()`` gathers them)."""
    sharder = NOOP
    if mesh is not None:
        sharder = MeshSharder(_check_mesh(mesh), shd.act_rules(cfg, mesh))

    def serve_step(params, cache, tokens, pos):
        if mesh is not None:
            _dtensor_leaves(params, "params")
        with _on_mesh(mesh):
            return T.decode(params, tokens, cache, pos, cfg, sharder=sharder)

    return serve_step


def make_prefill_step(cfg: ModelConfig, impl: str = "plain", *, mesh=None):
    """prefill_step(params, batch) -> logits: the full-sequence forward.
    ``impl="kernel"`` runs each attention layer through the
    flash-attention kernel (the reference's ``impl="pallas"``); under a
    mesh each rank runs it on its local block through ``local_map``.
    With ``mesh``: params and batch as DTensors, logits a DTensor."""
    if impl not in attn.IMPLS:
        raise ValueError(f"impl must be one of {attn.IMPLS}, got {impl!r}")
    sharder = NOOP
    if mesh is not None:
        sharder = MeshSharder(_check_mesh(mesh), shd.act_rules(cfg, mesh))

    def prefill_step(params, batch):
        if mesh is not None:
            _dtensor_leaves(params, "params")
        with _on_mesh(mesh):
            logits, _ = T.forward(params, batch, cfg, sharder=sharder,
                                  impl=impl)
        return logits

    return prefill_step
