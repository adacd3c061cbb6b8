"""Parameter/activation sharding rules: FSDP(data) x TP(model) [+ pod].

Port of ``repro.parallel.sharding``. The rules are the reference's,
written over the port's :class:`PartitionSpec` (a tuple whose entries
are an axis name, a tuple of names, or ``None``); :func:`placements`
turns a spec into DTensor placements over a ``DeviceMesh``.

Mesh axes:
  pod   — cloud tier: one pod per HFL "edge-server group" (multi-pod only)
  data  — devices-within-edge cohort: batch/FSDP axis
  model — tensor/expert parallel axis
  lane  — the sweep's 1-D mesh: independent seed lanes

Param rules (leaf-path based, over the stacked block trees whose leading
axis is the layer stack):

  tp_strategy="heads" (Megatron col/row over attention heads):
    wq (D, Hq*hd) -> (data, model);  wk/wv (D, Hkv*hd) -> (data, None);
    wo (Hq*hd, D) -> (model, data)
  tp_strategy="feature": attention weights FSDP-only; MLP/experts TP.
  mlp w_gate/w_up (D,F) -> (data, model); w_down (F,D) -> (model, data)
  moe experts (E,D,F)   -> (model, data, None)   expert parallelism
  embed (V, D) -> (model, data);  lm_head (D, V) -> (data, model)
  mamba projections wz/wx -> (data, model); wb/wc/wdt -> (data, None);
  out_proj -> (model, data); norms / scalars -> replicated

Every rule is divisibility-checked against the leaf's shape and the mesh
axis sizes (:func:`fit_spec`): an axis that does not divide its
dimension is dropped, as in the reference, so local shapes are the
reference's even though DTensor would accept uneven shards.

The rules read only the mesh's axis names and sizes, so a
:class:`AbstractMesh` (names and sizes, no process group) is enough for
them; :func:`placements` needs the names alone, and the ``*_shardings``
helpers pair the placements with the mesh they are given.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Sequence

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor (the reference's
    ``jax.sharding.PartitionSpec``): each entry is an axis name, a tuple
    of names (the first one major) or ``None`` (not sharded); a tuple of
    one name is that name, as JAX normalises it. Trailing dimensions
    beyond the spec are not sharded."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes of a mesh without devices or a process group
    (the reference's ``jax.sharding.AbstractMesh``): enough for the
    rules, which read ``shape`` and ``axis_names`` alone."""

    def __init__(self, shape: Mapping[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


class Sharding(NamedTuple):
    """Where a tensor lives: the mesh and one DTensor placement a mesh
    dimension (the reference's ``NamedSharding``)."""
    mesh: Any
    placements: tuple


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh``, an
    :class:`AbstractMesh` or anything else with ``shape`` and
    ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                      # torch DeviceMesh
        return dict(zip(names, mesh.shape))
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    axes = mesh_axes(mesh)
    if isinstance(name, (tuple, list)):
        return int(math.prod(axes[n] for n in name))
    return axes[name]


def fit_spec(mesh, shape, spec: Sequence) -> PartitionSpec:
    """Drop spec axes whose size does not divide the dimension."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, name in zip(shape, entries):
        if name is not None and dim % _axis_size(mesh, name) == 0:
            out.append(name)
        else:
            out.append(None)
    return P(*out)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: a mesh dimension
    named in tensor dimension d becomes ``Shard(d)``, every other one
    ``Replicate()``. A tuple entry shards one dimension over several mesh
    dimensions, the first one major (as JAX lays it out), which DTensor
    does when their mesh order is the tuple's order; another order
    raises. A mesh dimension of size 1 splits nothing and is always
    ``Replicate()`` (DTensor refuses to reshape a dimension it counts as
    sharded, even over one rank). Apply :func:`fit_spec` first: the
    placements do not check divisibility."""
    axes = mesh_axes(mesh)
    order = list(axes)
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {names} of dimension {d} are "
                             f"not in the mesh's order {tuple(order)}")
        for n in names:
            if n in where:
                raise ValueError(f"{spec}: axis {n!r} shards two dimensions")
            where[n] = d
    return tuple(Shard(where[n]) if n in where and axes[n] > 1
                 else Replicate() for n in order)


# ------------------------------------------------------- sweep lane axis

def lane_spec() -> PartitionSpec:
    """Spec of lane-stacked sweep tensors: the leading (seed-lane) axis
    over the lane mesh, the rest replicated."""
    return P("lane")


def lane_sharding(mesh) -> Sharding:
    """The leading lane axis of an (S, ...) tensor over a 1-D
    ``sweep_mesh``; S must be a multiple of the lane axis size
    (``SweepRunner`` pads with dead lanes, see :func:`pad_lanes`)."""
    return Sharding(mesh, placements(mesh, lane_spec()))


def pad_lanes(n_lanes: int, n_devices: int) -> int:
    """Smallest multiple of n_devices >= n_lanes (lane-block padding)."""
    return -(-n_lanes // n_devices) * n_devices


def round_lane_spec() -> PartitionSpec:
    """Spec of round-major lane-stacked tensors — the fused sweep's
    (R, S, ...) schedules and its (R, S) per-round records: the round
    axis stays whole on every rank, only the lane axis shards."""
    return P(None, "lane")


# ------------------------------------------------------------ parameters

def _param_rule(path: str, ndim: int, cfg: ModelConfig) -> PartitionSpec:
    heads_tp = cfg.tp_strategy == "heads"

    def blocked(*spec):
        """Prepend None for the layer-stack axis if the leaf is stacked."""
        if ndim == len(spec) + 1:
            return P(None, *spec)
        return P(*spec)

    if path.endswith("embed"):
        return P("model", "data")
    if path.endswith("lm_head"):
        return P("data", "model")
    if "scale" in path or path.endswith(("A_log", "D_skip", "dt_bias", "b")):
        return P()
    if "mix/" in path or "/mix" in path:
        if path.endswith("wq"):
            return blocked("data", "model") if heads_tp else blocked("data", None)
        if path.endswith(("wk", "wv")):
            return blocked("data", None)
        if path.endswith("wo"):
            return blocked("model", "data") if heads_tp else blocked(None, "data")
        if path.endswith(("in_proj", "wz", "wx")):
            return blocked("data", "model")
        if path.endswith(("wb", "wc", "wdt")):
            return blocked("data", None)
        if path.endswith("out_proj"):
            return blocked("model", "data")
        if path.endswith(("conv_w", "conv_x")):
            return blocked("model", None)
        if path.endswith(("conv_b", "conv_c")):
            return blocked()
    if path.endswith(("w_gate", "w_up")):
        # (D,F) | (layers,D,F) dense -> col-parallel; (layers,E,D,F) or
        # (E,D,F) experts -> expert-parallel over model, FSDP on D
        if ndim == 4:
            return P(None, "model", "data", None)
        if ndim == 3 and "blocks" not in path:
            return P("model", "data", None)
        return blocked("data", "model")
    if path.endswith("w_down"):
        if ndim == 4:
            return P(None, "model", None, "data")
        if ndim == 3 and "blocks" not in path:
            return P("model", None, "data")
        return blocked("model", "data")
    if path.endswith("router"):
        return blocked("data", None)
    return P()


def _map_with_path(fn, tree, path=()):
    """``fn(path string, leaf)`` over nested dicts/lists, keeping the
    tree; the path joins dict keys and list indices with "/" as the
    reference's ``_leaf_path`` does. Tuples are leaves: a spec is one."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def param_specs(params: Any, cfg: ModelConfig, mesh):
    """Tree of :class:`PartitionSpec` matching ``params`` (any leaves with
    ``ndim`` and ``shape``: tensors, meta tensors, DTensors)."""
    return _map_with_path(
        lambda p, leaf: fit_spec(mesh, leaf.shape,
                                 _param_rule(p, leaf.ndim, cfg)), params)


def _shardings(specs, mesh):
    return _map_with_path(
        lambda _, s: Sharding(mesh, placements(mesh, s)), specs)


def param_shardings(params, cfg, mesh):
    """Tree of :class:`Sharding` (mesh, placements) matching ``params``."""
    return _shardings(param_specs(params, cfg, mesh), mesh)


# ------------------------------------------------------------ activations

def act_rules(cfg: ModelConfig, mesh) -> dict:
    dp = batch_axes(mesh)
    heads_tp = cfg.tp_strategy == "heads"
    # sequence parallelism: the residual stream is additionally sharded
    # over `model`
    resid = P(dp, "model", None) if cfg.seq_shard else P(dp, None, None)
    return {
        "act_resid": resid,
        "act_resid_decode": P(dp, None, None),
        "act_heads": P(dp, None, "model", None) if heads_tp
                     else P(dp, None, None, None),
        "act_kv_heads": P(dp, None, None, None),
        # chunked-prefill scores (B, Hkv, G, bq, S_kv)
        "attn_scores_heads": P(dp, "model", None, None, None),
        "attn_scores_seq": P(dp, None, None, None, "model"),
        "ssm_heads": P(dp, None, "model", None),
        "ssm_chunk_x": P(dp, None, None, "model", None),
        "ssm_chunk_bc": P(dp, None, None, "model", None),
        "ssm_chunk_cum": P(dp, None, None, "model"),
        "ssm_chunk_ij": P(dp, None, None, None, "model"),
        # (gd, E, C, D/F): data-chunks over batch axes, experts over model
        "moe_buffer": P(dp, "model", None, None),
        "moe_hidden": P(dp, "model", None, None),
        "logits": P(dp, None, "model"),
    }


# ------------------------------------------------------------- caches

def cache_specs(cache, cfg: ModelConfig, mesh):
    """Decode-cache specs: batch over (pod,data) when divisible; KV slots
    over model (sequence-parallel cache); SSM heads over model. Leaves
    are matched by name suffix exactly as the reference matches them
    (so ``conv``, which ends in "v", takes the KV rule)."""
    dp = batch_axes(mesh)

    def rule(name, x):
        if name.endswith(("k", "v")):        # (nb, B, slots, Hkv, hd)
            spec = P(None, dp, "model", None, None)
        elif name.endswith("ssm"):           # (nb, B, H, hd, dstate)
            spec = P(None, dp, "model", None, None)
        elif name.endswith("conv"):          # (nb, B, W-1, conv_dim)
            spec = P(None, dp, None, "model")
        else:
            spec = P()
        return fit_spec(mesh, x.shape, spec)

    return _map_with_path(rule, cache)


def cache_shardings(cache, cfg, mesh):
    return _shardings(cache_specs(cache, cfg, mesh), mesh)
