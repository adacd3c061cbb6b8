"""Activation-sharding hooks threaded through the model code (port of
``repro.parallel.sharder``).

Models call ``sharder.act(x, kind)`` at layer boundaries. The default
``NOOP`` leaves every tensor as it is, so one-process runs (tests, one
card) keep no mesh dependence; ``MeshSharder`` redistributes a DTensor
to the placements of the kind's rule (``repro_torch.parallel.sharding.
act_rules``), where the reference applies ``with_sharding_constraint``.
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import fit_spec, mesh_axes, placements


class Sharder:
    #: number of batch shards (drives per-shard MoE dispatch chunking)
    data_chunks: int = 1

    def act(self, x, kind: str):
        raise NotImplementedError


class NoopSharder(Sharder):
    def act(self, x, kind: str):
        return x


class MeshSharder(Sharder):
    """kind -> spec table over a ``DeviceMesh``: ``act`` moves a DTensor
    to the ``fit_spec``'d placements of the kind's rule. A tensor with no
    rule, or whose rank differs from the rule's, passes unchanged, as in
    the reference; a plain tensor under a rule raises (the step that
    built this sharder feeds the models DTensors)."""

    def __init__(self, mesh, rules: dict):
        self.mesh = mesh
        self.rules = rules
        axes = mesh_axes(mesh)
        self.data_chunks = int(axes.get("data", 1)) * int(axes.get("pod", 1))

    def act(self, x, kind: str):
        spec = self.rules.get(kind)
        if spec is None or x.ndim != len(spec):
            return x
        if not isinstance(x, DTensor):
            raise TypeError(
                f"MeshSharder.act({kind!r}) got a plain {type(x).__name__} "
                f"of shape {tuple(x.shape)}: under a mesh the model runs on "
                "DTensors (see repro_torch.launch.steps)")
        spec = fit_spec(self.mesh, x.shape, spec)
        return x.redistribute(self.mesh, placements(self.mesh, spec))


NOOP = NoopSharder()
