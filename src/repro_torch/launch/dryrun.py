"""Multi-pod dry run: trace every (arch x shape x mesh) step on a fake
process group (port of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chatglm3-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --hfl-step --arch chatglm3-6b

Shows without hardware that the distribution config is coherent. The
reference lowers each step for 512 XLA host placeholder devices; here a
``fake`` process group of 256 (16x16) or 512 (2x16x16) ranks stands in
for them (its collectives return at once, answering nothing), the
production ``DeviceMesh`` is built over it on the CPU, and the mesh
step runs on meta DTensors (``steps.params_struct`` /
``opt_state_struct`` / ``input_specs`` / ``cache_specs_struct``): shapes,
dtypes and placements, no storage, nothing allocated on any device and
no card needed. This is the dry run's own design, not a fallback: it
runs the same way on a card's host.

While the step runs, one dispatch mode (:class:`StepAccount`) sees the
ops DTensor runs on this rank's local blocks (it declines the DTensor
ops themselves, so each local op is counted once) and records, for
rank 0 of the group:

* ``memory``: ``argument_bytes`` and ``output_bytes``, the local-block
  bytes of the step's inputs and outputs (``argument_parts`` splits the
  former into params, opt_state, batch, cache); ``temp_bytes``, the
  peak of the live bytes the step itself allocates (each storage once,
  freed when its last tensor dies; views of the arguments are not new),
  outputs made before the peak included, so ``argument_bytes +
  temp_bytes`` predicts a rank's peak.
  The reference's ``generated_code_bytes`` has no counterpart.
* ``cost``: ``flops``, PyTorch's flop formulas (``torch.utils.
  flop_counter``) over the local ops (matmuls, convolutions, attention;
  no elementwise op). ``FlopCounterMode`` around the step would count
  the DTensor ops on global shapes as well.
* ``collectives``: the reference's five keys, each ``{count, bytes,
  by_axis}``; bytes are the summed output bytes (as the reference's
  ``parse_collectives`` sums them), ``by_axis`` the count per mesh axis
  the group spans. ``all_gather_into_tensor`` is an all-gather,
  ``all_reduce`` an all-reduce, ``reduce_scatter_tensor`` a
  reduce-scatter, ``all_to_all_single`` an all-to-all; nothing issues a
  collective-permute. ``CommDebugMode``'s counts are checked against
  these. They are DTensor's eager schedule, not XLA SPMD's: on a CPU
  mesh DTensor gathers and chunks where it would send an all-to-all,
  and reduces a partial sum over several axes one axis at a time.

Every number is that of the schedule the installed torch's DTensor
runs, so the record names that torch (``torch``). Schedules differ
between releases. On torch 2.13 the gradient that reaches the o and
down projections' backward is a partial sum over ``model``, and
DTensor runs the o projection's input and weight gradients and the
down projection's input gradient over the full width on every model
rank; on 2.11 that gradient is replicated and each rank runs its
shard. chatglm3-6b x train_4k on 16x16 then counts 5.20e14 flops and
23.7 GB of temp bytes a rank on 2.13, against 2.12e14 and 13.0 GB on
2.11: the three matmuls' 15 redundant sixteenths are the flops'
difference (``tools/dryrun_ops.py`` lists a record's flops by op).

The record keeps the reference's ``arch, shape, mesh, family, params,
active_params, sliding_window``; ``trace_s`` (the wall of one traced
step) stands for its ``lower_s``/``compile_s``, and ``hlo_len`` has no
counterpart. The decode step takes its position as a Python int
(``seq_len - 1``), as ``serve_lm`` does.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          variant_for_shape)
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import tree_leaves, tree_map

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# functional collectives (``torch.ops._c10d_functional``) -> record key
FUNCOL = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all"}
# functional ops that move no data
FUNCOL_QUIET = ("wait_tensor", "_wrap_tensor_autograd")


def _nbytes(x) -> int:
    if isinstance(x, DTensor):
        x = x.to_local()
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def tree_local_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` on this rank: a DTensor's local
    block, a plain tensor whole; other leaves (a host int) count 0."""
    return sum(_nbytes(x) for x in tree_leaves(tree))


class StepAccount(TorchDispatchMode):
    """Per-rank flops, collectives and live bytes of the local ops run
    under it. DTensor ops are declined (``NotImplemented``) so DTensor
    runs them and the mode sees the local ops they become, once each;
    the ops DTensor runs under its fake mode to infer output shapes, and
    ops with outputs off the meta device (host index bookkeeping), are
    passed through uncounted. ``axis_of`` maps a process-group name to
    the mesh axis it spans; ``held`` are tensors the caller holds (the
    step's arguments), whose storages, viewed by the step, are not its
    own."""

    def __init__(self, axis_of: Optional[Dict[str, str]] = None,
                 held: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.axis_of = axis_of or {}
        self.flops = 0
        self.collectives = {c: {"count": 0, "bytes": 0, "by_axis": {}}
                            for c in COLLECTIVES}
        self.live = self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._held = {id(t.untyped_storage()) for t in held}

    def _release(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._refs.pop(key, None)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs or key in self._held:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, k=key, n=nbytes: self._release(k, n))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _collective(self, func, args, outs) -> None:
        name = func._opname
        if name in FUNCOL_QUIET:
            return
        if name not in FUNCOL:
            raise NotImplementedError(
                f"dry run: no record key for the collective {func}")
        rec = self.collectives[FUNCOL[name]]
        rec["count"] += 1
        rec["bytes"] += sum(_nbytes(x) for x in outs)
        group = args[-1] if isinstance(args[-1], str) else None
        axis = self.axis_of.get(group, group or "?")
        rec["by_axis"][axis] = rec["by_axis"].get(axis, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs the op on fake tensors
            # of the global shapes: not work this rank does
            return out
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        if any(x.device.type != "meta" for x in outs):
            # host bookkeeping (DTensor's and the attention's index
            # tensors): not device work or memory
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.namespace == "_c10d_functional":
            self._collective(func, args, outs)
        for x in outs:
            self._track(x)
        return out


def _axis_names(mesh) -> Dict[str, str]:
    return {mesh.get_group(name).group_name: name
            for name in mesh.mesh_dim_names}


def _check_comm_counts(acct: StepAccount, cdm: CommDebugMode) -> None:
    """Each record key's count against ``CommDebugMode``'s for the same
    functional ops."""
    theirs = {c: 0 for c in COLLECTIVES}
    for op, n in cdm.get_comm_counts().items():
        key = FUNCOL.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if key is not None:
            theirs[key] += n
    ours = {c: acct.collectives[c]["count"] for c in COLLECTIVES}
    if ours != theirs:
        raise RuntimeError(f"dry run: collective counts {ours} differ from "
                           f"CommDebugMode's {theirs}")


def _pods(tree, n_pods: int, batch: bool):
    """Meta stand-ins of the two-tier step's leaves: params (n_pods,
    ...), batch leaves (n_pods, B/n_pods, ...)."""
    def one(x):
        shape = ((n_pods, x.shape[0] // n_pods) + tuple(x.shape[1:])
                 if batch else (n_pods,) + tuple(x.shape))
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return tree_map(one, tree)


def _step_and_args(cfg: ModelConfig, shape: InputShape, mesh, hfl: bool):
    """(step, positional args, named argument parts, grad mode) of one
    dry run."""
    if hfl:
        n_pods = mesh.size(mesh.mesh_dim_names.index("pod"))
        pp = _pods(S.params_struct(cfg), n_pods, batch=False)
        pp = S.shard_tree(pp, S.pod_param_shardings(pp, cfg, mesh))
        raw = _pods(S.input_specs(cfg, shape), n_pods, batch=True)
        batch = S.shard_tree(raw, S.input_shardings(raw, mesh, pods=True))
        step = S.make_hfl_train_step(cfg, mesh=mesh)
        return step, (pp, batch, True), {"params": pp, "batch": batch}, True
    ps = S.params_struct(cfg, mesh=mesh)
    if shape.kind == "train":
        step, opt = S.make_train_step(cfg, mesh=mesh)
        state = S.opt_state_struct(cfg, opt, mesh=mesh)
        batch = S.input_specs(cfg, shape, mesh=mesh)
        return step, (ps, state, batch), {"params": ps, "opt_state": state,
                                          "batch": batch}, True
    if shape.kind == "prefill":
        batch = S.input_specs(cfg, shape, mesh=mesh)
        return (S.make_prefill_step(cfg, mesh=mesh), (ps, batch),
                {"params": ps, "batch": batch}, False)
    cache = S.cache_specs_struct(cfg, shape, mesh=mesh)
    tokens = S.input_specs(cfg, shape, mesh=mesh)["tokens"]
    return (S.make_serve_step(cfg, mesh=mesh),
            (ps, cache, tokens, shape.seq_len - 1),
            {"params": ps, "cache": cache, "batch": tokens}, False)


def dryrun_step(cfg: ModelConfig, shape: InputShape, mesh, *,
                hfl: bool = False) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a DeviceMesh
    over an initialised group, the fake one for a dry run) on meta
    DTensors and return ``{"trace_s", "memory", "cost", "collectives"}``
    for this rank (and ``torch``, the version whose schedule it is).
    ``hfl=True`` runs the two-tier step
    (``make_hfl_train_step`` with the cloud sync on) on a mesh with a
    "pod" axis."""
    step, args, parts, grad = _step_and_args(cfg, shape, mesh, hfl)
    held = [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(args) if isinstance(x, torch.Tensor)]
    acct = StepAccount(_axis_names(mesh), held)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        cdm = stack.enter_context(CommDebugMode())
        stack.enter_context(acct)
        if not grad:
            stack.enter_context(torch.no_grad())
        out = step(*args)
    trace_s = time.perf_counter() - t0
    _check_comm_counts(acct, cdm)
    parts_b = {k: tree_local_bytes(v) for k, v in parts.items()}
    return {"torch": torch.__version__, "trace_s": round(trace_s, 2),
            "memory": {"argument_bytes": sum(parts_b.values()),
                       "output_bytes": sum(_nbytes(x)
                                           for x in tree_flatten(out)[0]),
                       "temp_bytes": acct.peak,
                       "argument_parts": parts_b},
            "cost": {"flops": float(acct.flops)},
            "collectives": acct.collectives}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks (this process is
    rank 0; every collective returns at once), closed on exit. Raises if
    a process group is open already: the dry run never works on a real
    one."""
    if dist.is_initialized():
        raise RuntimeError("a process group is open; the dry run opens its "
                           "own fake group")
    # private module: the fake backend's store; importing it registers
    # the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _record(arch: str, shape_name: str, mesh_name: str, cfg: ModelConfig,
            window: int) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "family": cfg.family, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "sliding_window": window}


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               extra: Optional[dict] = None) -> dict:
    """One arch x input shape on the 16x16 (or 2x16x16) production
    mesh over a fake group of 256 (512) ranks."""
    shape = INPUT_SHAPES[shape_name]
    cfg = variant_for_shape(get_config(arch), shape)
    rec = _record(arch, shape_name, "2x16x16" if multi_pod else "16x16",
                  cfg, cfg.sliding_window)
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec.update(dryrun_step(cfg, shape, mesh))
    if extra:
        rec.update(extra)
    return rec


def dryrun_hfl(arch: str) -> dict:
    """The two-tier HFL step (paper mapping) on 2x16x16: per-pod model
    replicas (leading pod dimension over ``pod``), one edge step per pod,
    then the cloud aggregation, an all-reduce over ``pod``."""
    shape = INPUT_SHAPES["train_4k"]
    cfg = get_config(arch)
    rec = _record(arch, "train_4k+hfl", "2x16x16", cfg, 0)
    with fake_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        rec.update(dryrun_step(cfg, shape, mesh, hfl=True))
    return rec


def _key(r: dict):
    return r["arch"], r["shape"], r["mesh"]


def _load(path: str) -> list:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return []


def _store(path: str, results: list, rec: dict) -> list:
    results = [r for r in results if _key(r) != _key(rec)] + [rec]
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    return results


def main(argv: Optional[Sequence[str]] = None) -> list:
    """The CLI; returns the records it wrote (``--hfl-step``: the one)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--hfl-step", action="store_true",
                    help="trace the explicit two-tier HFL step instead")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.hfl_step:
        if not args.arch:
            ap.error("--hfl-step requires --arch")
        rec = dryrun_hfl(args.arch)
        print(json.dumps(rec, indent=1))
        _store(args.out, _load(args.out), rec)
        return [rec]

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = _load(args.out)
    # --force re-runs the SELECTED combos but never drops other records
    done = set() if args.force else {_key(r) for r in results
                                      if "error" not in r}
    written = []
    for mp in meshes:
        mesh_name = "2x16x16" if mp else "16x16"
        for arch in archs:
            for shape in shapes:
                key = (arch, shape, mesh_name)
                if key in done:
                    print(f"skip {key} (cached)")
                    continue
                print(f"=== dry-run {arch} x {shape} on {mesh_name}",
                      flush=True)
                try:
                    rec = dryrun_one(arch, shape, mp)
                    print(f"    ok trace={rec['trace_s']}s "
                          f"flops/rank={rec['cost']['flops']:.3e} "
                          f"args/rank={rec['memory']['argument_bytes']:,} B",
                          flush=True)
                except Exception as e:  # noqa: BLE001 (recorded, run goes on)
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}"}
                results = _store(args.out, results, rec)
                written.append(rec)
    n_err = sum(1 for r in results if "error" in r)
    print(f"done: {len(results)} records, {n_err} errors -> {args.out}")
    return written


if __name__ == "__main__":
    main()
