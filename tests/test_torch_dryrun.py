"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against
the reference's compiled steps, on the CPU.

The reference side runs in a subprocess with 8 XLA host devices and
``jax.make_mesh((2, 2, 2), ("pod", "data", "model"))`` with ``Auto``
axes (this jax's default ``Explicit`` axes make the reference's
``with_sharding_constraint`` raise; a jax without ``AxisType`` builds
the mesh with its default). It compiles each smoke config's train step
and reads ``memory_analysis().argument_size_in_bytes`` and the shard
bytes of its param, optimizer-state, batch and decode-cache structs.
The port side runs in subprocesses (``tests/_torch_dryrun_child.py``)
that own their ``fake`` process groups: the same configs on a (2, 2, 2)
mesh over 8 fake ranks.

The argument-bytes rule, exact: the port's per-rank ``argument_bytes``
equals the reference's ``argument_size_in_bytes`` less 4 bytes for each
int32 step scalar the reference's optimizer state carries (the port's
optimizers keep the step on the host) and less the bytes by which the
reference's moment structs differ from moments placed as their own
parameters: the reference's ``opt_state_struct`` matches moments to
params by shape, which hands mamba2's ``blocks[0].mix.wc`` (2, 128, 16)
the replicated spec of another leaf of that shape (2 x 8 192 bytes more
on each device); the port places each moment as its parameter, as adam
does at run time. chatglm3-6b's smoke step: 1 352 708 against
450 560 + 901 120 + 1 024. The decode caches' bytes equal the
reference's ``cache_specs_struct`` shard bytes.

Per-rank flops of each smoke train step are held to the reference's
compiled ``cost_analysis()["flops"]`` per device within a factor of
1.25 either way. The reference is compiled with ``unroll_layers=True``
for this: XLA's cost analysis counts a while loop's body once, so the
scanned layer stack counts one layer (chatglm3-6b: 1.10e8, 1.97e8
unrolled). Measured on torch 2.13 against jax 0.9.0, port / reference
(unrolled): chatglm3-6b 2.02e8 / 1.97e8, mamba2-2.7b 1.26e8 / 1.48e8,
qwen3-moe 1.52e8 / 1.73e8. The gap, op by op:
* XLA counts elementwise ops too (1 flop an element), the port's
  ``torch.utils.flop_counter`` formulas only matmuls: the reference's
  dot products alone (``dot_flops`` below) are 1.89e8, 1.36e8 and
  1.66e8;
* the LM head: the reference computes the logits and their input
  gradient over the full vocabulary on each model rank, the port on
  its vocabulary shard: -8.2e6 (chatglm3-6b), -8.4e6, -8.8e6;
* chatglm3-6b on torch 2.13: DTensor computes the o and down
  projections' input and weight gradients over the full width on every
  model rank (``tools/dryrun_ops.py --smoke``; the incoming gradient is a
  partial sum over ``model``; on torch 2.11 it is replicated and each
  rank runs its shard): +2.7e7. Without it the port counts 1.75e8, as
  it does on torch 2.11;
* the rest: -6.3e6 for chatglm3-6b, all of it the k and v
  projections, which the reference runs for every kv head on each
  model rank; -1.6e6 and -4.5e6 for the others (attention and SSM
  layouts).

Each sharded train step records all-gathers and reduce-scatters; the
two-tier HFL step records an all-reduce over ``pod``. A synthetic
DTensor matmul on a 2x16x16 fake group gives exact numbers: with x's
sequence split over model, local (32, 128, 856), one all-gather over
``model`` of 32·128·4096 f32 (torch 2.11's DTensor refuses to flatten
such an x, and the test then holds the refusal); with x's contraction
dim split over model, one all-gather of w, 4096·13696 f32, and a
partial sum of local (32, 128, 13696) on 2.11 as on 2.13; flops
2·m·n·k on the local shapes. The live-bytes account counts each
storage once and frees it with its last tensor. No step initialises
CUDA, and every leaf of a step's arguments and results is on ``meta``.
``main`` writes, caches and ``--force``-rewrites records as the
reference's does (traced there on the production meshes with the smoke
configs).

The six-arch matrix of ``tests/test_dryrun_smoke.py`` and the CLI at
full width (chatglm3-6b, 256 and 512 ranks) are marked ``slow`` as the
reference's smoke test is.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CHILD = ROOT / "tests" / "_torch_dryrun_child.py"
ARCHS = ("chatglm3-6b", "mamba2-2.7b", "qwen3-moe-235b-a22b")
# reference moment bytes beyond moments placed as their params (see above)
MOMENT_SPEC_GAP = {"chatglm3-6b": 0, "mamba2-2.7b": 16384,
                   "qwen3-moe-235b-a22b": 0}
# per-rank flops of a smoke train step: port / reference within this
# factor either way (see above)
FLOPS_FACTOR = 1.25

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math, re, sys
import jax
from repro.configs.base import InputShape
from repro.configs.registry import get_smoke_config
from repro.launch import steps as S

names = ("pod", "data", "model")
try:
    from jax.sharding import AxisType
    mesh = jax.make_mesh((2, 2, 2), names, axis_types=(AxisType.Auto,) * 3)
except ImportError:
    mesh = jax.make_mesh((2, 2, 2), names)


def dot_flops(hlo):
    # 2 x output elements x contracted size, over the dots of the HLO
    shapes, total = {}, 0
    for line in hlo.splitlines():
        m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = \w+\[([\d,]*)\]\S* "
                     r"(\w+)\((.*)", line)
        if not m:
            continue
        name, dims, op, rest = m.groups()
        shapes[name] = [int(d) for d in dims.split(",") if d]
        if op == "dot":
            lhs = shapes[re.findall(r"%([\w.\-]+)", rest)[0]]
            axes = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            total += 2 * math.prod(shapes[name]) * math.prod(
                lhs[int(i)] for i in axes.group(1).split(",") if i)
    return total


def nbytes(tree):
    return sum(math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(tree))


out = {}
for arch in sys.argv[1:]:
    cfg = get_smoke_config(arch)
    with mesh:
        step, opt = S.make_train_step(cfg, mesh)
        ps = S.params_struct(cfg, mesh)
        os_ = S.opt_state_struct(cfg, mesh, opt)
        batch = S.input_specs(cfg, InputShape("smoke_train", 64, 8, "train"),
                              mesh)
        mem = jax.jit(step).lower(ps, os_, batch).compile().memory_analysis()
        cache = S.cache_specs_struct(
            cfg, InputShape("smoke_decode", 64, 8, "decode"), mesh)
        # every layer counted: XLA's cost analysis counts a scanned
        # layer stack's loop body once
        cfg_u = dataclasses.replace(cfg, unroll_layers=True)
        step_u, _ = S.make_train_step(cfg_u, mesh)
        compiled = jax.jit(step_u).lower(ps, os_, batch).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
    out[arch] = {"argument_bytes": mem.argument_size_in_bytes,
                 "params": nbytes(ps), "opt_state": nbytes(os_),
                 "batch": nbytes(batch),
                 "int32_scalars": sum(1 for x in jax.tree.leaves(os_)
                                      if x.shape == ()),
                 "moment_leaves": len(jax.tree.leaves(os_["m"])),
                 "cache": nbytes(cache), "flops": cost["flops"],
                 "dot_flops": dot_flops(compiled.as_text())}
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


def _child(job, out, *extra):
    return subprocess.Popen([sys.executable, str(CHILD), job, str(out),
                             *extra], env=_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's numbers and the port children's records, the
    processes run side by side."""
    out = tmp_path_factory.mktemp("dryrun")
    ref = subprocess.Popen([sys.executable, "-c", REF, *ARCHS],
                           env=dict(_env(), JAX_PLATFORMS="cpu"), cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    kids = {f"smoke_{a}": _child("smoke", out, a) for a in ARCHS}
    kids["synthetic"] = _child("synthetic", out)
    kids["cli"] = _child("cli", out)
    res = {}
    try:
        for name, p in kids.items():
            log = p.communicate(timeout=900)[0].decode()
            assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
            res[name] = json.loads((out / f"{name}.json").read_text())
        stdout, stderr = ref.communicate(timeout=900)
        assert ref.returncode == 0, stderr[-4000:]
        res["ref"] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in list(kids.values()) + [ref]:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_train_argument_bytes_match_reference(runs, arch):
    ref, rec = runs["ref"][arch], runs[f"smoke_{arch}"]["train"]
    parts = rec["memory"]["argument_parts"]
    # XLA's argument size is the structs' shard bytes
    assert ref["argument_bytes"] == (ref["params"] + ref["opt_state"]
                                     + ref["batch"])
    assert parts["params"] == ref["params"]
    assert parts["batch"] == ref["batch"]
    # adam's two moments, each placed as its parameter
    assert ref["moment_leaves"] > 0
    assert parts["opt_state"] == 2 * parts["params"]
    gap = ref["opt_state"] - 4 * ref["int32_scalars"] - parts["opt_state"]
    assert gap == MOMENT_SPEC_GAP[arch]
    assert rec["memory"]["argument_bytes"] == (
        ref["argument_bytes"] - 4 * ref["int32_scalars"] - gap)
    if arch == "chatglm3-6b":
        assert ref["argument_bytes"] == 1_352_708
        assert parts == {"params": 450_560, "opt_state": 901_120,
                         "batch": 1_024}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_match_reference(runs, arch):
    """Per-rank flops of the smoke train step against the reference's
    compiled ``cost_analysis()["flops"]`` per device, within FLOPS_FACTOR
    either way (see the module docstring for the gap, op by op)."""
    ref = runs["ref"][arch]
    rec = runs[f"smoke_{arch}"]["train"]
    ratio = rec["cost"]["flops"] / ref["flops"]
    assert 1 / FLOPS_FACTOR <= ratio <= FLOPS_FACTOR, (
        f"{arch}: port {rec['cost']['flops']:.4e} vs reference "
        f"{ref['flops']:.4e}, its dots {ref['dot_flops']:.4e} "
        f"(torch {rec['torch']})")
    # the reference's count holds its dot products and elementwise ops
    assert 0 < ref["dot_flops"] <= ref["flops"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_records_sharded_collectives(runs, arch):
    rec = runs[f"smoke_{arch}"]["train"]
    col = rec["collectives"]
    assert col["all-gather"]["count"] > 0 and col["all-gather"]["bytes"] > 0
    assert (col["reduce-scatter"]["count"] > 0
            and col["reduce-scatter"]["bytes"] > 0)
    assert col["collective-permute"]["count"] == 0
    assert rec["cost"]["flops"] > 0
    mem = rec["memory"]
    # the step returns new params and moments (the loss is 4 bytes)
    assert mem["output_bytes"] == mem["argument_bytes"] - \
        mem["argument_parts"]["batch"] + 4
    assert mem["temp_bytes"] >= mem["output_bytes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_runs_and_cache_bytes_match_reference(runs, arch):
    rec = runs[f"smoke_{arch}"]["decode"]
    parts = rec["memory"]["argument_parts"]
    assert parts["cache"] == runs["ref"][arch]["cache"]
    assert parts["params"] == runs["ref"][arch]["params"]
    assert rec["memory"]["output_bytes"] > 0 and rec["cost"]["flops"] > 0


def test_hfl_step_all_reduces_over_pod(runs):
    rec = runs["smoke_chatglm3-6b"]["hfl"]
    ar = rec["collectives"]["all-reduce"]
    assert ar["by_axis"].get("pod", 0) > 0
    # pod-stacked params: each rank holds one pod's block of the params
    train = runs["smoke_chatglm3-6b"]["train"]["memory"]["argument_parts"]
    assert rec["memory"]["argument_parts"]["params"] == train["params"]
    assert rec["memory"]["output_bytes"] == train["params"]


def _only_all_gather(col):
    return all(col[k]["count"] == 0 for k in
               ("all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"))


def test_synthetic_matmul_exact(runs):
    """x's sequence split over model: one all-gather of x. torch 2.11's
    DTensor refuses to flatten a sequence-sharded x; there the refusal
    is what the test holds."""
    syn = runs["synthetic"]
    seq = syn["seq"]
    if "refused" in seq:
        assert "flatten" in seq["refused"]
        assert tuple(int(v) for v in syn["torch"].split(".")[:2]) < (2, 13)
    else:
        assert seq["local"] == [32, 128, 856]
        assert seq["flops"] == 2 * (32 * 128) * 856 * 4096
        ag = seq["collectives"]["all-gather"]
        assert ag == {"count": 1, "bytes": 32 * 128 * 4096 * 4,
                      "by_axis": {"model": 1}}
        assert _only_all_gather(seq["collectives"])
    # 8 storages of 4 KiB at the peak; after the first 4 die one of them
    # stays alive through a view
    assert syn["plain"] == [8 * 4096, 5 * 4096, 0]


def test_synthetic_contraction_split_exact(runs):
    """x's hidden (contraction) dim split over model: one all-gather of
    w over model, local (32, 128, 256) x (256, 13696), a partial sum over
    model; the same on torch 2.11 and 2.13."""
    hid = runs["synthetic"]["hidden"]
    assert hid["local"] == [32, 128, 13696]
    assert hid["placements"] == ["Shard(dim=0)", "Replicate()",
                                 "Partial(sum)"]
    assert hid["flops"] == 2 * (32 * 128) * 13696 * 256
    assert hid["collectives"]["all-gather"] == {
        "count": 1, "bytes": 4096 * 13696 * 4, "by_axis": {"model": 1}}
    assert _only_all_gather(hid["collectives"])


@pytest.mark.parametrize("job", [f"smoke_{a}" for a in ARCHS]
                         + ["synthetic", "cli"])
def test_no_card_and_meta_only(runs, job):
    r = runs[job]
    assert r["cuda_initialized"] is False
    if job != "synthetic":
        assert r["leaf_devices"] == ["meta"]


def test_cli_writes_caches_and_forces(runs):
    c = runs["cli"]
    (first,) = c["first"]
    assert (first["arch"], first["shape"], first["mesh"]) == (
        "chatglm3-6b", "decode_32k", "16x16")
    for k in ("memory", "cost", "collectives", "trace_s", "family",
              "params", "active_params", "sliding_window"):
        assert k in first, k
    assert c["again"] == []                       # cached
    (forced,) = c["forced"]
    assert forced["memory"] == first["memory"]
    (hfl,) = c["hfl"]
    assert (hfl["shape"], hfl["mesh"]) == ("train_4k+hfl", "2x16x16")
    assert hfl["collectives"]["all-reduce"]["by_axis"].get("pod", 0) > 0
    keys = [(r["arch"], r["shape"], r["mesh"]) for r in c["stored"]]
    assert keys == [("chatglm3-6b", "decode_32k", "16x16"),
                    ("chatglm3-6b", "train_4k+hfl", "2x16x16")]


SLOW_ARCHS = ("chatglm3-6b", "qwen3-moe-235b-a22b", "mamba2-2.7b",
              "jamba-1.5-large-398b", "musicgen-medium", "internvl2-26b")


@pytest.mark.slow
@pytest.mark.parametrize("arch", SLOW_ARCHS)
def test_six_arch_smoke_matrix(tmp_path, arch):
    """``tests/test_dryrun_smoke.py``'s matrix: every arch's smoke train
    and decode steps trace on the (2, 2, 2) mesh."""
    p = _child("smoke", tmp_path, arch)
    log = p.communicate(timeout=1200)[0].decode()
    assert p.returncode == 0, log[-4000:]
    res = json.loads((tmp_path / f"smoke_{arch}.json").read_text())
    for kind in ("train", "decode"):
        assert res[kind]["cost"]["flops"] > 0
        assert res[kind]["memory"]["argument_bytes"] > 0


@pytest.mark.slow
@pytest.mark.parametrize("flags", [["--shape", "train_4k"], ["--hfl-step"]])
def test_cli_full_width(tmp_path, flags):
    """The CLI at chatglm3-6b's full width on 256 (512) fake ranks."""
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "chatglm3-6b", *flags, "--out", str(out)], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (rec,) = json.loads(out.read_text())
    assert "error" not in rec
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
