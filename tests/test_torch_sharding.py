"""The port's sharding rules, sharder and mesh factories against
``repro.parallel`` and ``repro.launch.mesh``, in one process.

* Rules, exactly: ``param_specs``, ``cache_specs``, ``act_rules``,
  ``fit_spec``, ``batch_axes`` and the lane helpers give the reference's
  specs on 16x16 and 2x16x16 mesh stand-ins (the reference's
  ``AbstractMesh``; the port's own), for every registry arch at its full
  config. Both packages' rules read the port's own ``params_struct`` and
  ``cache_specs_struct`` trees, the reference's as
  ``jax.ShapeDtypeStruct``s of the same shapes
  (``tests/test_torch_train_structs.py`` holds those trees equal to the
  reference's), so no second ``eval_shape`` of qwen3-moe's ``init`` runs.
* ``placements``: tuple entries (the first axis major) and dropped
  (non-dividing) dimensions, exactly.
* MoE dispatch chunking: the port's ``moe_apply`` under a sharder of
  ``data_chunks`` 1, 2 and 4 against the reference's with a
  ``NoopSharder`` whose ``data_chunks`` is set alike, qwen3-moe's smoke
  config, the reference's weights and the same inputs (skewed so every
  chunk's capacity drops choices): the output within 1e-5 of max|out|,
  the aux loss rtol 1e-5, the capacity the reference's, and the kept
  choices differing from the one-chunk dispatch.
* What raises: a plain tensor under a ``MeshSharder`` rule, every mesh
  factory and every mesh-sharded step without a process group.
* ``init_group`` on a one-rank torchrun environment (gloo, ``env://``
  on a port the OS picks on localhost), and both CLIs'
  ``--production-mesh`` refusing that one-rank group through it.

The multi-rank behaviour (DTensor steps, the lane-sharded sweep) is in
``tests/test_torch_multirank.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro.parallel import sharding as jshd
from repro.parallel.sharder import NoopSharder as JNoop
from repro_torch.configs import registry as treg
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.convert import params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as TS
from repro_torch.models import moe as tmoe
from repro_torch.parallel import sharding as tshd
from repro_torch.parallel.sharder import MeshSharder, NoopSharder
from test_torch_framework import one_torch_thread  # noqa: F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _meshes(name):
    axes = MESHES[name]
    return (JMesh(tuple(axes.values()), tuple(axes)),
            tshd.AbstractMesh(axes))


def _sds(tree):
    """The port's meta tree as jax.ShapeDtypeStructs (same nesting)."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_sds(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def _spec_leaves(tree):
    """The port's specs in JAX's leaf order (a spec is a tuple: a leaf)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [s for v in tree for s in _spec_leaves(v)]
    return [tree]


def _same_specs(jspecs, tspecs):
    want = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    got = _spec_leaves(tspecs)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert tuple(w) == tuple(g), (w, g)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    params = TS.params_struct(treg.get_config(arch))
    _same_specs(jshd.param_specs(_sds(params), jreg.get_config(arch), jm),
                tshd.param_specs(params, treg.get_config(arch), tm))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_cache_specs_and_act_rules_match_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    for shape in ("decode_32k", "long_500k"):
        tcfg = treg.variant_for_shape(treg.get_config(arch),
                                      INPUT_SHAPES[shape])
        cache = TS.cache_specs_struct(tcfg, INPUT_SHAPES[shape])
        jcfg = jreg.get_config(arch)
        _same_specs(jshd.cache_specs(_sds(cache), jcfg, jm),
                    tshd.cache_specs(cache, tcfg, tm))
    jr = jshd.act_rules(jreg.get_config(arch), jm)
    tr = tshd.act_rules(treg.get_config(arch), tm)
    assert sorted(jr) == sorted(tr)
    for k in jr:
        assert tuple(jr[k]) == tuple(tr[k]), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_spec_batch_axes_and_lanes_match_reference(mesh):
    jm, tm = _meshes(mesh)
    assert tshd.batch_axes(tm) == jshd.batch_axes(jm)
    dp = tshd.batch_axes(tm)
    for shape in [(32, 4096, 128), (1, 8192, 4096), (48, 30, 16),
                  (512, 1, 7)]:
        for spec in [(dp, None, "model"), (dp, "model"), ("model", None),
                     (None, ("data", "model")), ()]:
            want = jshd.fit_spec(jm, shape, jax.sharding.PartitionSpec(*spec))
            assert tuple(tshd.fit_spec(tm, shape, spec)) == tuple(want)
    assert tuple(tshd.lane_spec()) == tuple(jshd.lane_spec())
    assert tuple(tshd.round_lane_spec()) == tuple(jshd.round_lane_spec())
    for n, d in [(5, 8), (8, 8), (9, 8), (1, 1), (3, 2)]:
        assert tshd.pad_lanes(n, d) == jshd.pad_lanes(n, d)


def test_placements_tuples_and_dropped_axes():
    S, R = tshd.Shard, tshd.Replicate
    m = tshd.AbstractMesh({"pod": 2, "data": 16, "model": 16})
    assert tshd.placements(m, tshd.P(("pod", "data"), None, "model")) == (
        S(0), S(0), S(2))
    assert tshd.placements(m, tshd.P(None, "model")) == (R(), R(), S(1))
    # an axis fit_spec drops (48 % 32 != 0 over pod x data) replicates
    spec = tshd.fit_spec(m, (48, 64), tshd.P(("pod", "data"), "model"))
    assert spec == tshd.P(None, "model")
    assert tshd.placements(m, spec) == (R(), R(), S(1))
    # a mesh axis of size 1 splits nothing
    one = tshd.AbstractMesh({"data": 1, "model": 2})
    assert tshd.placements(one, tshd.P("data", "model")) == (R(), S(1))
    with pytest.raises(ValueError, match="order"):
        tshd.placements(m, tshd.P(("data", "pod")))
    with pytest.raises(ValueError, match="two dimensions"):
        tshd.placements(m, tshd.P("model", "model"))
    sh = tshd.lane_sharding(tshd.AbstractMesh({"lane": 4}))
    assert sh.placements == (S(0),)


@pytest.mark.parametrize("gd", [1, 2, 4])
def test_moe_dispatch_chunks_match_reference(gd):
    jc = jreg.get_smoke_config("qwen3-moe-235b-a22b")
    tc = treg.get_smoke_config("qwen3-moe-235b-a22b")
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    # a direction shared by every token skews the routing, so each
    # chunk's capacity binds
    x = (rng.normal(size=(4, 16, jc.d_model))
         + 2 * rng.normal(size=jc.d_model)).astype(np.float32)
    js, ts = JNoop(), NoopSharder()
    js.data_chunks = ts.data_chunks = gd
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jc, sharder=js)
    tout, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tc, sharder=ts)
    jout = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), jout,
                               atol=1e-5 * np.abs(jout).max())
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    r = tmoe.moe_route(tp, torch.from_numpy(x).reshape(64, -1), tc, gd)
    assert r.capacity == jmoe.moe_capacity(64 // gd, jc)
    assert (~r.keep).any()          # capacity binds: the chunking matters
    if gd > 1:
        one = tmoe.moe_route(tp, torch.from_numpy(x).reshape(64, -1), tc)
        assert not torch.equal(one.keep, r.keep)


def test_sharder_rules_and_refusals():
    m = tshd.AbstractMesh({"pod": 2, "data": 4, "model": 2})
    cfg = treg.get_smoke_config("chatglm3-6b")
    sh = MeshSharder(m, tshd.act_rules(cfg, m))
    assert sh.data_chunks == 8 and NoopSharder().data_chunks == 1
    x = torch.zeros(8, 4, 16)
    assert NoopSharder().act(x, "act_resid") is x
    assert sh.act(x, "no such kind") is x            # no rule
    assert sh.act(x, "act_heads") is x               # rank mismatch
    with pytest.raises(TypeError, match="plain"):
        sh.act(x, "act_resid")


def test_meshes_and_sharded_entry_points_need_a_group():
    assert not torch.distributed.is_initialized()
    for make in (tmesh.make_production_mesh, tmesh.make_debug_mesh,
                 tmesh.sweep_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            make(device_type="cpu")
    cfg = treg.get_smoke_config("chatglm3-6b")
    m = tshd.AbstractMesh({"data": 1, "model": 1})
    for make in (lambda: TS.make_train_step(cfg, mesh=m),
                 lambda: TS.make_prefill_step(cfg, mesh=m),
                 lambda: TS.make_serve_step(cfg, mesh=m),
                 lambda: TS.make_hfl_train_step(
                     cfg, mesh=tshd.AbstractMesh(
                         {"pod": 1, "data": 1, "model": 1}))):
        with pytest.raises(RuntimeError, match="process group"):
            make()


def test_no_mesh_steps_are_unchanged():
    """``mesh=None`` is PR 20's one-process path: same loss as calling
    the model directly."""
    cfg = dataclasses.replace(treg.get_smoke_config("chatglm3-6b"),
                              microbatches=1)
    from repro_torch.models import transformer as TT
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    step, opt = TS.make_train_step(cfg)
    _, _, m = step(params, opt.init(params), batch)
    want, _ = TT.loss_fn(params, batch, cfg)
    assert torch.equal(m["loss"], want.detach())


def test_init_group_reads_torchruns_environment(monkeypatch):
    """``init_group`` on a one-rank torchrun environment (gloo on the
    CPU, the store on a port the OS picks on localhost): the group, its
    backend and the device; a second call keeps the group; the debug
    mesh builds on it; and both CLIs' ``--production-mesh``, through the
    real ``init_group``, refuse a group of one rank (the mesh needs
    256)."""
    from repro_torch.launch import serve_lm, train

    dist = torch.distributed
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        assert tmesh.init_group("cpu") == torch.device("cpu")
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        group = dist.group.WORLD
        assert tmesh.init_group("cpu") == torch.device("cpu")
        assert dist.group.WORLD is group
        assert tuple(tmesh.make_debug_mesh(device_type="cpu").shape) == (1, 1)
        argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                "--production-mesh"]
        for mod in (train, serve_lm):
            with pytest.raises(ValueError, match="needs 256 ranks"):
                mod.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
