"""The registry's decoders as HFL payloads (sequence classifiers over
``make_seq_dataset``) in the port's engines, against ``repro``.

World: the reference's ``tests/test_model_zoo.py`` ``_seq_world``
(N=8 devices, M=2 edges, H=4, ``seqcls_syn`` 240/64 with ``vocab_size =
min(257, smoke vocab)``, 6-10 samples a device), IKC over K=2 clusters,
geo assignment, lr 0.3, 25-step allocations. The port starts from the
reference's initial weights, Algorithm-2 labels, crop offsets and int8
draws (torch cannot replay ``jax.random``); scheduling and assignment
are numpy on both sides.

Tolerances:

- ``make_seq_dataset``: bitwise. The flat keys of every arch's payload
  sort in ``jax.tree_util`` leaf order, and ``convert`` round trips are
  exact.
- the IKC mini model's crops: bitwise; its trained weight vectors atol
  1e-6 (f32 sums in another order).
- one ``HFLFramework`` round per ``HFL_SMOKE_ARCHS`` payload: cohorts,
  assignments, ``msg_bits`` and the payload's bits exact, T_i/E_i rtol
  1e-5, accuracy within one test sample, params atol 1e-5 (25 GD steps
  at lr 0.3 through SSD, MoE routing and attention; measured at most
  1e-6, and the ReLU-free payloads have no Algorithm-1 kinks on this
  world, but an MoE top-k near-tie could move one token's expert).
- one int8 round on the qwen3-moe payload, at L=Q=2 as
  ``tests/test_torch_compression.py`` runs its compressed rounds, held
  as that file holds them, by the share of elements that differ
  (params: <= 1e-3 of them by more than 1e-5; residuals: <= 5e-3 by
  more than 1e-7 + 1e-2·|reference|; none by two int8 quanta). Measured:
  1.3e-4, 3.8e-3 (device) and 8.1e-4 (edge). The flips come from
  ulp-level training differences: an RMS-norm scale near 1.0 moves by
  ~1e-4 a round, so its delta carries an f32 rounding of ~6e-8, a few
  percent of its int8 quantum. At the default L=Q=5 the flips of one
  hop feed the next and the device-residual share reaches 4.9e-2.
- a 2-lane ``SweepRunner`` round of the mamba2 payload: as
  ``tests/test_torch_sweep.py`` holds a host-loop run.
- an always-on ``AsyncHFLEngine`` round of the mamba2 payload: as
  ``tests/test_torch_async_engine.py`` holds a record (accounting exact,
  prices rtol 1e-5, accuracy within one test sample), params atol 1e-5
  as the framework round above.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro.configs import registry as jreg
from repro.core import compression as jcomp
from repro.core import sweep as jsw
from repro.core.async_engine import AsyncConfig as JAsyncConfig
from repro.core.async_engine import AsyncHFLEngine as JAsyncEngine
from repro.core.framework import FrameworkConfig as JConfig
from repro.core.framework import HFLFramework as JFramework
from repro.core.scheduling.device_clustering import \
    auxiliary_weight_vectors as j_aux_vectors
from repro.models import seq_classifier as jseqc
from repro.models.spec import _seq_mini_preprocess as j_seq_crop
from repro_torch.configs import registry as treg
from repro_torch.convert import (flatten_params, params_from_numpy,
                                 params_to_numpy, unflatten_params)
from repro_torch.core import async_engine as tae
from repro_torch.core import compression as tcomp
from repro_torch.core import sweep as tsw
from repro_torch.core.framework import FrameworkConfig as TConfig
from repro_torch.core.framework import HFLFramework as TFramework
from repro_torch.core.hfl import pad_device_data
from repro_torch.core.scheduling.device_clustering import \
    auxiliary_weight_vectors as t_aux_vectors
from repro_torch.models import seq_classifier as tseqc
from repro_torch.models.spec import FlatApply
from test_torch_compression import (PARAM_ATOL, PARAM_SHARE, RESID_ATOL,
                                    RESID_RTOL, RESID_SHARE,
                                    _assert_mostly_close, _quantum,
                                    _reference_noise)
from test_torch_async_engine import _assert_record
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sweep import _assert_run_matches

N, M, H, K = 8, 2, 4, 2
N_TEST = 64
SEQ_ARCHS = [a for a in treg.HFL_SMOKE_ARCHS if a != "hfl-cnn"]
KW = dict(scheduler="ikc", assigner="geo", H=H, K=K, lr=0.3, alloc_steps=25,
          max_iters=1, seed=0)
PARAM_ATOL_ROUND = 1e-5


def _vocab(arch):
    return min(257, jreg.get_smoke_config(arch).vocab_size)


def _world(cm, data, arch, seed=0, **sp_kw):
    sp = cm.SystemParams(n_devices=N, n_edges=M, **sp_kw)
    pop = (cm.sample_population(sp, seed=seed) if cm is jcm
           else cm.sample_population(sp, seed=seed, device="cpu"))
    X, y, Xt, yt = data.make_seq_dataset(n_train=240, n_test=N_TEST,
                                         seed=seed, vocab_size=_vocab(arch))
    fed = data.partition_noniid(X, y, Xt, yt, n_devices=N,
                                size_range=(6, 10), seed=seed)
    return sp, pop, fed


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [{}, dict(seq_len=24), dict(vocab_size=97),
                                dict(n_classes=4, seq_len=8)])
def test_make_seq_dataset_bitwise(kw):
    want = jdata.make_seq_dataset(n_train=300, n_test=50, seed=3, **kw)
    got = tdata.make_seq_dataset(n_train=300, n_test=50, seed=3, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    spec = tdata.SEQ_DATASETS["seqcls_syn"]
    np.testing.assert_array_equal(
        tdata.class_token_dists(spec, 5),
        jdata.synthetic.class_token_dists(jdata.SEQ_DATASETS["seqcls_syn"],
                                          5))


# ------------------------------------------------------ payload layout

@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_flat_keys_follow_jax_leaf_order(arch):
    """The flat payload's sorted keys walk the reference's leaves in
    ``jax.tree.leaves`` order; the port's own init has the same keys and
    shapes; flattening and unflattening are exact round trips."""
    fed = _world(jcm, jdata, arch)[2]
    jp = _np_tree(jreg.get_hfl_spec(arch).init_fn(jax.random.PRNGKey(0),
                                                  fed))
    flat = flatten_params(jp)
    assert list(flat) == sorted(flat)
    leaves = jax.tree.leaves(jp)
    assert len(flat) == len(leaves)
    assert all(a is b for a, b in zip(flat.values(), leaves))
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(flat) == paths          # super-blocks < 10: no padding
    back = unflatten_params(flat)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert all(a is b for a, b in zip(jax.tree.leaves(back), leaves))
    assert flatten_params(flat) == flat            # flat stays flat
    tp = treg.get_hfl_spec(arch).init_fn(torch.Generator().manual_seed(0),
                                         _world(tcm, tdata, arch)[2], "cpu")
    assert list(tp) == list(flat)
    assert [tuple(v.shape) for v in tp.values()] == \
        [v.shape for v in flat.values()]
    round_trip = params_to_numpy(params_from_numpy(flat, "cpu"))
    for k, v in flat.items():
        np.testing.assert_array_equal(round_trip[k], v)


def test_registry_resolves_every_payload():
    assert treg.HFL_SMOKE_ARCHS == jreg.HFL_SMOKE_ARCHS
    assert list(treg.ARCH_IDS) == list(jreg.ARCH_IDS)
    for arch in treg.ARCH_IDS:
        spec = treg.get_hfl_spec(arch)
        assert spec is treg.get_hfl_spec(arch)
        assert spec.family == jreg.get_hfl_spec(arch).family
        assert isinstance(spec.apply_fn, FlatApply)
        assert spec.apply_fn == treg.get_hfl_spec(arch).apply_fn
        cfg = spec.apply_fn.apply.cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jreg.get_hfl_spec(arch).apply_fn.cfg)
        assert cfg.dtype == "float32" and not cfg.remat
    with pytest.raises(KeyError):
        treg.get_hfl_spec("no-such-arch")


# --------------------------------------------------------- IKC mini model

def test_seq_mini_crops_and_weight_vectors_match_reference():
    """The reference's crop offsets (one ``jax.random.randint`` a device)
    injected into the port's crop; then L=5 local GD steps of the mini
    model ξ on every device."""
    arch = "mamba2-2.7b"
    sp, _, fed = _world(jcm, jdata, arch)
    tfed = _world(tcm, tdata, arch)[2]
    X, y, mask = pad_device_data(tfed, device="cpu")
    key = jax.random.PRNGKey(4)
    S = X.shape[2]
    crop = min(S, tseqc.SEQ_MINI_CROP)
    offsets = [int(jax.random.randint(k, (), 0, S - crop + 1))
               for k in jax.random.split(key, N)]
    jcrop = np.asarray(j_seq_crop(X.numpy(), key))
    tcrop = tseqc.seq_mini_preprocess(X, offsets)
    np.testing.assert_array_equal(tcrop.numpy(), jcrop)
    own = tseqc.seq_mini_preprocess(
        X, tseqc.seq_crop_offsets(torch.Generator().manual_seed(0), N, S))
    assert own.shape == tcrop.shape
    mini = jseqc.seq_mini_init(jax.random.PRNGKey(1), 269, fed.n_classes)
    want = j_aux_vectors(jseqc.seq_mini_apply, mini, jcrop, y.numpy(),
                         mask.numpy(), sp.L, 0.3)
    got = t_aux_vectors(tseqc.seq_mini_apply,
                        params_from_numpy(_np_tree(mini), "cpu"), tcrop, y,
                        mask, sp.L, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ------------------------------------------------------ framework round

def _record(obj, name, log):
    real = getattr(obj, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        log.append(np.array(out[0] if isinstance(out, tuple) else out))
        return out
    setattr(obj, name, spy)


def _codec_sp(codec):
    """A compressed round runs L=Q=2, as ``tests/test_torch_compression.py``
    does (see the module docstring)."""
    return {} if codec == "none" else dict(L=2, Q=2)


def _run_reference(arch, codec="none"):
    """One reference round on the arch's world; what the port is held
    to."""
    jcfg = JConfig(arch=arch, compression=jcomp.CompressionConfig(
        codec=codec), **KW)
    jf = JFramework(*_world(jcm, jdata, arch, **_codec_sp(codec)), jcfg)
    out = dict(labels=np.asarray(jf.scheduler.state.clusters),
               init=_np_tree(jf.model_params), model_bits=jf.model_bits,
               uplink_bits=jf.uplink_bits, stats=dict(jf.clustering_stats))
    scheds, assigns = [], []
    _record(jf.scheduler, "schedule", scheds)
    _record(jf.assigner, "assign", assigns)
    out["rec"] = jf.run_round(1)
    out.update(scheds=scheds, assigns=assigns,
               params=flatten_params(_np_tree(jf.model_params)))
    if codec != "none":
        out["resid"] = tuple(flatten_params(_np_tree(r))
                             for r in jf.codec_state)
    return out


@pytest.fixture(scope="module")
def reference():
    """One reference run per (arch, codec), shared by this module."""
    return functools.lru_cache(maxsize=None)(_run_reference)


def _port(arch, ref, codec="none", **kw):
    sp, pop, fed = _world(tcm, tdata, arch, **_codec_sp(codec))
    tf = TFramework(sp, pop, fed,
                    TConfig(arch=arch, device="cpu",
                            compression=tcomp.CompressionConfig(codec=codec),
                            **KW, **kw),
                    init_params=ref["init"], labels=ref["labels"],
                    **({} if codec == "none" else dict(
                        codec_noise=_reference_noise(
                            jcomp.CompressionConfig(codec=codec), KW["seed"],
                            sp.Q,
                            sorted(flatten_params(ref["init"]))))))
    scheds, assigns = [], []
    _record(tf.scheduler, "schedule", scheds)
    _record(tf.assigner, "assign", assigns)
    assert tf.model_bits == ref["model_bits"]
    assert tf.uplink_bits == ref["uplink_bits"]
    assert tf.clustering_stats["aux_bits"] == ref["stats"]["aux_bits"]
    assert tf.clustering_stats["ari"] == ref["stats"]["ari"]
    rec = tf.run_round(1)
    np.testing.assert_array_equal(scheds[-1], ref["scheds"][-1])
    np.testing.assert_array_equal(assigns[-1], ref["assigns"][-1])
    rj = ref["rec"]
    for k in ("T_i", "E_i", "obj_i"):
        np.testing.assert_allclose(rec[k], rj[k], rtol=1e-5, err_msg=k)
    for k in ("msg_bits", "uplink_bytes", "H", "codec"):
        assert rec[k] == rj[k], k
    assert abs(rec["acc"] - rj["acc"]) <= 1.0 / N_TEST + 1e-12
    return tf


@pytest.mark.parametrize("agg_kernel", [False, True])
@pytest.mark.parametrize("arch", SEQ_ARCHS)
def test_framework_round_matches_reference(reference, arch, agg_kernel):
    """One IKC/geo round of the payload; with ``agg_kernel`` the port
    runs the grouped K1 dispatcher (its plain version on the CPU)."""
    ref = reference(arch)
    tf = _port(arch, ref, agg_kernel=agg_kernel)
    final = params_to_numpy(tf.model_params)
    assert list(final) == list(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(final[k], v, rtol=1e-5,
                                   atol=PARAM_ATOL_ROUND, err_msg=k)
    # the round trained every leaf (the constant-init SSM vectors and
    # the norms included)
    init = flatten_params(ref["init"])
    assert all(not np.array_equal(final[k], init[k]) for k in init)


def test_int8_round_on_moe_payload(reference, monkeypatch):
    """One int8 round of the qwen3-moe payload with the reference's
    draws, held by the share of elements that differ."""
    arch = "qwen3-moe-235b-a22b"
    ref = reference(arch, "int8")
    largest = [0.0]
    real = tcomp.encode_leaf

    def spy(cfg, delta, resid, u=None):
        out = real(cfg, delta, resid, u)
        largest[0] = max(largest[0], _quantum(cfg, delta + resid, out[1]))
        return out
    monkeypatch.setattr(tcomp, "encode_leaf", spy)
    tf = _port(arch, ref, "int8", agg_kernel=True)
    cap = 2.0 * largest[0]
    assert 0.0 < cap < 0.05
    final = params_to_numpy(tf.model_params)
    _assert_mostly_close(final, ref["params"], PARAM_ATOL, 0.0, PARAM_SHARE,
                         cap, "params")
    for got, want, what in zip((params_to_numpy(r) for r in tf.codec_state),
                               ref["resid"], ("device", "edge")):
        assert list(got) == list(want)
        _assert_mostly_close(got, want, RESID_ATOL, RESID_RTOL, RESID_SHARE,
                             cap, f"{what} residuals")


# ---------------------------------------------------------------- sweep

def test_two_lane_sweep_round_matches_reference():
    arch = "mamba2-2.7b"
    worlds = {pkg: [_world(cm, data, arch, seed=s) for s in (0, 1)]
              for pkg, cm, data in ((jsw, jcm, jdata), (tsw, tcm, tdata))}
    kw = dict(lr=0.3, alloc_steps=25, arch=arch)
    jr = jsw.SweepRunner(worlds[jsw][0][0],
                         [w[1:] for w in worlds[jsw]], **kw)
    init = [jax.tree.map(lambda v, s=s: np.asarray(v[s]), jr.params0)
            for s in (0, 1)]
    tr = tsw.SweepRunner(worlds[tsw][0][0], [w[1:] for w in worlds[tsw]],
                         init_params=init, device="cpu", agg_kernel=True,
                         **kw)
    assert tr.model_bits == jr.model_bits

    def scheds(pkg, runner):
        return [pkg.build_scheduler("fedavg", runner.feds[s], runner.sp, H,
                                    seed=s, **({} if pkg is jsw
                                               else {"device": "cpu"}))
                for s in (0, 1)]
    j = jr.run(scheds(jsw, jr), 1, assign="geo")
    t = tr.run(scheds(tsw, tr), 1, assign="geo")
    _assert_run_matches(t, j, n_test=N_TEST)


# ---------------------------------------------------------- async engine

def test_async_round_on_ssm_payload_matches_reference():
    arch = "mamba2-2.7b"
    kw = dict(arch=arch, H=H, lr=0.3, alloc_steps=25)
    je = JAsyncEngine(*_world(jcm, jdata, arch), JAsyncConfig(**kw))
    te = tae.AsyncHFLEngine(*_world(tcm, tdata, arch),
                            tae.AsyncConfig(device="cpu", **kw),
                            init_params=_np_tree(je.model_params))
    rt, rj = te.step_round(), je.step_round()
    _assert_record(rt, rj, n_test=N_TEST)
    np.testing.assert_array_equal(te.last_sched, je.last_sched)
    np.testing.assert_array_equal(te.last_assign, je.last_assign)
    got = params_to_numpy(te.model_params)
    for k, v in flatten_params(_np_tree(je.model_params)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                   atol=PARAM_ATOL_ROUND, err_msg=k)
