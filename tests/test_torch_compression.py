"""Uplink codecs (``repro_torch.core.compression``) and compressed
Algorithm-6 rounds against ``repro``.

Codec functions: on identical inputs every one is **bitwise** equal to
the reference (``q``, ``scale``, residual, decoded value, message bits).
The int8 rounding uniforms are the reference's own ``jax.random.uniform``
draws, handed to the port as ``u``.

Whole compressed rounds (``test_compressed_rounds_match_reference``):
two rounds of each codec on the world of ``tests/test_compression.py``,
the port with either aggregation backend and the reference's initial
weights, clustering and int8 draws injected. Its docstring states what
is compared and the tolerances, with the measured flip shares.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cost_model as jcm
import repro.data as jdata
import repro_torch.core.cost_model as tcm
import repro_torch.data as tdata
from repro.core import compression as jcomp
from repro.core.framework import FrameworkConfig as JConfig
from repro.core.framework import HFLFramework as JFramework
from repro_torch.configs.registry import get_hfl_spec
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core.framework import FrameworkConfig as TConfig
from repro_torch.core.framework import HFLFramework as TFramework
from repro_torch.core.hfl import hfl_global_iteration_core, pad_device_data
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)

CODECS = ("bf16_delta", "int8", "topk")
# the paper CNN's four leaves, by size (conv1, conv2, fc1, fc2)
CNN_SHAPES = {"conv1": (5, 75), "conv2": (10500,), "fc1": (452, 224),
              "fc2": (226, 10)}


def _cfgs(codec, **kw):
    """The same codec config in both packages."""
    return (jcomp.CompressionConfig(codec=codec, **kw),
            tcomp.CompressionConfig(codec=codec, **kw))


def _bits(a):
    """Raw bit pattern of a numpy array (so -0.0 != 0.0 and NaNs
    compare by payload)."""
    a = np.asarray(a)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _assert_bitwise(t, j):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t_np = t.view(torch.int16).numpy()
    else:
        t_np = _bits(t.numpy())
    j = np.asarray(j)
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)
    np.testing.assert_array_equal(t_np, _bits(j))


# -------------------------------------------------------------- config

def test_config_matches_reference():
    for bad in (dict(codec="gzip"), dict(codec="topk", topk_frac=0.0),
                dict(codec="int8", topk_frac=1.5)):
        with pytest.raises(ValueError):
            jcomp.CompressionConfig(**bad)
        with pytest.raises(ValueError):
            tcomp.CompressionConfig(**bad)
    assert tcomp.CODECS == jcomp.CODECS
    for codec in tcomp.CODECS:
        j, t = _cfgs(codec)
        assert t.active == j.active
        assert hash(t) == hash(tcomp.CompressionConfig(codec=codec))


# -------------------------------------------------- message accounting

@pytest.mark.parametrize("codec,topk_frac", [
    ("none", 0.05), ("bf16_delta", 0.05), ("int8", 0.05), ("topk", 0.05),
    ("topk", 0.5), ("topk", 1e-6)])
def test_message_bits_exact(codec, topk_frac):
    j, t = _cfgs(codec, topk_frac=topk_frac)
    for shapes in (CNN_SHAPES, {"w": (7, 11), "b": (1,)}):
        jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
        tp = {k: torch.zeros(s) for k, s in shapes.items()}
        got, ref = tcomp.message_bits(t, tp), jcomp.message_bits(j, jp)
        assert type(got) is float and got == ref


def test_init_state_matches_reference():
    j, t = _cfgs("int8")
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in CNN_SHAPES.items()}
    tp = {k: torch.zeros(s) for k, s in CNN_SHAPES.items()}
    js, ts = jcomp.init_state(j, jp, 4), tcomp.init_state(t, tp, 4)
    for k in CNN_SHAPES:
        assert tuple(ts[k].shape) == js[k].shape
        assert ts[k].dtype == torch.float32 and not ts[k].any()
    assert tcomp.init_state(tcomp.CompressionConfig(), tp, 4) is None


# --------------------------------------------------- codec functions

def _rows(seed, R, p):
    x = (0.01 * np.random.default_rng(seed).normal(size=(R, p))).astype(
        np.float32)
    x[0, : p // 3] = 0.0              # exact zeros (top-k ties, -0.0)
    if R > 2:
        x[2] = 0.0                    # an all-zero row: int8's 1e-30 floor
    return x


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("R,p", [(1, 7), (5, 375), (3, 2260)])
def test_encode_decode_rows_bitwise(codec, R, p):
    j, t = _cfgs(codec)
    x = _rows(R * p, R, p)
    key = jax.random.PRNGKey(R * p)
    jq, js = jcomp.encode_rows(j, key, jnp.asarray(x))
    u = torch.from_numpy(np.array(jax.random.uniform(key, x.shape)))
    tq, ts = tcomp.encode_rows(t, torch.from_numpy(x),
                               u if codec == "int8" else None)
    _assert_bitwise(tq, jq)
    _assert_bitwise(ts, js)
    _assert_bitwise(tcomp.decode_rows(t, tq, ts), jcomp.decode_rows(j, jq, js))


def test_int8_needs_noise():
    with pytest.raises(ValueError, match="uniforms"):
        tcomp.encode_rows(tcomp.CompressionConfig(codec="int8"),
                          torch.ones(2, 3))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("error_feedback", [True, False])
def test_encode_leaf_bitwise(codec, error_feedback):
    j, t = _cfgs(codec, error_feedback=error_feedback, topk_frac=0.1)
    delta = _rows(1, 4, 300)
    resid = (0.3 * _rows(2, 4, 300)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jq, js, jr = jcomp.encode_leaf(j, key, jnp.asarray(delta),
                                   jnp.asarray(resid))
    u = torch.from_numpy(np.array(jax.random.uniform(key, delta.shape)))
    tq, ts, tr = tcomp.encode_leaf(t, torch.from_numpy(delta),
                                   torch.from_numpy(resid),
                                   u if codec == "int8" else None)
    for a, b in ((tq, jq), (ts, js), (tr, jr)):
        _assert_bitwise(a, b)


@pytest.mark.parametrize("codec", CODECS)
def test_encode_decode_tree_bitwise(codec):
    """Over a dict, leaf keys split in sorted order as the reference
    flattens it."""
    j, t = _cfgs(codec)
    rng = np.random.default_rng(4)
    delta = {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
             "b": rng.normal(size=(3, 5)).astype(np.float32)}
    resid = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in delta.items()}
    key = jax.random.PRNGKey(11)
    jd, jr = jcomp.encode_decode(j, key, {k: jnp.asarray(v)
                                          for k, v in delta.items()},
                                 {k: jnp.asarray(v) for k, v in resid.items()})
    keys = jax.random.split(key, len(delta))
    names = sorted(delta)

    def noise(name, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(keys[names.index(name)], shape)))
    td, tr = tcomp.encode_decode(t, params_from_numpy(delta, "cpu"),
                                 params_from_numpy(resid, "cpu"), noise)
    for k in delta:
        _assert_bitwise(td[k], jd[k])
        _assert_bitwise(tr[k], jr[k])
    d = {"w": torch.ones(2, 3)}
    r = {"w": torch.zeros(2, 3)}
    out = tcomp.encode_decode(tcomp.CompressionConfig(), d, r)
    assert out[0] is d and out[1] is r


def test_round_noise_is_stateless_and_distinct():
    cfg = tcomp.CompressionConfig(codec="int8", seed=3)
    a = tcomp.round_noise(cfg, 7, 2, "cpu")(1, "fc1", (4, 6))
    b = tcomp.round_noise(cfg, 7, 2, "cpu")(1, "fc1", (4, 6))
    assert torch.equal(a, b)
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert bool(((a >= 0) & (a < 1)).all())
    for other in (tcomp.round_noise(cfg, 7, 3, "cpu")(1, "fc1", (4, 6)),
                  tcomp.round_noise(cfg, 8, 2, "cpu")(1, "fc1", (4, 6)),
                  tcomp.round_noise(cfg, 7, 2, "cpu")(0, "fc1", (4, 6)),
                  tcomp.round_noise(cfg, 7, 2, "cpu")(1, "fc2", (4, 6)),
                  tcomp.round_noise(tcomp.CompressionConfig(codec="int8"),
                                    7, 2, "cpu")(1, "fc1", (4, 6))):
        assert not torch.equal(a, other)


# ------------------------------------------------------- whole rounds

N, M, H, K = 8, 3, 6, 3
KW = dict(H=H, K=K, alloc_steps=30, scheduler="ikc", assigner="geo", seed=0)
# Parameters: at most PARAM_SHARE of the elements may differ by more than
# PARAM_ATOL. Residuals: at most RESID_SHARE of the elements may differ
# by more than RESID_ATOL + RESID_RTOL·|reference| (relative, because a
# bf16 residual is below half an ulp of its element: ~1e-7 here).
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
RESID_ATOL, RESID_RTOL, RESID_SHARE = 1e-7, 1e-2, 5e-3


def _world(cm, data):
    sp = cm.SystemParams(n_devices=N, n_edges=M, d_range=(50, 90), L=2, Q=2)
    pop = (cm.sample_population(sp, seed=0) if cm is jcm
           else cm.sample_population(sp, seed=0, device="cpu"))
    X, y, Xt, yt = data.make_dataset("fmnist_syn", n_train=240, n_test=100,
                                     seed=0)
    fed = data.partition_noniid(X, y, Xt, yt, n_devices=N,
                                size_range=(20, 40), seed=0)
    return sp, pop, fed


def _reference_noise(cfg, lane_seed, Q, names):
    """The reference's int8 draws as a port noise factory: round_key ->
    split(Q+1) -> per hop split(n_leaves) -> uniform((R, p))."""
    def factory(i):
        hops = jax.random.split(jcomp.round_key(cfg, lane_seed, i), Q + 1)

        def draw(hop, name, shape):
            ks = jax.random.split(hops[hop], len(names))
            return torch.from_numpy(np.array(
                jax.random.uniform(ks[names.index(name)], shape)))
        return draw
    return factory


def _record(obj, name, log):
    """Wrap ``obj.name`` to append its (first) result to ``log``."""
    real = getattr(obj, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        log.append(np.array(out[0] if isinstance(out, tuple) else out))
        return out
    setattr(obj, name, spy)


def _run_reference(codec):
    """Two reference rounds with ``codec``; what the port is held to."""
    jf = JFramework(*_world(jcm, jdata),
                    JConfig(compression=_cfgs(codec)[0], **KW))
    labels = np.asarray(jf.scheduler.state.clusters)
    init = {k: np.asarray(v) for k, v in jf.model_params.items()}
    scheds, assigns = [], []
    _record(jf.scheduler, "schedule", scheds)
    _record(jf.assigner, "assign", assigns)
    recs = [jf.run_round(i) for i in (1, 2)]
    dev_resid, edge_resid = jf.codec_state
    return dict(labels=labels, init=init, recs=recs, scheds=scheds,
                assigns=assigns, uplink_bits=jf.uplink_bits,
                params={k: np.asarray(v) for k, v in jf.model_params.items()},
                dev_resid={k: np.asarray(v) for k, v in dev_resid.items()},
                edge_resid={k: np.asarray(v) for k, v in edge_resid.items()})


@pytest.fixture(scope="module")
def reference():
    """One reference run per codec, shared by the tests of this module."""
    return functools.lru_cache(maxsize=None)(_run_reference)


def _quantum(cfg, x, scale):
    """The size of one codec step at the message x: the int8 scale, one
    bf16 ulp of the largest element, or the top-k boundary magnitude."""
    if cfg.codec == "int8":
        return float(scale.max())
    if cfg.codec == "bf16_delta":
        return float(x.abs().max()) * 2.0 ** -7
    k = tcomp._topk_k(cfg, x.shape[1])
    return float(torch.topk(x.abs(), k, dim=1).values[:, -1].max())


def _assert_mostly_close(got, want, atol, rtol, share, cap, what):
    """At most ``share`` of all elements differ by more than
    ``atol + rtol·|want|``, and none by more than ``cap``."""
    diff = np.concatenate([np.abs(got[k] - v).ravel()
                           for k, v in want.items()])
    ref = np.concatenate([np.abs(v).ravel() for v in want.values()])
    frac = float((diff > atol + rtol * ref).mean())
    assert frac <= share, f"{what}: {frac:.2e} of the elements differ"
    assert diff.max() <= cap, f"{what}: max |diff| {diff.max():.3e} > {cap}"


@pytest.mark.parametrize("agg_kernel", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_compressed_rounds_match_reference(reference, monkeypatch, codec,
                                           agg_kernel):
    """Two compressed rounds against ``repro``: cohorts and assignments
    identical, T_i/E_i to rtol 1e-5 (the cost does not depend on
    training), ``msg_bits`` and ``uplink_bytes`` exactly equal.

    The two packages train to ~1e-7 of each other (BLAS vs XLA), and the
    codecs are discontinuous (``floor``, round-to-nearest-even, the k-th
    magnitude), so a 1e-7 difference can flip one quantum of one element:
    140 of 3 431 490 int8 ``q`` elements differ (4.1e-5), 2 788 bf16
    elements (8.1e-4) and 4 top-k keep positions (1.2e-6). So the final
    state is held by the share of elements that differ:

    - params: at most 1e-3 of them by more than 1e-5 (measured 1.3e-4
      int8, 0 bf16, 2.6e-5 top-k);
    - device and edge error-feedback residuals: at most 5e-3 of them by
      more than 1e-7 + 1e-2·|reference| (measured at most 2.4e-4 int8,
      1.1e-3 bf16, 5.1e-5 top-k);
    - no element by more than two codec quanta at the largest message the
      port sent (the int8 scale, one bf16 ulp of the largest element, the
      top-k boundary magnitude: 2.8e-4, 2.8e-4 and 7.0e-3 here).

    Error feedback off in the port, or the cohort residuals scattered
    back to a permuted cohort, gives shares of 2e-2 to 0.34 and fails
    for every codec (bf16's permuted scatter only in the residuals).
    """
    jcfg, tcfg = _cfgs(codec)
    ref = reference(codec)
    largest = [0.0]
    real = tcomp.encode_leaf

    def spy(cfg, delta, resid, u=None):
        out = real(cfg, delta, resid, u)
        largest[0] = max(largest[0], _quantum(cfg, delta + resid, out[1]))
        return out
    monkeypatch.setattr(tcomp, "encode_leaf", spy)

    sp, pop, fed = _world(tcm, tdata)
    tf = TFramework(sp, pop, fed,
                    TConfig(agg_kernel=agg_kernel, device="cpu",
                            compression=tcfg, **KW),
                    init_params=ref["init"], labels=ref["labels"],
                    codec_noise=_reference_noise(jcfg, KW["seed"], sp.Q,
                                                 sorted(ref["init"])))
    assert tf.uplink_bits == ref["uplink_bits"]
    scheds, assigns = [], []
    _record(tf.scheduler, "schedule", scheds)
    _record(tf.assigner, "assign", assigns)
    for i, rj in zip((1, 2), ref["recs"]):
        rt = tf.run_round(i)
        np.testing.assert_array_equal(scheds[-1], ref["scheds"][i - 1])
        np.testing.assert_array_equal(assigns[-1], ref["assigns"][i - 1])
        for k in ("T_i", "E_i", "obj_i"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, err_msg=k)
        for k in ("msg_bits", "uplink_bytes", "H", "codec"):
            assert rt[k] == rj[k], k
        assert set(rt["seconds"]) == {"schedule", "assign", "allocate",
                                      "train", "aggregate", "eval"}

    cap = 2.0 * largest[0]
    assert 0.0 < cap < 0.05
    final = params_to_numpy(tf.model_params)
    dev_resid, edge_resid = (params_to_numpy(r) for r in tf.codec_state)
    for got, want in ((final, ref["params"]), (dev_resid, ref["dev_resid"]),
                      (edge_resid, ref["edge_resid"])):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].shape == v.shape, k
    _assert_mostly_close(final, ref["params"], PARAM_ATOL, 0.0, PARAM_SHARE,
                         cap, "params")
    for got, want, what in ((dev_resid, ref["dev_resid"], "device residuals"),
                            (edge_resid, ref["edge_resid"],
                             "edge residuals")):
        _assert_mostly_close(got, want, RESID_ATOL, RESID_RTOL, RESID_SHARE,
                             cap, what)
    # the error-feedback state is live: devices outside the two cohorts
    # keep zero residuals, the ones inside do not
    seen = np.unique(np.concatenate(scheds))
    resid = np.stack([np.abs(v).reshape(N, -1).max(1)
                      for v in dev_resid.values()]).max(0)
    assert (resid[seen] > 0).all()
    assert (resid[np.setdiff1d(np.arange(N), seen)] == 0).all()


def test_codec_none_is_the_uncompressed_path():
    """``codec="none"`` takes the uncompressed Algorithm 1: the same single
    return value, bit for bit."""
    sp, pop, fed = _world(tcm, tdata)
    spec = get_hfl_spec("hfl-cnn")
    params = spec.init_fn(torch.Generator().manual_seed(0), fed, "cpu")
    X, y, mask = pad_device_data(fed, device="cpu")
    sched = torch.tensor([0, 2, 3, 5])
    assign = torch.tensor([0, 2, 0, 2])
    args = (spec.apply_fn, params, X[sched], y[sched], mask[sched],
            pop.D[sched], assign)
    kw = dict(M=M, L=1, Q=2, lr=0.01, agg_kernel=True)
    plain = hfl_global_iteration_core(*args, **kw)
    none = hfl_global_iteration_core(
        *args, codec=tcomp.CompressionConfig(), **kw)
    assert isinstance(none, dict) and none.keys() == plain.keys()
    for k in plain:
        assert torch.equal(none[k], plain[k])
