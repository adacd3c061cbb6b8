"""Compressed sweeps: ``repro_torch.core.sweep.SweepRunner(compression=
...)`` against ``repro.core.sweep`` on the world of
``tests/test_torch_sweep.py`` (S=2 lanes, two geo rounds, the reference's
initial weights and, for int8, its ``jax.random`` rounding draws
injected through ``codec_noise``).

``SweepRunner.run``'s records are held as the uncompressed run's:
``iters``, ``H``, ``msg_bits_per_round`` and the uplink bits exact,
T_i/E_i/obj rtol 1e-5, ``acc`` within one test sample.

The codecs are discontinuous, so the ~1e-7 training difference between
BLAS and XLA flips single quanta, and a flipped quantum grows over the
next round's training into many more: two free-running bf16 rounds end
with 6 % of lane 0's params more than 1e-5 apart (max 4.2e-4), though
each round alone is within the limits below. So the state is held round
by round: two ``sweep_round`` calls in each package, the second started
in both from the reference's state after the first, each round's params
and both error-feedback residuals held by the share of elements that
differ, with the limits of ``tests/test_torch_compression.py``: params
<= 1e-3 by more than 1e-5, residuals <= 5e-3 by more than 1e-7 +
1e-2·|reference|, none by two codec quanta at the largest message the
port sent (measured for bf16: params 8.7e-6, the largest difference
1.5e-5); T_i/E_i rtol 1e-5. ``codec="none"`` is the uncompressed run,
bit for bit; ``lane_chunk=1`` with a codec is the whole-axis round
(atol 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sweep as jsw
from repro_torch.convert import params_to_numpy
from repro_torch.core import compression as tcomp
from repro_torch.core import sweep as tsw
from test_torch_compression import _assert_mostly_close, _quantum
from test_torch_framework import one_torch_thread  # noqa: F401 (autouse)
from test_torch_sweep import (M, R, S, _assert_run_matches, _round_inputs,
                              _runners, _scheds)
PARAM_ATOL, PARAM_SHARE = 1e-5, 1e-3
RESID_ATOL, RESID_RTOL, RESID_SHARE = 1e-7, 1e-2, 5e-3


def _to_jax(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


def _to_port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("codec", ["int8", "bf16_delta", "topk"])
def test_compressed_run_matches_reference(codec):
    """Two compressed geo rounds of ``SweepRunner.run``: the records."""
    jr, tr = _runners(codec)
    j = jr.run(_scheds(jsw, jr), R, assign="geo")
    t = tr.run(_scheds(tsw, tr), R, assign="geo")
    _assert_run_matches(t, j)
    assert t["uplink_bits_per_msg"] < tr.model_bits / 1.9


@pytest.mark.parametrize("codec", ["int8", "bf16_delta", "topk"])
def test_compressed_rounds_match_reference(monkeypatch, codec):
    """Two compressed ``sweep_round`` calls, the second from the
    reference's state after the first (see the module docstring)."""
    jr, tr = _runners(codec)
    largest = [0.0]
    real = tcomp.encode_leaf

    def spy(cfg, delta, resid, u=None):
        out = real(cfg, delta, resid, u)
        largest[0] = max(largest[0], _quantum(cfg, delta + resid, out[1]))
        return out
    monkeypatch.setattr(tcomp, "encode_leaf", spy)
    jsp = dataclasses.replace(jr.sp, model_bits=float(jr.uplink_bits))
    tsp = dataclasses.replace(tr.sp, model_bits=float(tr.uplink_bits))
    assert dataclasses.asdict(tsp) == dataclasses.asdict(jsp)
    bases = jr._codec_base_keys(list(range(S)))
    jp, jstate = jr.params0, jr._codec_state0()
    for r in range(R):
        sched, assign = _round_inputs(jr, tr, seed=2 * r + 1)
        tp, tstate = _to_port(jp), tuple(_to_port(t) for t in jstate)
        jp, (jT, jE), jstate = jsw.sweep_round(
            jr.apply_fn, jsp, jp, jr.u_b, jr.D_b, jr.p_b, jr.g_b,
            jr.g_cloud_b, jr.B_m_b, jr.X_b, jr.y_b, jr.mask_b, jr.D_b,
            jnp.asarray(sched), jnp.asarray(assign), jr.lr, M=M, L=jsp.L,
            Q=jsp.Q, alloc_steps=jr.alloc_steps, codec=jr.codec,
            codec_state_b=jstate,
            codec_keys_b=jax.vmap(lambda k: jax.random.fold_in(k, r))(bases))
        tp, (tT, tE), tstate = tsw.sweep_round(
            tr.apply_fn, tsp, tp, tr.u_b, tr.D_b, tr.p_b, tr.g_b,
            tr.g_cloud_b, tr.B_m_b, tr.X_b, tr.y_b, tr.mask_b, tr.D_b,
            torch.from_numpy(sched), torch.from_numpy(assign), tr.lr, M=M,
            L=tsp.L, Q=tsp.Q, alloc_steps=tr.alloc_steps, codec=tr.codec,
            codec_state_b=tstate,
            codec_noise_b=[tr.codec_noise(s, r) for s in range(S)])
        for a, b in ((tT, jT), (tE, jE)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        cap = 2.0 * largest[0]
        assert 0.0 < cap < 0.05
        for got, want, atol, rtol, share, what in (
                (tp, jp, PARAM_ATOL, 0.0, PARAM_SHARE, "params"),
                (tstate[0], jstate[0], RESID_ATOL, RESID_RTOL, RESID_SHARE,
                 "device residuals"),
                (tstate[1], jstate[1], RESID_ATOL, RESID_RTOL, RESID_SHARE,
                 "edge residuals")):
            got = params_to_numpy(got)
            want = {k: np.asarray(v) for k, v in want.items()}
            for k, v in want.items():
                assert got[k].shape == v.shape, k
            _assert_mostly_close(got, want, atol, rtol, share, cap,
                                 f"round {r} {what}")
    # the residuals are live on both lanes, and only on their cohorts
    seen = [np.union1d(_round_inputs(jr, tr, 1)[0][s],
                       _round_inputs(jr, tr, 3)[0][s]) for s in range(S)]
    for v in tstate[0].values():
        rows = v.reshape(S, v.shape[1], -1).abs().amax(2).numpy()
        for s in range(S):
            assert (rows[s, seen[s]] > 0).all()
            assert (np.delete(rows[s], seen[s]) == 0).all()


def test_codec_none_is_the_uncompressed_run():
    _, tr = _runners()
    _, none = _runners("none")
    a = tr.run(_scheds(tsw, tr), R)
    b = none.run(_scheds(tsw, none), R)
    assert a.keys() == b.keys() and b["codec"] == "none"
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in tr.params_b:
        assert torch.equal(tr.params_b[k], none.params_b[k]), k


def test_compressed_lane_chunk_matches_whole_axis():
    """With a codec, ``lane_chunk=1`` gives the whole-axis round: params
    and both residuals to atol 1e-6, costs to rtol 1e-6."""
    _, tr = _runners("int8")
    sched, assign = _round_inputs(None, tr, seed=1)
    sp = dataclasses.replace(tr.sp, model_bits=float(tr.uplink_bits))
    outs = [tsw.sweep_round(
        tr.apply_fn, sp, tr.params0, tr.u_b, tr.D_b, tr.p_b, tr.g_b,
        tr.g_cloud_b, tr.B_m_b, tr.X_b, tr.y_b, tr.mask_b, tr.D_b,
        torch.from_numpy(sched), torch.from_numpy(assign), tr.lr, M=M,
        L=sp.L, Q=sp.Q, alloc_steps=tr.alloc_steps, codec=tr.codec,
        codec_state_b=tr._codec_state0(), lane_chunk=chunk,
        codec_noise_b=[tr.codec_noise(s, 0) for s in range(S)])
        for chunk in (None, 1)]
    (p0, c0, (d0, e0)), (p1, c1, (d1, e1)) = outs
    for a, b in ((p0, p1), (d0, d1), (e0, e1)):
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6,
                                       err_msg=k)
    for a, b in zip(c0, c1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6)
