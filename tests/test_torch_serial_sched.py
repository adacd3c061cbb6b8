"""The port's serial scheduler oracles (``SerialFedAvgScheduler``,
``SerialVKCScheduler``, ``SerialIKCScheduler``) against ``repro``'s, and
the parity suite of ``tests/test_scheduler_parity.py`` on the port's own
engines.

Both packages hold numpy copies that replay the same
``np.random.default_rng`` draw order, so the cohorts must be bitwise
equal round by round (and IKC's rotation state C_k / G_k after each
round). The distribution and invariant tests are the reference's, run
on the port's vectorized engines against the port's serial oracles:
selection frequencies within 5 binomial sigma, rotation blocks, top-up
recorded into G_k, label gaps and the short-cohort top-up.
"""
import numpy as np
import pytest

import repro.core.scheduling.schedulers as jsch
import repro_torch.core.scheduling as tsched
from repro_torch.core.scheduling.schedulers import (
    FedAvgScheduler, IKCScheduler, SerialFedAvgScheduler,
    SerialIKCScheduler, SerialVKCScheduler, VKCScheduler)

ROUNDS = 20


def _clusters(n, k, seed, small=None):
    """Labels of n devices in k clusters, every label present; ``small``
    = (cluster, size) pins one cluster's size (below h: the short path
    and the top-up)."""
    rng = np.random.default_rng(seed)
    if small is None:
        c = rng.integers(0, k, n)
        c[:k] = np.arange(k)
        return c
    kk, size = small
    others = [j for j in range(k) if j != kk]
    c = np.asarray(others)[rng.integers(0, len(others), n)]
    c[:len(others)] = others
    c[len(others):len(others) + size] = kk
    return c


def _ikc_state(s):
    return ([list(map(int, c)) for c in s.C], [list(map(int, g)) for g in s.G])


@pytest.mark.parametrize("n,k,h,seed,small", [
    (60, 4, 2, 0, None), (100, 10, 5, 1, None), (37, 5, 3, 2, None),
    (40, 4, 3, 3, (2, 1)), (24, 3, 4, 4, (0, 2)), (12, 6, 2, 5, None)])
def test_serial_ikc_vkc_bitwise(n, k, h, seed, small):
    """Serial VKC and IKC cohorts equal the reference's for ROUNDS rounds
    (IKC's C_k and G_k after every round), then one top-up past H."""
    c = _clusters(n, k, seed, small)
    for jcls, tcls in ((jsch.SerialVKCScheduler, SerialVKCScheduler),
                       (jsch.SerialIKCScheduler, SerialIKCScheduler)):
        js, ts = jcls(c, h), tcls(c, h)
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(ROUNDS):
            a, b = js.schedule(jr), ts.schedule(tr)
            assert np.array_equal(a, b) and a.dtype == b.dtype
            if tcls is SerialIKCScheduler:
                assert _ikc_state(js) == _ikc_state(ts)
        target = min(n, js.H + 3)
        a = js.topup_to(js.schedule(jr), target, jr)
        b = ts.topup_to(ts.schedule(tr), target, tr)
        assert np.array_equal(a, b)
        if tcls is SerialIKCScheduler:
            assert _ikc_state(js) == _ikc_state(ts)


@pytest.mark.parametrize("n,H", [(40, 6), (10, 8), (100, 50)])
def test_serial_fedavg_bitwise(n, H):
    js, ts = jsch.SerialFedAvgScheduler(n, H), SerialFedAvgScheduler(n, H)
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(ROUNDS):
        assert np.array_equal(js.schedule(jr), ts.schedule(tr))
    assert np.array_equal(js.topup_to(np.arange(3), H, jr),
                          ts.topup_to(np.arange(3), H, tr))


def test_serial_exported_as_in_reference():
    for name in ("SerialFedAvgScheduler", "SerialVKCScheduler",
                 "SerialIKCScheduler"):
        assert getattr(tsched, name).__name__ == name


# ---------------------------------------- the reference's parity suite


def _freqs(sched_cls, args, rounds, seed, n):
    rng = np.random.default_rng(seed)
    s = sched_cls(*args)
    f = np.zeros(n, int)
    for _ in range(rounds):
        sel = s.schedule(rng)
        assert len(set(sel.tolist())) == len(sel)
        f[sel] += 1
    return f


@pytest.mark.parametrize("vec_cls,ser_cls,args_of", [
    (FedAvgScheduler, SerialFedAvgScheduler, lambda c: (len(c), 12)),
    (VKCScheduler, SerialVKCScheduler, lambda c: (c, 2)),
    (IKCScheduler, SerialIKCScheduler, lambda c: (c, 2)),
])
def test_selection_frequencies_match_serial(vec_cls, ser_cls, args_of):
    """Both engines induce the same per-device selection law: every
    device's frequency over R rounds within 5 binomial sigma of the
    serial engine's."""
    rng = np.random.default_rng(0)
    n, k = 60, 4
    clusters = rng.integers(0, k, n)
    clusters[:k] = np.arange(k)
    rounds = 800
    fv = _freqs(vec_cls, args_of(clusters), rounds, seed=1, n=n)
    fs = _freqs(ser_cls, args_of(clusters), rounds, seed=2, n=n)
    assert fv.sum() == fs.sum()
    q = fs / rounds
    sigma = np.sqrt(rounds * q * (1 - q)).clip(min=1.0)
    assert np.all(np.abs(fv - fs) <= 5.0 * sigma), np.abs(fv - fs) / sigma


@pytest.mark.parametrize("cls", [IKCScheduler, SerialIKCScheduler])
def test_ikc_rotation_blocks_match_serial_invariant(cls):
    """Clusters an exact multiple of h: every cnt/h-round block is one
    rotation, each device scheduled exactly once, in both engines."""
    rng = np.random.default_rng(11)
    per, k, h = 12, 5, 3
    clusters = np.repeat(np.arange(k), per)
    s = cls(clusters, h)
    for _ in range(3):
        counts = np.zeros(len(clusters), int)
        for _ in range(per // h):
            counts[s.schedule(rng)] += 1
        assert counts.min() == counts.max() == 1, counts


@pytest.mark.parametrize("cls", [IKCScheduler, SerialIKCScheduler])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_ikc_topup_respects_rotation(cls, seed):
    """Devices scheduled through the top-up path enter their cluster's
    rotation set G_k: cluster 0 has one device (always scheduled), each
    cohort is 2 cluster-1 picks + 1 cluster-1 top-up, so 18 devices make
    one full rotation in 6 rounds with no repeat."""
    clusters = np.array([0] + [1] * 18)
    rng = np.random.default_rng(seed)
    s = cls(clusters, 2)
    counts = np.zeros(19, int)
    for _ in range(6):
        sel = s.schedule(rng)
        assert len(sel) == 4 and len(set(sel.tolist())) == 4
        counts[sel] += 1
    assert counts[0] == 6
    assert counts[1:].min() == counts[1:].max() == 1, counts


@pytest.mark.parametrize("cls", [VKCScheduler, SerialVKCScheduler,
                                 IKCScheduler, SerialIKCScheduler])
def test_empty_cluster_topup(cls):
    """A label gap (cluster 1 has no members) still gives a full unique
    cohort through the top-up."""
    clusters = np.array([0] * 5 + [2] * 5)
    rng = np.random.default_rng(5)
    s = cls(clusters, 2)
    for _ in range(4):
        sel = s.schedule(rng)
        assert len(sel) == 6 and len(set(sel.tolist())) == 6
        assert sel.min() >= 0 and sel.max() < 10


def test_sweep_short_cohort_topup_records_rotation():
    """``topup_to`` beyond the scheduler's own H (the sweep's K' < K
    path): IKC's extra picks land in G_k, in the vectorized state's
    window tail and in the serial G_k list."""
    clusters = np.repeat(np.arange(3), 8)
    rng = np.random.default_rng(9)
    s = IKCScheduler(clusters, 2)
    sel = s.schedule(rng)
    topped = s.topup_to(sel, 10, rng)
    assert len(topped) == 10 and len(set(topped.tolist())) == 10
    st = s.state
    for d in topped[len(sel):]:
        k = int(st.clusters[d])
        assert int(st.pos[d]) - int(st.offsets[k]) >= s.nf[k]
    ser = SerialIKCScheduler(clusters, 2)
    sel = ser.schedule(rng)
    topped = ser.topup_to(sel, 10, rng)
    for d in topped[len(sel):]:
        k = int(ser.clusters[d])
        assert d in ser.G[k] and d not in ser.C[k]
