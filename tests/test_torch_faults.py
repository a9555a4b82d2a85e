"""repro_torch.core.faults vs repro.core.faults, and the fault knobs of the
port's config and executor, mirroring tests/test_faults.py.

``FaultPlan`` is numpy in both packages, so the port must replay the
reference's schedule bitwise: the same float32 (weights, resync) vectors
for every window, for any seed and knob.  The masked window's arithmetic
is held against the reference in tests/test_torch_codasca.py; this file
holds the schedule, the config and the executor contract, and ``fit``
under faults against the reference on replayed windows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.core import faults as JF
from repro.core import schedules as JS
from repro_torch import params as P
from repro_torch.configs import mlp_config
from repro_torch.core import coda as C
from repro_torch.core import faults as F
from repro_torch.core import schedules as S
from repro_torch.data.synthetic import dirichlet_partition
from repro_torch.tree import tree_leaves

JMCFG = jax_mlp_config(n_features=8, d=16)
MCFG = mlp_config(n_features=8, d=16)
K, I, B = 4, 2, 4

PLANS = {
    "dropout": dict(n_workers=6, seed=3, dropout=0.4),
    "straggle_merge": dict(n_workers=4, seed=1, straggle=0.5, straggle_windows=2,
                           max_staleness=2),
    "straggle_drop": dict(n_workers=4, seed=1, straggle=0.5, straggle_windows=2,
                          max_staleness=1),
    "mixed": dict(n_workers=8, seed=11, dropout=0.3, straggle=0.2, straggle_windows=3,
                  max_staleness=3, staleness_discount=0.25),
    "crashes": dict(n_workers=5, seed=7, dropout=0.2, straggle=0.1, crashes=((0, 2), (3, 9))),
    "near_all_absent": dict(n_workers=3, seed=0, dropout=0.99),
    "heavy_straggle": dict(n_workers=2, seed=5, straggle=0.9, straggle_windows=4,
                           max_staleness=4),
    "single": dict(n_workers=1, seed=2, dropout=0.5),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plan_replays_the_reference_bitwise(name):
    """60 windows of the port's plan equal the reference's bit for bit,
    drawn in order; then random access into fresh plans agrees too."""
    kw = PLANS[name]
    a, b = JF.FaultPlan(**kw), F.FaultPlan(**kw)
    for w in range(60):
        (ju, jr), (u, r) = a.window(w), b.window(w)
        assert u.dtype == r.dtype == np.float32
        assert np.array_equal(ju, u) and np.array_equal(jr, r), (name, w)
        assert np.array_equal(a.participants(w), b.participants(w))
    a, b = JF.FaultPlan(**kw), F.FaultPlan(**kw)
    for w in (17, 3, 40, 0):
        assert all(np.array_equal(x, y) for x, y in zip(a.window(w), b.window(w)))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_workers=st.integers(1, 8),
       dropout=st.floats(0.0, 0.95), straggle=st.floats(0.0, 0.9),
       lag=st.integers(1, 3), max_staleness=st.integers(0, 3),
       discount=st.sampled_from([1.0, 0.5, 0.25, 0.75]))
def test_plan_replays_the_reference_for_any_knobs(seed, n_workers, dropout, straggle, lag,
                                                  max_staleness, discount):
    kw = dict(n_workers=n_workers, seed=seed, dropout=dropout, straggle=straggle,
              straggle_windows=lag, max_staleness=max_staleness,
              staleness_discount=discount)
    a, b = JF.FaultPlan(**kw), F.FaultPlan(**kw)
    for w in range(25):
        assert all(np.array_equal(x, y) for x, y in zip(a.window(w), b.window(w))), w


def test_plan_replays_from_seed():
    kw = dict(n_workers=6, seed=3, dropout=0.4, straggle=0.2, straggle_windows=2,
              max_staleness=2)
    a, b = F.FaultPlan(**kw), F.FaultPlan(**kw)
    for w in [5, 0, 11, 3, 7]:
        u2, r2 = b.window(w)
        u1, r1 = a.window(w)
        assert np.array_equal(u1, u2) and np.array_equal(r1, r2), w
    c = F.FaultPlan(**{**kw, "seed": 4})
    assert any(not np.array_equal(a.window(w)[0], c.window(w)[0]) for w in range(12))


def test_plan_vectors_are_copies():
    plan = F.FaultPlan(n_workers=4, dropout=0.5)
    u, _ = plan.window(0)
    u[:] = -1.0
    assert float(plan.window(0)[0].min()) >= 0.0


def test_plan_never_all_absent():
    plan = F.FaultPlan(n_workers=4, seed=0, dropout=0.99)
    for w in range(50):
        u, r = plan.window(w)
        assert u.sum() > 0.0, w
        assert np.all(r == 1.0), w


def test_plan_crash_semantics():
    plan = F.FaultPlan(n_workers=3, crashes=((0, 2), (2, 4)))
    for w in range(8):
        u, r = plan.window(w)
        if w >= 2:
            assert u[0] == 0.0 and r[0] == 1.0, w
        if w >= 4:
            assert u[2] == 0.0 and r[2] == 1.0, w
        assert u[1] == 1.0
    for plan in (F.FaultPlan(n_workers=2, crashes=((0, 0), (1, 3))),
                 JF.FaultPlan(n_workers=2, crashes=((0, 0), (1, 3)))):
        for w in range(3):
            plan.window(w)
        with pytest.raises(RuntimeError, match="crashed"):
            plan.window(3)


@pytest.mark.parametrize("bad", [dict(crashes=((5, 0),)), dict(crashes=((0, -1),)),
                                 dict(dropout=1.0), dict(straggle=-0.1),
                                 dict(straggle_windows=0), dict(max_staleness=-1),
                                 dict(staleness_discount=0.0), dict(n_workers=0)])
def test_plan_validation_matches_reference(bad):
    kw = dict(n_workers=2) | bad
    with pytest.raises(ValueError):
        JF.FaultPlan(**kw)
    with pytest.raises(ValueError):
        F.FaultPlan(**kw)
    with pytest.raises(ValueError):
        F.FaultPlan(n_workers=2).window(-1)


def _episode_invariants(plan, d, max_staleness, discount, n=60):
    """Every straggle episode: at most ``d`` consecutive (u=0, r=0)
    windows, then the discounted merge (d ≤ max_staleness) or the
    drop-and-resync (u=0, r=1)."""
    wins = [plan.window(w) for w in range(n)]
    allowed = {0.0, 1.0, np.float32(discount) ** d}
    run = np.zeros(plan.n_workers, int)
    saw_arrival = False
    for w, (u, r) in enumerate(wins):
        for k in range(plan.n_workers):
            assert float(u[k]) in allowed, (w, k, u[k])
            if r[k] == 0.0:
                assert u[k] == 0.0
                run[k] += 1
                assert run[k] <= d
            else:
                if run[k] == d:
                    want = np.float32(discount) ** d if d <= max_staleness else 0.0
                    assert float(u[k]) == float(want), (w, k, u[k])
                    saw_arrival = True
                run[k] = 0
    assert saw_arrival


@pytest.mark.parametrize("max_staleness", [2, 1])
def test_plan_straggler_episodes(max_staleness):
    plan = F.FaultPlan(n_workers=4, seed=1, straggle=0.5, straggle_windows=2,
                       max_staleness=max_staleness)
    _episode_invariants(plan, d=2, max_staleness=max_staleness, discount=0.5)
    if max_staleness < 2:   # too-stale deltas never merge
        assert all(set(np.unique(plan.window(w)[0])) <= {0.0, 1.0} for w in range(60))
    for w in range(20):
        assert np.array_equal(plan.participants(w), (plan.window(w)[0] > 0).astype(np.float32))


def test_plan_from_config_maps_knobs():
    kw = dict(n_workers=5, participation=0.8, straggler_prob=0.1, straggler_windows=3,
              max_staleness=2, staleness_discount=0.25, fault_seed=9, crashes=((1, 4),))
    plan = F.FaultPlan.from_config(C.CoDAConfig(**kw))
    want = JF.FaultPlan.from_config(JC.CoDAConfig(**kw))
    assert plan.n_workers == 5 and plan.seed == 9
    assert plan.dropout == pytest.approx(0.2) and plan.dropout == want.dropout
    assert plan.straggle == 0.1 and plan.straggle_windows == 3
    assert plan.max_staleness == 2 and plan.staleness_discount == 0.25
    assert plan.crashes == ((1, 4),) == want.crashes
    for w in range(30):
        assert all(np.array_equal(x, y) for x, y in zip(plan.window(w), want.window(w)))


# --------------------------------------------------------------------------
# the config's fault knobs and the executor's contract
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(participation=0.0), dict(participation=1.5),
                                 dict(straggler_prob=1.0), dict(straggler_windows=0),
                                 dict(max_staleness=-1), dict(staleness_discount=0.0)])
def test_config_fault_knob_validation(bad):
    with pytest.raises(ValueError):
        C.CoDAConfig(n_workers=2, **bad)


def test_config_faults_enabled_gate():
    assert not C.CoDAConfig(n_workers=2).faults_enabled
    assert not C.CoDAConfig(n_workers=2, max_staleness=3).faults_enabled
    assert C.CoDAConfig(n_workers=2, participation=0.5).faults_enabled
    assert C.CoDAConfig(n_workers=2, straggler_prob=0.1).faults_enabled
    assert C.CoDAConfig(n_workers=2, crashes=((0, 1),)).faults_enabled


def test_config_rejects_server_momentum_with_faults():
    with pytest.raises(ValueError, match="server momentum"):
        C.CoDAConfig(n_workers=2, participation=0.5, server_momentum=0.9)
    C.CoDAConfig(n_workers=2, server_momentum=0.9)
    C.CoDAConfig(n_workers=2, participation=0.5)


def _wb(seed, labels=None):
    rng = np.random.default_rng(seed)
    y = labels if labels is not None else (rng.random((I, K, B)) < 0.5).astype(np.float32)
    x = rng.standard_normal((I, K, B, 8)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": x, "labels": y}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_executor_fault_arg_contract():
    wb = _t(_wb(0))
    fl = {"weights": torch.ones(K), "resync": torch.ones(K)}
    for kw, call, match in ((dict(participation=0.5), {}, "fault"),
                            ({}, {"faults": fl}, "disabled")):
        ccfg = C.CoDAConfig(n_workers=K, **kw)
        exe = C.make_executor(MCFG, ccfg)
        st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=match):
            exe.window_step(st, wb, 0.1, **call)


# --------------------------------------------------------------------------
# fit under faults, against the reference on replayed windows
# --------------------------------------------------------------------------
def _sampler(store):
    def sample_window(key, n):
        kf, kl = jax.random.split(key)
        y = (jax.random.uniform(kl, (n, K, B)) < 0.6).astype(jnp.float32)
        x = jax.random.normal(kf, (n, K, B, 8)) + 0.3 * (y[..., None] * 2 - 1)
        store["w"].append({"features": np.asarray(x), "labels": np.asarray(y)})
        return {"features": x, "labels": y}

    def sample_alpha(key, m):
        kf, kl = jax.random.split(key)
        y = (jax.random.uniform(kl, (K, m)) < 0.6).astype(jnp.float32)
        x = jax.random.normal(kf, (K, m, 8)) + 0.3 * (y[..., None] * 2 - 1)
        store["a"].append({"features": np.asarray(x), "labels": np.asarray(y)})
        return {"features": x, "labels": y}
    return sample_window, sample_alpha


@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
def test_fit_under_faults_matches_reference(algorithm):
    """fit with dropout, stragglers and a crash: the reference's windows
    replayed, its fault schedule rebuilt from the config; history, counters,
    exposed bytes (the masked payload) and the final state match."""
    kw = dict(n_workers=K, p_pos=0.6, algorithm=algorithm, participation=0.7,
              straggler_prob=0.2, straggler_windows=2, max_staleness=2, fault_seed=5,
              crashes=((3, 6),))
    jccfg, ccfg = JC.CoDAConfig(**kw), C.CoDAConfig(**kw)
    kwargs = dict(n_workers=K, eta0=0.3, T0=8, I0=I)
    key = jax.random.PRNGKey(0)
    store = {"w": [], "a": []}
    jres = JC.fit(key, JMCFG, jccfg, JS.ScheduleConfig(**kwargs), 2, *_sampler(store))
    st0 = P.state_from_jax(MCFG, ccfg, jax.tree_util.tree_map(
        np.asarray, JC.init_state(key, JMCFG, jccfg)))
    wit, ait = iter(store["w"]), iter(store["a"])
    res = C.fit(st0, MCFG, ccfg, S.ScheduleConfig(**kwargs), 2,
                sample_window=lambda i: _t(next(wit)),
                sample_alpha_batch=lambda m: _t(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds)
    assert (res.exposed_bytes, res.overlapped_bytes) == \
        (jres.exposed_bytes, jres.overlapped_bytes)
    n_windows = res.comm_rounds - 2
    assert res.exposed_bytes == n_windows * C.window_payload_bytes(res.state, masked=True) + 8
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(MCFG, res.state)
    for k in got:
        for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                        jax.tree_util.tree_leaves(jres.state[k]), strict=True):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, err_msg=k)


def test_full_participation_is_bitwise_the_existing_path():
    """participation = 1.0 with only the staleness knobs set is not a fault
    config: fit runs the unmasked path and lands bitwise on the default
    config's result."""
    base = C.CoDAConfig(n_workers=K, p_pos=0.6)
    p1 = C.CoDAConfig(n_workers=K, p_pos=0.6, participation=1.0, max_staleness=2,
                      staleness_discount=0.25)
    assert not p1.faults_enabled
    sched = S.ScheduleConfig(n_workers=K, eta0=0.4, T0=8, I0=2)
    out = []
    for ccfg in (base, p1):
        rng = np.random.default_rng(0)
        st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
        res = C.fit(st, MCFG, ccfg, sched, 2,
                    sample_window=lambda i: _t(_wb(int(rng.integers(1 << 30)))),
                    sample_alpha_batch=lambda m: {k: v[0] for k, v in _t(
                        _wb(int(rng.integers(1 << 30)))).items()})
        out.append(res)
    assert out[0].comm_rounds == out[1].comm_rounds
    assert out[0].exposed_bytes == out[1].exposed_bytes
    for a, b in zip(tree_leaves(out[0].state), tree_leaves(out[1].state)):
        assert torch.equal(a, b)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       alpha=st.floats(min_value=0.05, max_value=5.0),
       n_workers=st.integers(min_value=2, max_value=8),
       dropout=st.floats(min_value=0.0, max_value=0.9),
       straggle=st.floats(min_value=0.0, max_value=0.5))
def test_partition_plus_masks_never_starve_a_window(seed, alpha, n_workers, dropout,
                                                    straggle):
    """The port's Dirichlet shards tile the data with no empty shard, and
    every window of the plan has a participant with data; a window whose
    participants hold positives keeps the positive class."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(256) < 0.3).astype(np.float32)
    shards = dirichlet_partition(rng, labels, n_workers, alpha)
    assert sorted(np.concatenate(shards).tolist()) == list(range(256))
    assert all(len(s) > 0 for s in shards)
    plan = F.FaultPlan(n_workers=n_workers, seed=seed, dropout=dropout, straggle=straggle,
                       straggle_windows=1, max_staleness=1)
    shard_has_pos = np.array([labels[s].sum() > 0 for s in shards])
    for w in range(25):
        m = plan.participants(w)
        assert m.sum() >= 1.0, w
        pool = np.concatenate([shards[k] for k in range(n_workers) if m[k] > 0])
        assert pool.size > 0, w
        if shard_has_pos[m > 0].any():
            assert labels[pool].sum() > 0, w
