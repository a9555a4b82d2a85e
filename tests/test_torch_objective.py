"""repro_torch.core.objective vs repro.core.objective.

Tolerances: loss and gradients atol 1e-5, rtol 1e-4 (the tolerance of the
kernel tests: per-worker sums in another order; PAUC-DRO's λ gradient atol
1e-5/λ, below); optimal_alpha, stage_duals and dual_step atol 1e-6 (a
handful of fp32 operations); roc_auc atol 1e-6 (the port ranks in float64,
the reference in float32); ``fit`` with each objective on replayed windows
as tests/test_torch_coda.py holds the auc one (losses rtol 1e-4, final
parameters atol 1e-4, test AUC/pAUC atol 1e-3); the hard-negative data
transform bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.core import objective as JO
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.data import synthetic as JSyn
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import mlp_config
from repro_torch.core import coda as C
from repro_torch.core import objective as O
from repro_torch.core import schedules as S
from repro_torch.data import synthetic as Syn
from repro_torch.models import model as M
from repro_torch.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

TOL = {"atol": 1e-5, "rtol": 1e-4}


def _case(K, T, p, seed):
    rng = np.random.default_rng(seed)
    h = rng.random((K, T), dtype=np.float32)
    y = (rng.random((K, T)) < p).astype(np.float32)
    a, b, alpha = (rng.normal(0, 0.3, K).astype(np.float32) for _ in range(3))
    return h, y, a, b, alpha


@pytest.mark.parametrize("K,T,p", [(1, 7, 0.5), (4, 32, 0.71), (3, 513, 0.6)])
def test_auc_function_value_and_grad(K, T, p):
    """AUCFunction's forward and backward vs
    jax.vmap(jax.value_and_grad(auc_F)) per worker, with a non-unit
    cotangent per worker (the backward must scale by it)."""
    h, y, a, b, alpha = _case(K, T, p, seed=K * T)
    ct = np.linspace(0.5, 2.0, K).astype(np.float32)
    jf = lambda h_, y_, a_, b_, al_: JO.auc_F(h_, y_, a_, b_, al_, p)
    (want_l, want_g) = jax.vmap(jax.value_and_grad(jf, argnums=(0, 2, 3, 4)))(
        *(jnp.asarray(x) for x in (h, y, a, b, alpha)))
    th, ta, tb, tal = (torch.from_numpy(x).requires_grad_() for x in (h, a, b, alpha))
    loss = O.auc_F(th, torch.from_numpy(y), ta, tb, tal, p)
    (loss * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want_l), **TOL)
    for got, want in zip((th, ta, tb, tal), want_g):
        shape = (K,) + (1,) * (got.dim() - 1)
        np.testing.assert_allclose(got.grad.numpy(),
                                   np.asarray(want) * ct.reshape(shape), **TOL)


def test_auc_objective_loss_is_the_function():
    h, y, a, b, alpha = (torch.from_numpy(x) for x in _case(2, 16, 0.7, 3))
    obj = O.AUCObjective(p_pos=0.7)
    duals = {"a": a, "b": b, "alpha": alpha}
    torch.testing.assert_close(obj.loss(h, y, duals),
                               O.auc_F(h, y, a, b, alpha, 0.7), rtol=0, atol=0)
    assert obj.prox_refs == ("a", "b") and obj.stage_fields == ("alpha",)
    z = obj.init_duals(3, "cpu")
    assert sorted(z) == ["a", "alpha", "b"]
    assert all(v.shape == (3,) and v.dtype == torch.float32 and not v.any()
               for v in z.values())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_optimal_alpha(p):
    h, y, *_ = _case(4, 64, p, seed=int(p * 100))
    y[0] = 1.0        # a single-class worker: eps keeps it finite
    got = O.optimal_alpha(torch.from_numpy(h), torch.from_numpy(y))
    want = jax.vmap(JO.optimal_alpha)(jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "all_pos", "all_neg"])
def test_roc_auc(case):
    rng = np.random.default_rng(11)
    s = rng.random(200).astype(np.float32)
    y = (rng.random(200) < 0.4).astype(np.float32)
    if case == "ties":
        s = np.round(s * 4) / 4          # five distinct scores, many ties
    elif case == "all_pos":
        y[:] = 1.0
    elif case == "all_neg":
        y[:] = 0.0
    got = O.roc_auc(torch.from_numpy(s), torch.from_numpy(y))
    want = float(JO.roc_auc(jnp.asarray(s), jnp.asarray(y)))
    assert abs(got - want) <= 1e-6
    if case in ("all_pos", "all_neg"):
        assert got == 0.0
    if case == "ties":  # tied pairs count 1/2: the O(n²) pairwise oracle
        pos, neg = s[y > 0.5], s[y <= 0.5]
        pair = (pos[:, None] > neg[None, :]) + 0.5 * (pos[:, None] == neg[None, :])
        assert abs(got - pair.mean()) <= 1e-12


def test_dual_step_matches_reference():
    rng = np.random.default_rng(2)
    mk = lambda: {f: rng.normal(0, 0.5, 4).astype(np.float32) for f in ("a", "b", "alpha")}
    duals, grads, refs = mk(), mk(), mk()
    refs.pop("alpha")
    T = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    got = O.AUCObjective(0.7).dual_step(T(duals), T(grads), T(refs), 0.05, 0.5)
    want = JO.AUCObjective(0.7).dual_step(J(duals), J(grads), J(refs), 0.05, 0.5)
    for f in duals:
        np.testing.assert_allclose(got[f].numpy(), np.asarray(want[f]), atol=1e-6)


@pytest.mark.parametrize("name", JO.names())
def test_for_config_builds_every_reference_objective(name):
    """The registry is the reference's, and ``for_config`` builds each
    objective with the reference's fields (PAUC-DRO takes β from
    ``pauc_beta``)."""
    class Cfg:
        p_pos = 0.6
        objective = name
        pauc_beta = 0.2
    assert O.names() == JO.names()
    got, want = O.for_config(Cfg), JO.for_config(Cfg)
    assert type(got).__name__ == type(want).__name__ and got.name == want.name == name
    for field in ("prox_refs", "descent", "stage_fields", "metric_name", "p_pos"):
        assert getattr(got, field) == getattr(want, field), field
    if name == "pauc_dro":
        assert (got.beta, got.lam_init, got.lam_min) == (want.beta, want.lam_init,
                                                         want.lam_min) == (0.2, 1.0, 0.05)
        assert got.rho == pytest.approx(want.rho, rel=1e-12)
    duals = got.init_duals(3, "cpu")
    jd = want.init_duals(3)
    assert sorted(duals) == sorted(jd)
    for f in jd:
        assert duals[f].dtype == torch.float32
        np.testing.assert_array_equal(duals[f].numpy(), np.asarray(jd[f]))


# --------------------------------------------------------------------------
# PAUC-DRO (mirrors tests/test_objective.py:305-385) and BCE (:478-524)
# --------------------------------------------------------------------------
def _pauc_case(K, T, p, seed, lam):
    rng = np.random.default_rng(seed)
    h = rng.random((K, T), dtype=np.float32)
    y = (rng.random((K, T)) < p).astype(np.float32)
    duals = {f: rng.normal(0, 0.3, K).astype(np.float32) for f in ("a", "b", "alpha")}
    duals["lam"] = np.full(K, lam, np.float32)
    return h, y, duals


def _jax_value_and_grads(obj, h, y, duals):
    """The reference's per-worker loss and its gradients in h and every dual."""
    vg = jax.vmap(jax.value_and_grad(lambda h_, y_, d_: obj.loss(h_, y_, d_), argnums=(0, 2)))
    val, (gh, gd) = vg(jnp.asarray(h), jnp.asarray(y),
                       {k: jnp.asarray(v) for k, v in duals.items()})
    return np.asarray(val), np.asarray(gh), {k: np.asarray(v) for k, v in gd.items()}


def _torch_value_and_grads(obj, h, y, duals):
    th = torch.from_numpy(h).requires_grad_()
    td = {k: torch.from_numpy(v).requires_grad_() for k, v in duals.items()}
    val = obj.loss(th, torch.from_numpy(y), td)
    val.sum().backward()
    return (val.detach().numpy(), th.grad.numpy(),
            {k: (v.grad.numpy() if v.grad is not None else np.zeros_like(duals[k]))
             for k, v in td.items()})


# λ inside the feasible set, exactly at the floor (the reference's
# jnp.maximum splits the gradient in half there) and below it
@pytest.mark.parametrize("K,T,p,lam", [(2, 16, 0.7, 0.7), (3, 64, 0.5, 1.3),
                                       (4, 33, 0.7, 0.05), (2, 40, 0.3, 0.01)])
def test_pauc_loss_and_gradients_match_reference(K, T, p, lam):
    h, y, duals = _pauc_case(K, T, p, K * T, lam)
    obj, jobj = O.PAUCDROObjective(p_pos=0.7, beta=0.25), JO.PAUCDROObjective(p_pos=0.7, beta=0.25)
    got, want = (_torch_value_and_grads(obj, h, y, duals),
                 _jax_value_and_grads(jobj, h, y, duals))
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    for f in ("a", "b", "alpha"):
        np.testing.assert_allclose(got[2][f], want[2][f], err_msg=f, **TOL)
    # ∂F/∂λ = ρ + lse − log n⁻ − Σ q·ℓ/λ: two O(ℓ/λ) terms cancel, so fp32
    # rounding in another summation order grows as 1/λ (λ clamped at 0.05)
    lam_atol = TOL["atol"] / max(lam, obj.lam_min)
    np.testing.assert_allclose(got[2]["lam"], want[2]["lam"], atol=lam_atol, rtol=TOL["rtol"])


def test_pauc_all_positive_batch_is_finite_with_zero_dro_gradient():
    """Worker 0 sees only positives, worker 1 only negatives, worker 2 both.
    The port's log-sum-exp runs on the safe mask, so the all-positive
    worker's loss is finite, its λ and b gradients are exactly 0 (the DRO
    term is switched off) and no NaN leaks into any gradient; everything
    equals the reference's."""
    h, y, duals = _pauc_case(3, 16, 0.5, 5, 0.8)
    y[0], y[1] = 1.0, 0.0
    obj, jobj = O.PAUCDROObjective(p_pos=0.7), JO.PAUCDROObjective(p_pos=0.7)
    val, gh, gd = _torch_value_and_grads(obj, h, y, duals)
    assert np.isfinite(val).all() and np.isfinite(gh).all()
    assert all(np.isfinite(g).all() for g in gd.values())
    assert gd["lam"][0] == 0.0 and gd["b"][0] == 0.0
    want = _jax_value_and_grads(jobj, h, y, duals)
    np.testing.assert_allclose(val, want[0], **TOL)
    np.testing.assert_allclose(gh, want[1], **TOL)
    for f in duals:
        np.testing.assert_allclose(gd[f], want[2][f], err_msg=f, **TOL)


def test_pauc_masked_entries_get_zero_lse_gradient():
    """logsumexp(x, b=mask) as logsumexp(x + log mask): a positive entry's
    −inf weight gives it exactly zero gradient from the DRO term (not NaN):
    with the positive side switched off (p_pos = 1 makes its weight 0) the
    positives' gradient is exactly zero."""
    h, y, duals = _pauc_case(2, 24, 0.5, 9, 0.6)
    obj = O.PAUCDROObjective(p_pos=1.0)
    th = torch.from_numpy(h).requires_grad_()
    lam = torch.from_numpy(duals["lam"]).requires_grad_()
    d = {k: torch.from_numpy(v) for k, v in duals.items()} | {"lam": lam}
    obj.loss(th, torch.from_numpy(y), d).sum().backward()
    g = th.grad.numpy()
    assert np.isfinite(g).all() and (g[y > 0.5] == 0.0).all() and (g[y < 0.5] != 0.0).all()


def test_pauc_dual_step_projects_lam_at_the_floor():
    obj, jobj = O.PAUCDROObjective(p_pos=0.7), JO.PAUCDROObjective(p_pos=0.7)
    duals = obj.init_duals(4, "cpu")
    grads = {f: torch.full((4,), 100.0) for f in duals}     # a huge descent pull
    grads["lam"][1] = -3.0                                  # and one that stays above
    refs = {f: torch.zeros(4) for f in obj.prox_refs}
    new = obj.dual_step(duals, grads, refs, 1.0, 0.5)
    J = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}
    want = jobj.dual_step(J(duals), J(grads), J(refs), 1.0, 0.5)
    for f in duals:
        np.testing.assert_allclose(new[f].numpy(), np.asarray(want[f]), atol=1e-6, err_msg=f)
    assert new["lam"][0] == obj.lam_min and new["lam"][1] == pytest.approx(4.0)
    assert obj.descent == ("lam",) and float(new["alpha"][0]) > 0.0


@pytest.mark.parametrize("all_pos", [False, True])
def test_pauc_stage_duals_match_reference(all_pos):
    """α* under the DRO weights softmax(ℓ/λ) over the negatives."""
    h, y, duals = _pauc_case(3, 48, 0.6, 4, 0.3)
    if all_pos:
        y[2] = 1.0
    got = O.PAUCDROObjective(p_pos=0.7).stage_duals(
        torch.from_numpy(h), torch.from_numpy(y), {k: torch.from_numpy(v) for k, v in duals.items()})
    want = jax.vmap(JO.PAUCDROObjective(p_pos=0.7).stage_duals)(
        jnp.asarray(h), jnp.asarray(y), {k: jnp.asarray(v) for k, v in duals.items()})
    assert sorted(got) == ["alpha"]
    np.testing.assert_allclose(got["alpha"].numpy(), np.asarray(want["alpha"]), atol=1e-6)


def test_pauc_metric_is_the_references_partial_auc():
    rng = np.random.default_rng(3)
    s = rng.random(300).astype(np.float32)
    y = (rng.random(300) < 0.4).astype(np.float32)
    for beta in (0.1, 0.3):
        obj = O.PAUCDROObjective(beta=beta)
        got = obj.metric("exact").compute(torch.from_numpy(s), torch.from_numpy(y))
        assert obj.metric_name == "pauc"
        assert got == pytest.approx(JO.partial_auc(s, y, beta), abs=1e-12)


def test_bce_loss_and_gradient_on_sigmoid_scores():
    """The executors hand BCE the sigmoid scores ``M.score`` returns, in both
    packages; the port takes log_sigmoid of that same value: the loss and
    its gradient equal the reference's and the explicit formulas."""
    rng = np.random.default_rng(6)
    h = rng.random((3, 20)).astype(np.float32)         # sigmoid outputs in (0, 1)
    y = (rng.random((3, 20)) < 0.6).astype(np.float32)
    obj, jobj = O.BCEObjective(0.5), JO.BCEObjective(0.5)
    assert obj.init_duals(3, "cpu") == {} and obj.metric_name == "auc"
    th = torch.from_numpy(h).requires_grad_()
    val = obj.loss(th, torch.from_numpy(y), {})
    val.sum().backward()
    want_v, want_g = jax.vmap(jax.value_and_grad(lambda h_, y_: jobj.loss(h_, y_, {})))(
        jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(want_v), atol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_g), atol=1e-7)
    sig = 1.0 / (1.0 + np.exp(-h.astype(np.float64)))
    np.testing.assert_allclose(val.detach().numpy(),
                               -np.mean(y * np.log(sig) + (1 - y) * np.log(1 - sig), axis=1),
                               rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), (sig - y) / 20, rtol=1e-4)


@pytest.mark.parametrize("sig,frac,shape", [(1.5, 0.25, (4, 33)), (1.0, 0.5, (257,)),
                                            (2.3, 0.1, (2, 3, 8))])
def test_hard_negative_features_equal_the_references_on_shared_draws(sig, frac, shape):
    """``DataConfig.hard_neg_frac``: the reference's branch
    (``repro/data/synthetic.py:73-93``) fed the reference's own draws —
    its key split into the normal and the uniform draws — gives the same
    fp32 bits as the port's ``hard_negative_features`` on those draws."""
    key = jax.random.PRNGKey(int(sig * 10) + len(shape))
    labels = (np.random.default_rng(len(shape)).random(shape) < 0.4).astype(np.float32)
    jd = JDataConfig(kind="features", n_features=10, signal=sig, hard_neg_frac=frac)
    want = np.asarray(JSyn._draw(key, jd, shape, jnp.asarray(labels))["features"])
    kx, kh = jax.random.split(key)
    x, u = (np.asarray(jax.random.normal(kx, shape + (10,))),
            np.asarray(jax.random.uniform(kh, shape)))
    got = Syn.hard_negative_features(x, u, labels, Syn.DataConfig(
        kind="features", n_features=10, signal=sig, hard_neg_frac=frac))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    hard = (u < frac) & (labels < 0.5)
    assert hard.any() and (~hard & (labels < 0.5)).any()


def test_hard_negative_dataset_mixes_the_negatives():
    """The port's dataset draws the hard component from its own stream: over
    the negatives, the first half of the features averages
    q·0.25·s − (1−q)·0.3·s and the second half −q·0.2·s (q = hard_neg_frac),
    the positives +0.3·s and +0.2·s; within 0.02 (≥ 4 standard errors of
    these means over the ~4,000 negatives)."""
    q, sig = 0.25, 1.5
    ds = Syn.ShardedDataset(Syn.DataConfig(kind="features", n_features=32, signal=sig,
                                           hard_neg_frac=q), 20000, 4, target_p=0.71)
    x, y = ds.inputs["features"].numpy(), ds.labels.numpy()
    neg, pos = x[y < 0.5], x[y > 0.5]
    assert len(neg) > 3000
    np.testing.assert_allclose(neg[:, :16].mean(), q * 0.25 * sig - (1 - q) * 0.3 * sig,
                               atol=0.02)
    np.testing.assert_allclose(neg[:, 16:].mean(), -q * 0.2 * sig, atol=0.02)
    np.testing.assert_allclose(pos[:, :16].mean(), 0.3 * sig, atol=0.02)
    np.testing.assert_allclose(pos[:, 16:].mean(), 0.2 * sig, atol=0.02)


@pytest.mark.parametrize("name", ["pauc_dro", "bce"])
def test_fit_with_each_objective_matches_reference_on_replayed_windows(name):
    """The reference's ``fit`` (mlp, K=4, 2 stages, T0=8, I=4) with
    ``objective=name`` on hard-negative data, recording its windows; the
    port's ``fit`` replays them from the same initial state: the loss
    history, the final state (the λ dual included) and the objective's test
    metric match."""
    K, I, Bsz = 4, 4, 16
    jmcfg, mcfg = jax_mlp_config(n_features=16, d=32), mlp_config(n_features=16, d=32)
    key = jax.random.PRNGKey(8)
    ds = JShardedDataset(key, JDataConfig(kind="features", n_features=16, signal=2.0,
                                          hard_neg_frac=0.25), 1024, K, target_p=0.71)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=ds.p_pos, objective=name, pauc_beta=0.2)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=ds.p_pos, objective=name, pauc_beta=0.2)
    kw = dict(n_workers=K, eta0=0.5, T0=8, I0=I)
    windows, alphas = [], []

    def record(store, batch):
        store.append(jax.tree_util.tree_map(np.asarray, batch))
        return batch

    jres = JC.fit(key, jmcfg, jccfg, JS.ScheduleConfig(**kw), 2,
                  sample_window=lambda k, i: record(windows, ds.sample_window(k, i, Bsz)),
                  sample_alpha_batch=lambda k, m: record(alphas, ds.sample_alpha_batch(k, m)))
    st0 = P.state_from_jax(mcfg, ccfg, jax.tree_util.tree_map(
        np.asarray, JC.init_state(key, jmcfg, jccfg)))
    tt = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    wit, ait = iter(windows), iter(alphas)
    res = C.fit(st0, mcfg, ccfg, S.ScheduleConfig(**kw), 2,
                sample_window=lambda i: tt(next(wit)),
                sample_alpha_batch=lambda m: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds)
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(mcfg, res.state)
    for field in ("params", "duals", "ref_params", "ref_duals"):
        assert sorted(got["duals"]) == sorted(jres.state["duals"])
        for g, w in zip(jax.tree_util.tree_leaves(got[field]),
                        jax.tree_util.tree_leaves(jres.state[field]), strict=True):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, err_msg=field)
    if name == "pauc_dro":
        assert (got["duals"]["lam"] >= 0.05).all()
    test = ds.full(1024)
    jh, _ = JM.score(jmcfg, jax.tree_util.tree_map(lambda x: x[0], jres.state["params"]),
                     {"features": test["features"]})
    h, _ = M.score(mcfg, tree_map(lambda x: x[:1], res.state["params"]),
                   {"features": torch.from_numpy(np.array(test["features"]))[None]})
    met, jmet = O.for_config(ccfg).metric("exact"), JO.for_config(jccfg).metric("exact")
    y = np.array(test["labels"])
    assert abs(met.compute(h[0], torch.from_numpy(y)) - float(jmet.compute(jh, y))) <= 1e-3
