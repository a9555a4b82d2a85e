"""repro_torch.core.objective vs repro.core.objective.

Tolerances: loss and gradients atol 1e-5, rtol 1e-4 (the tolerance of the
kernel tests: per-worker sums in another order); optimal_alpha and
dual_step atol 1e-6 (a handful of fp32 operations); roc_auc atol 1e-6 (the
port ranks in float64, the reference in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objective as JO
from repro_torch.core import objective as O

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


def test_unported_objectives_raise():
    class Cfg:
        p_pos = 0.5
        objective = "pauc_dro"
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        O.for_config(Cfg)
    assert set(O.names()) == set(JO.names())
