"""repro_torch kernels' plain versions vs the reference's oracles and Pallas
kernels (interpret mode), and — on a card — the CUDA kernels vs their plain
versions.

Tolerances are those of tests/test_kernels_auc_prox.py: auc_loss atol 1e-5,
rtol 1e-4 (the per-worker sums run in another order); prox_update 1e-6 in
fp32 (same operations in the same order) and 2e-2 in bf16 (one bf16 ulp
near 2-4 where a double rounding could land on the other side).

The card cases need no jax, so the one command that runs them on the card
is ``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_kernels.py``
(tests/conftest.py imports jax); the reference cases import it through the
``jref`` fixture.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

AUC_TOL = {"atol": 1e-5, "rtol": 1e-4}


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    from repro.kernels.auc_loss import auc_loss as pallas_auc
    from repro.kernels.prox_update import prox_update as pallas_prox
    return jnp, jax_ref, pallas_auc, pallas_prox


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _auc_case(K, T, p, seed=0):
    rng = np.random.default_rng(seed + 97 * T + K)
    h = rng.random((K, T), dtype=np.float32)
    y = (rng.random((K, T)) < p).astype(np.float32)
    a, b, alpha = (rng.normal(0, 0.3, K).astype(np.float32) for _ in range(3))
    return h, y, a, b, alpha


@pytest.mark.parametrize("T", [7, 100, 513])
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("p", [0.5, 0.71])
def test_auc_ref_matches_reference(jref, T, K, p):
    """Port's [K, T] plain version vs the reference oracle per worker and vs
    the Pallas kernel run in interpret mode."""
    jnp, jax_ref, pallas_auc, _ = jref
    h, y, a, b, alpha = _auc_case(K, T, p)
    got = ref.auc_loss_ref(*(torch.from_numpy(x) for x in (h, y, a, b, alpha)), p)
    for k in range(K):
        args = (jnp.asarray(h[k]), jnp.asarray(y[k]), a[k], b[k], alpha[k], p)
        for want in (jax_ref.auc_loss_ref(*args),
                     pallas_auc(*args, block=128, interpret=True)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w),
                                           **AUC_TOL)


@pytest.mark.parametrize("N", [5, 1000, 4097])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prox_ref_matches_reference(jref, N, dtype):
    jnp, jax_ref, _, pallas_prox = jref
    rng = np.random.default_rng(N)
    v, g, v0 = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jv, jg, jv0 = (jnp.asarray(x, jdt) for x in (v, g, v0))
    # both sides start from the same bf16-rounded values
    tv, tg, tv0 = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                   for x in (jv, jg, jv0))
    got = ref.prox_update_ref(tv, tg, tv0, 0.05, 0.5)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    for want in (jax_ref.prox_update_ref(jv, jg, jv0, 0.05, 0.5),
                 pallas_prox(jv, jg, jv0, 0.05, 0.5, block=256, interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol)


def test_prox_ref_is_the_references_arithmetic_in_fp32(jref):
    """In fp32 the plain version repeats the reference's operations in the
    same order, so the results are bitwise equal."""
    jnp, jax_ref, _, _ = jref
    rng = np.random.default_rng(7)
    v, g, v0 = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    got = ref.prox_update_ref(*(torch.from_numpy(x) for x in (v, g, v0)), 0.037, 0.5)
    want = jax_ref.prox_update_ref(*(jnp.asarray(x) for x in (v, g, v0)), 0.037, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.cuda
@pytest.mark.parametrize("K,T", [(1, 7), (4, 100), (4, 513), (4, 32), (8, 4096)])
def test_auc_kernel_matches_plain_on_card(cuda_device, K, T):
    from repro_torch.kernels.auc_loss import auc_loss
    h, y, a, b, alpha = (torch.from_numpy(x).to(cuda_device)
                         for x in _auc_case(K, T, 0.71))
    got = auc_loss(h, y, a, b, alpha, 0.71)
    want = ref.auc_loss_ref(h, y, a, b, alpha, 0.71)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **AUC_TOL)
    again = auc_loss(h, y, a, b, alpha, 0.71)
    assert all(torch.equal(g, x) for g, x in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5, 1000, 4097, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prox_kernel_matches_plain_on_card(cuda_device, N, dtype):
    from repro_torch.kernels.prox_update import prox_update
    g_ = torch.Generator().manual_seed(N)
    v, g, v0 = (torch.randn(N, generator=g_).to(cuda_device, dtype)
                for _ in range(3))
    got = prox_update(v, g, v0, 0.05, 0.5)
    want = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 if dtype == torch.bfloat16 else 1e-6)


@pytest.mark.cuda
def test_ops_auto_launches_on_card(cuda_device):
    from repro_torch.kernels import auc_loss as auc_mod
    from repro_torch.kernels import prox_update as prox_mod
    h, y, a, b, alpha = (torch.from_numpy(x).to(cuda_device)
                         for x in _auc_case(4, 32, 0.71))
    n0, m0 = auc_mod.launches, prox_mod.launches
    ops.auc_loss(h, y, a, b, alpha, 0.71, impl="auto")
    ops.prox_update_tree({"w": h}, {"w": y}, {"w": h}, 0.1, 0.5, impl="auto")
    assert (auc_mod.launches, prox_mod.launches) == (n0 + 1, m0 + 1)
