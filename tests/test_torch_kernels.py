"""repro_torch kernels' plain versions vs the reference's oracles and Pallas
kernels (interpret mode), and — on a card — the CUDA kernels vs their plain
versions.

Tolerances against the reference are those of
tests/test_kernels_auc_prox.py: auc_loss atol 1e-5, rtol 1e-4 (the
per-worker sums run in another order); prox_update 1e-6 in fp32 (same
operations in the same order) and 2e-2 in bf16 (one bf16 ulp near 2-4
where a double rounding could land on the other side).  On the card,
prox_update and opt_update equal their plain versions bitwise: each kernel
repeats its plain version's fp32 operations in order with explicitly
rounded intrinsics (opt_update_ref's own tests against the reference are in
tests/test_torch_optimizer.py).

The card cases need no jax, so the one command that runs them on the card
is ``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_kernels.py``
(tests/conftest.py imports jax); the reference cases import it through the
``jref`` fixture.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

AUC_TOL = {"atol": 1e-5, "rtol": 1e-4}


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    from repro.kernels.auc_loss import auc_loss as pallas_auc
    from repro.kernels.prox_update import prox_update as pallas_prox
    return jnp, jax_ref, pallas_auc, pallas_prox


def test_library_path_hashes_every_file_under_csrc(tmp_path, monkeypatch):
    """The hash-keyed library name covers the headers the sources include:
    an edit to a header alone renames the library (no nvcc needed), and the
    headers are not compiled as sources."""
    from repro_torch.kernels import _build
    for name in ("k.cu", "fa.cu", "moe.cu", "hopper.cuh"):
        (tmp_path / name).write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for attr, name in (("SOURCE", "k.cu"), ("ATTN_SOURCE", "fa.cu"), ("MOE_SOURCE", "moe.cu")):
        monkeypatch.setattr(_build, attr, tmp_path / name)
    first = _build.library_path()
    assert tmp_path / "hopper.cuh" in _build.hashed_files()
    assert tmp_path / "hopper.cuh" not in _build.sources()
    (tmp_path / "hopper.cuh").write_text("// two")
    second = _build.library_path()
    (tmp_path / "extra.cuh").write_text("// new header")
    assert len({first, second, _build.library_path()}) == 3
    real = Path(_build.__file__).resolve().parent / "csrc"
    assert "-I" in _build.NVCC_FLAGS and str(real) in _build.NVCC_FLAGS


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


@pytest.mark.parametrize("N", [5, 4097])
def test_prox_ref_takes_an_fp32_step_under_bf16_params(jref, N):
    """bf16 v and v0 with an fp32 direction g (blocked Shampoo's step under
    bf16 parameters): each input widened on its own, as the reference's
    plain version and its Pallas kernel do, one rounding to bf16 at the end;
    bitwise equal to both."""
    jnp, jax_ref, _, pallas_prox = jref
    rng = np.random.default_rng(N)
    v, g, v0 = (rng.standard_normal(N).astype(np.float32) for _ in range(3))
    jv, jv0 = (jnp.asarray(x, jnp.bfloat16) for x in (v, v0))
    tv, tv0 = (torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16) for x in (jv, jv0))
    got = ref.prox_update_ref(tv, torch.from_numpy(g), tv0, 0.05, 0.5)
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy().view(np.uint16)
    for want in (jax_ref.prox_update_ref(jv, jnp.asarray(g), jv0, 0.05, 0.5),
                 pallas_prox(jv, jnp.asarray(g), jv0, 0.05, 0.5, block=256, interpret=True)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits, np.asarray(want).view(np.uint16))


def test_prox_ref_is_the_references_arithmetic_in_fp32(jref):
    """In fp32 the plain version repeats the reference's operations in the
    same order, so the results are bitwise equal."""
    jnp, jax_ref, _, _ = jref
    rng = np.random.default_rng(7)
    v, g, v0 = (rng.standard_normal(4096).astype(np.float32) for _ in range(3))
    got = ref.prox_update_ref(*(torch.from_numpy(x) for x in (v, g, v0)), 0.037, 0.5)
    want = jax_ref.prox_update_ref(*(jnp.asarray(x) for x in (v, g, v0)), 0.037, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K,T,blocks,ticket", [
    (4, 32, 1, False),            # the mlp launcher's K × B: the block finishes its worker
    (1, 1024, 1, False),
    (1, 1025, 2, True),           # past one block: the last block sums the partials
    (8, 4096, 4, True),
    (2, 65536, 64, True),         # over 32 blocks: lanes sum two partials each
])
def test_auc_launch_geometry_is_the_kernels(K, T, blocks, ticket):
    """One launch a call, its grid and its ticket path as
    ``csrc/coda_kernels.cu`` computes them (read from the source: there is
    no compiler here)."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels import auc_loss as K1
    src = (_build.CSRC / "coda_kernels.cu").read_text()
    const = {n: int(v) for n, v in re.findall(r"constexpr int (kAuc\w+) = (\d+);", src)}
    assert (const["kAucThreads"], const["kAucRowsPerThread"]) == (K1.THREADS,
                                                                 K1.ROWS_PER_THREAD)
    host = src[src.index("int coda_auc_loss("):src.index("int coda_auc_rows_per_block")]
    assert host.count("<<<") == 1                       # one launch, no finishing kernel
    geo = K1.launch_geometry(K, T)
    assert geo["launches"] == 1 and geo["grid"] == (blocks, K) and geo["ticket"] == ticket
    assert geo["threads"] == K1.THREADS and geo["rows_per_block"] == K1.ROWS_PER_BLOCK


@pytest.mark.cuda
@pytest.mark.parametrize("K,T", [(1, 7), (4, 100), (4, 513), (4, 32), (8, 4096),
                                 (3, 33_000), (2, 65_536)])
def test_auc_kernel_matches_plain_on_card(cuda_device, K, T):
    from repro_torch.kernels.auc_loss import auc_loss
    h, y, a, b, alpha = (torch.from_numpy(x).to(cuda_device)
                         for x in _auc_case(K, T, 0.71))
    got = auc_loss(h, y, a, b, alpha, 0.71)
    want = ref.auc_loss_ref(h, y, a, b, alpha, 0.71)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **AUC_TOL)
    again = auc_loss(h, y, a, b, alpha, 0.71)
    assert all(torch.equal(g, x) for g, x in zip(got, again))  # no atomics in the sums


@pytest.mark.cuda
@pytest.mark.parametrize("K,T", [(4, 32), (8, 4096), (2, 65_536)])
def test_auc_kernel_is_one_launch_on_card(cuda_device, K, T):
    """One kernel per call, as the profiler records it, and the library's
    rows per block are the wrapper's; the ticket path leaves its tickets at
    zero for the next call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    from repro_torch.kernels import auc_loss as K1
    assert _build.load().coda_auc_rows_per_block() == K1.ROWS_PER_BLOCK
    h, y, a, b, alpha = (torch.from_numpy(x).to(cuda_device) for x in _auc_case(K, T, 0.71))
    K1.auc_loss(h, y, a, b, alpha, 0.71)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        K1.auc_loss(h, y, a, b, alpha, 0.71)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len([n for n in kernels if "auc_loss" in n]) == 1, kernels
    if K1.launch_geometry(K, T)["ticket"]:
        assert int(K1._tickets[h.device].abs().sum()) == 0


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
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5, 4097, 1 << 20])
def test_prox_kernel_takes_an_fp32_step_under_bf16_params_on_card(cuda_device, N):
    """bf16 v and v0 with an fp32 direction (blocked Shampoo's step under
    bf16 parameters): bitwise the plain version, the result in bf16."""
    from repro_torch.kernels.prox_update import prox_update
    g_ = torch.Generator().manual_seed(N)
    v, g, v0 = (torch.randn(N, generator=g_).to(cuda_device, dt)
                for dt in (torch.bfloat16, torch.float32, torch.bfloat16))
    got = prox_update(v, g, v0, 0.05, 0.5)
    want = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _opt_case(n, mode, v_dtype, buf_dtype, device):
    g_ = torch.Generator().manual_seed(n)
    v, g, v0, b = (torch.randn(n, generator=g_) for _ in range(4))
    if mode == "precond":
        b = b.abs()
    return [t.to(device, v_dtype) for t in (v, g, v0)] + [b.to(device, buf_dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [5, 1000, 4097, 1 << 20])
@pytest.mark.parametrize("mode,v_dtype,buf_dtype", [
    ("momentum", torch.float32, torch.float32),
    ("momentum", torch.float32, torch.bfloat16),
    ("momentum", torch.bfloat16, torch.bfloat16),
    ("precond", torch.float32, torch.float32),
    ("precond", torch.bfloat16, torch.float32),
])
def test_opt_kernel_matches_plain_on_card(cuda_device, N, mode, v_dtype, buf_dtype):
    """Bitwise, the bf16 buffer's stochastic-rounding bits included; the
    seed is a uint32 above 2³¹ held in a device int64."""
    from repro_torch.kernels.opt_update import opt_update
    args = _opt_case(N, mode, v_dtype, buf_dtype, cuda_device)
    coef = 0.9 if mode == "momentum" else 1e-6
    seed = torch.tensor([0x9E3779B9], dtype=torch.int64, device=cuda_device)
    got = opt_update(*args, 0.05, 0.5, coef, seed, mode=mode)
    want = ref.opt_update_ref(*args, 0.05, 0.5, coef, seed, mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)


@pytest.mark.cuda
def test_opt_kernel_coef0_is_prox_kernel_on_card(cuda_device):
    from repro_torch.kernels.opt_update import opt_update
    from repro_torch.kernels.prox_update import prox_update
    v, g, v0, _ = _opt_case(4097, "momentum", torch.float32, torch.float32, cuda_device)
    seed = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    nv, nm = opt_update(v, g, v0, torch.zeros_like(v), 0.05, 0.5, 0.0, seed, mode="momentum")
    assert torch.equal(nv, prox_update(v, g, v0, 0.05, 0.5)) and torch.equal(nm, g)


@pytest.mark.cuda
def test_ops_auto_launches_on_card(cuda_device):
    from repro_torch.kernels import auc_loss as auc_mod
    from repro_torch.kernels import prox_update as prox_mod
    h, y, a, b, alpha = (torch.from_numpy(x).to(cuda_device)
                         for x in _auc_case(4, 32, 0.71))
    from repro_torch.kernels import opt_update as opt_mod
    n0, m0, o0 = auc_mod.launches, prox_mod.launches, opt_mod.launches
    ops.auc_loss(h, y, a, b, alpha, 0.71, impl="auto")
    ops.prox_update_tree({"w": h}, {"w": y}, {"w": h}, 0.1, 0.5, impl="auto")
    seed = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    ops.opt_update(h, y, h, y, 0.1, 0.5, 0.9, seed, mode="momentum", impl="auto")
    assert (auc_mod.launches, prox_mod.launches, opt_mod.launches) == (n0 + 1, m0 + 1, o0 + 1)
