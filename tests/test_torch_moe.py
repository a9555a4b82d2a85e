"""The port's MoE family (K5 grouped_matmul's plain version and dispatch,
routing, both dispatch modes, the aux loss, the layer stack, score,
prefill, CoDA training, the launcher) vs ``repro`` on the dbrx-132b and
arctic-480b smoke configs, on weights carried across with
``repro_torch.params`` and inputs made with numpy; and — on a card — the
CUDA kernel vs its plain version.

Tolerances (fp32; sums taken in another order than the reference's):
  * grouped_matmul vs ``repro.kernels.ref.grouped_matmul_ref`` and vs the
    Pallas kernel in interpret mode: atol 1e-5, rtol 1e-5 (the reference's
    own, tests/test_moe_dispatch.py:111); its gradient vs ``jax.grad``:
    atol 2e-5, rtol 2e-5;
  * ``grouped_layout``, routing choices, capacity drops, parameter counts
    and layouts: exact; gates: atol 1e-6;
  * ``apply_moe`` (both dispatches, train and eval) and its aux loss,
    scores, logits, hidden states: atol 1e-5, rtol 1e-5; bf16 caches: one
    bf16 ulp (rtol 2⁻⁷) + atol 1e-5;
  * one local step: atol 1e-5; ``fit`` on replayed windows: losses rtol
    1e-4 (atol 1e-6), parameters atol 1e-4, as for the dense family;
  * on the card, K5 vs its plain version: fp32 atol = rtol = 5e-5 (up to
    d_ff products summed in another order), bf16 one bf16 ulp (rtol 2⁻⁷) +
    atol 1e-4 — every kernel, gmm_wgmma included: bf16 products are exact
    in the fp32 accumulator and the result is rounded once.

The card cases need no jax: ``PYTHONPATH=src python -m pytest --noconftest
-q -m cuda tests/test_torch_moe.py``.
"""
import dataclasses
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import params as P
from repro_torch.configs import MOE_ARCHS, MoEConfig, get_config, get_smoke_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import moe_dispatch as md
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"atol": 1e-5, "rtol": 1e-5}
K = 2
# the reference's group tables (tests/test_moe_dispatch.py:99)
GROUP_TABLES = [[3, 0, 6, 1], [0, 0, 10, 0], [10, 0, 0, 0], [1, 2, 3, 4]]


@pytest.fixture(scope="module")
def J():
    """The reference's modules (imported here so the card cases run
    without jax)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.configs import get_smoke_config as jsmoke
    from repro.core import coda as JC
    from repro.core import schedules as JS
    from repro.data import DataConfig as JDataConfig
    from repro.data import ShardedDataset as JShardedDataset
    from repro.kernels import ref as jref
    from repro.kernels.moe_dispatch import grouped_matmul as pallas_gmm
    from repro.models import model as JM
    from repro.models import moe as JMoE
    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, get_config=jget_config, smoke=jsmoke, C=JC, S=JS,
        DataConfig=JDataConfig, ShardedDataset=JShardedDataset, ref=jref,
        pallas_gmm=pallas_gmm, M=JM, moe=JMoE)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _np(J, tree):
    return J.jax.tree_util.tree_map(np.asarray, tree)


def _jx(J, tree):
    return J.jax.tree_util.tree_map(J.jnp.asarray, tree)


def _stacked(J, init, seed, n=K):
    keys = J.jax.random.split(J.jax.random.PRNGKey(seed), n)
    return _np(J, J.jax.jit(J.jax.vmap(init))(keys))


def _perturb(J, tree, seed, scale=0.02):
    """Non-zero norm biases, so their broadcasts are tested."""
    rng = np.random.default_rng(seed)
    return J.jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, scale, x.shape).astype(x.dtype)
        if x.ndim <= 3 and x.shape[-1] > 1 else x, tree)


def _gmm_inputs(seed, gs, Kd=7, F=5, G=None):
    rng = np.random.default_rng(seed)
    N = int(sum(gs))
    x = rng.standard_normal((N, Kd)).astype(np.float32)
    w = rng.standard_normal((G or len(gs), Kd, F)).astype(np.float32)
    return x, w, np.asarray(gs, np.int32)


# --------------------------------------------------------------------------
# configs, K5's plain version, its layout and dispatch
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_are_the_references(J, arch):
    for ours, theirs in ((get_config(arch), J.get_config(arch)),
                         (get_smoke_config(arch), J.smoke(arch))):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "moe":
                assert dataclasses.asdict(a) == dataclasses.asdict(b), arch
            else:
                assert a == b, (arch, f.name)
    assert get_smoke_config(arch).head_dim == 128      # replace keeps the full head_dim


@pytest.mark.parametrize("gs", GROUP_TABLES + [[5, 9, 0, 2], [0, 0, 0, 0, 1]])
@pytest.mark.parametrize("bm", [1, 4, 8, 128])
def test_grouped_layout_matches_reference(J, gs, bm):
    N = sum(gs)
    dst, tid, n_pad = ref.grouped_layout(torch.tensor(gs, dtype=torch.int32), N, bm)
    jdst, jtid, jn = J.ref.grouped_layout(J.jnp.asarray(gs, J.jnp.int32), N, bm)
    assert n_pad == jn
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jtid))


@pytest.mark.parametrize("gs", GROUP_TABLES)
def test_grouped_matmul_matches_reference_and_pallas(J, gs):
    x, w, g = _gmm_inputs(0, gs)
    got = ref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    want = J.ref.grouped_matmul_ref(J.jnp.asarray(x), J.jnp.asarray(w), J.jnp.asarray(g))
    pallas = J.pallas_gmm(J.jnp.asarray(x), J.jnp.asarray(w), J.jnp.asarray(g), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    # the wrapper gives the plain version for CPU tensors
    np.testing.assert_array_equal(
        md.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g)).numpy(),
        got.numpy())


def test_grouped_matmul_small_blocks_matches_pallas(J):
    """The reference's multi-tile case (block_m=8 below the segments)."""
    x, w, g = _gmm_inputs(1, [5, 9, 0, 2], Kd=4, F=6)
    got = ref.grouped_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g))
    want = J.pallas_gmm(J.jnp.asarray(x), J.jnp.asarray(w), J.jnp.asarray(g),
                        block_m=8, block_n=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_matmul_gradient_matches_jax_grad(J):
    x, w, g = _gmm_inputs(2, [3, 0, 6, 1])
    ct = np.random.default_rng(2).standard_normal((10, 5)).astype(np.float32)
    jg = J.jax.jit(J.jax.grad(
        lambda a, b: J.jnp.sum(J.ref.grouped_matmul_ref(a, b, J.jnp.asarray(g)) * ct),
        argnums=(0, 1)))(J.jnp.asarray(x), J.jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = ref.grouped_matmul_ref(tx, tw, torch.from_numpy(g))
    gx, gw = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (tx, tw))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg[0]), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg[1]), atol=2e-5, rtol=2e-5)


def test_k_folded_groups_equal_per_replica_calls():
    """A layer's slice of a stacked [R, L, E, Kd, F] leaf, read in place as
    R·E groups, gives what one call per replica gives."""
    R, L, E, Kd, F = 3, 2, 4, 6, 5
    rng = np.random.default_rng(3)
    stack = torch.from_numpy(rng.standard_normal((R, L, E, Kd, F)).astype(np.float32))
    w = stack[:, 1]                                     # strided, not contiguous
    assert not w.is_contiguous()
    sizes = torch.from_numpy(rng.integers(0, 4, (R, E)))
    x = torch.from_numpy(rng.standard_normal((int(sizes.sum()), Kd)).astype(np.float32))
    got = ops.grouped_matmul(x, w, sizes.reshape(-1))
    rows = sizes.sum(1).tolist()
    want = torch.cat([ref.grouped_matmul_ref(xr, w[r], sizes[r])
                      for r, xr in enumerate(torch.split(x, rows))])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert md.weight_layout(w) == (R * E, E, L * E * Kd * F, Kd * F, F)


def test_grouped_matmul_rejects_bad_inputs():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="do not tile"):
        ref.grouped_matmul_ref(x, torch.zeros((2, 3, 5)), torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="group_sizes"):
        md.grouped_matmul(x, torch.zeros((2, 3, 5)), torch.tensor([4]))
    with pytest.raises(ValueError, match="wants x"):
        md.grouped_matmul(x, torch.zeros((2, 4, 5)), torch.tensor([2, 2]))


def test_ops_grouped_matmul_dispatch():
    x, w, g = (torch.from_numpy(a) for a in _gmm_inputs(4, [2, 3]))
    plain = ref.grouped_matmul_ref(x, w, g)
    before = md.launches
    for impl in ("auto", "ref"):
        assert torch.equal(ops.grouped_matmul(x, w, g, impl=impl), plain)
    assert md.launches == before                       # the CPU never launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.grouped_matmul(x, w, g, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.grouped_matmul(x, w, g, impl="pallas")


@pytest.mark.parametrize("N,Kd,G,F,kernel,grid", [
    (16, 6144, 16, 10752, "gmm_rows", (18, 84)),       # dbrx decode, gate/up
    (16, 10752, 16, 6144, "gmm_rows", (18, 48)),       # dbrx decode, down
    (8192, 6144, 16, 10752, "gmm_tiles", (80, 84)),    # dbrx prefill (128-row tiles)
    (8, 7168, 128, 4864, "gmm_rows", (9, 38)),         # arctic decode shape, fp32
    (4096, 7168, 128, 4864, "gmm_tiles", (160, 38)),   # arctic prefill shape, fp32
    (1, 7, 4, 5, "gmm_rows", (2, 1)),
])
def test_launch_geometry(N, Kd, G, F, kernel, grid):
    geo = md.launch_geometry(N, Kd, G, F)
    assert geo["kernel"] == kernel and geo["grid"] == grid
    # the grid bound is the reference's grouped_layout bound, in tiles
    assert geo["grid"][0] * geo["bm"] == ref._round_up(N, geo["bm"]) + min(G, N) * geo["bm"]


@pytest.mark.parametrize("N,Kd,G,F,dtype,tma_ok,kernel,bn", [
    # bf16, aligned: the tensor-core kernel, 128 columns below 16 rows per group
    (8, 7168, 128, 4864, torch.bfloat16, True, "gmm_wgmma", 128),      # arctic decode
    (4096, 7168, 128, 4864, torch.bfloat16, True, "gmm_wgmma", 256),   # arctic prefill
    (8192, 6144, 16, 10752, torch.bfloat16, True, "gmm_wgmma", 256),   # dbrx in bf16
    (1, 6144, 4, 1000, torch.bfloat16, True, "gmm_wgmma", 128),        # N = 1
    (273, 136, 5, 520, torch.bfloat16, True, "gmm_wgmma", 256),        # aligned ragged
    # bf16 that TMA cannot read keeps the FFMA kernels
    (10, 130, 4, 515, torch.bfloat16, True, "gmm_rows", 128),          # Kd, F off 8
    (273, 96, 4, 300, torch.bfloat16, True, "gmm_tiles", 128),         # F off 8
    (4096, 7168, 128, 4864, torch.bfloat16, False, "gmm_tiles", 128),  # strides/bases
    (8, 7168, 128, 4864, torch.bfloat16, False, "gmm_rows", 128),
    # fp32: FFMA by rows per group
    (16, 6144, 16, 10752, torch.float32, True, "gmm_rows", 128),
    (8192, 6144, 16, 10752, torch.float32, True, "gmm_tiles", 128),
])
def test_launch_geometry_picks_the_variant(N, Kd, G, F, dtype, tma_ok, kernel, bn):
    geo = md.launch_geometry(N, Kd, G, F, dtype, tma_ok)
    assert (geo["kernel"], geo["bn"]) == (kernel, bn)
    assert geo["grid"] == (-(-N // geo["bm"]) + min(G, N), -(-F // bn))
    assert geo["smem_bytes"] <= 232_448        # a block's shared memory on Hopper
    if kernel == "gmm_wgmma":
        assert geo["bm"] == 64 and geo["threads"] == 160
        assert geo["smem_bytes"] == md.wgmma_smem(bn) and geo["stages"] == md.WG_STAGES[bn]
    if kernel == "gmm_tiles":
        assert (geo["bm"], geo["bn"], geo["threads"]) == (128, 128, 256)


def test_tma_and_vec_alignment_are_read_from_the_tensors():
    w = torch.zeros((2, 3, 16, 24), dtype=torch.bfloat16)
    x = torch.zeros((5, 16), dtype=torch.bfloat16)
    assert md.tma_aligned(x, w) and md.tma_aligned(x, w[:, 1])   # strided K-fold slice
    assert md.tma_aligned(x, w[0])
    assert not md.tma_aligned(x, w[..., 4:])                     # base 8 bytes in
    assert not md.tma_aligned(x[:, 4:].contiguous()[1:], w[0])   # x base off 16 bytes
    assert not md.tma_aligned(x, torch.zeros((2, 16, 20), dtype=torch.bfloat16)[:, :, :12])
    f = torch.zeros((2, 16, 24))
    assert md.vec_aligned(f) and md.vec_aligned(f[:, :, :20])
    assert not md.vec_aligned(f[:, :, :22]) and not md.vec_aligned(f[:, :, 1:21])


def test_variant_counters_start_at_zero_and_the_cpu_never_counts():
    assert set(md.variant_launches) == {"gmm_rows", "gmm_tiles", "gmm_wgmma"}
    x, w, g = (torch.from_numpy(a) for a in _gmm_inputs(3, [2, 3], Kd=8, F=8))
    md.launches, md.variant_launches["gmm_wgmma"] = 5, 2
    md.grouped_matmul(x.bfloat16(), w.bfloat16(), g)
    assert md.launches == 5 and md.variant_launches["gmm_wgmma"] == 2
    md.zero_launches()
    assert md.launches == 0 and set(md.variant_launches.values()) == {0}


def test_build_knows_the_moe_source(tmp_path, monkeypatch):
    """K5's source joins the one library: editing it renames the library,
    and its entry points are declared."""
    moe_src = tmp_path / "moe.cu"
    moe_src.write_text("// one")
    monkeypatch.setattr(_build, "MOE_SOURCE", moe_src)
    first = _build.library_path()
    moe_src.write_text("// two")
    assert _build.library_path() != first
    assert moe_src in _build.sources() and len(_build.sources()) == 3
    assert {"grouped_matmul", "grouped_matmul_geometry"} <= set(_build._SIGNATURES)


# --------------------------------------------------------------------------
# routing and the two dispatches
# --------------------------------------------------------------------------
def _moe_pair(J, arch, seed, **moe_kw):
    jcfg, cfg = J.smoke(arch), get_smoke_config(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    tree = _stacked(J, lambda k: J.moe.init_moe(k, jcfg), seed)
    return jcfg, cfg, tree


def _x(seed, cfg, B=3, S=7):
    return (0.5 * np.random.default_rng(seed).standard_normal((K, B, S, cfg.d_model))
            ).astype(np.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_matches_reference_with_ties_to_the_lower_expert(J, arch):
    jcfg, cfg, tree = _moe_pair(J, arch, 10)
    x = _x(10, cfg).reshape(K, -1, cfg.d_model)
    x[:, :3] = 0.0                                    # equal gates: a tie
    tg, te, gates = J.jax.jit(J.jax.vmap(lambda p, a: J.moe.route(jcfg, p, a)))(
        _jx(J, tree), J.jnp.asarray(x))
    g, e, gt = moe.route(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x))
    np.testing.assert_array_equal(e.numpy(), np.asarray(te))
    assert e[:, :3].tolist() == [[list(range(cfg.moe.top_k))] * 3] * K
    np.testing.assert_allclose(g.numpy(), np.asarray(tg), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gates), atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dispatch,train", [("sorted", False), ("capacity", False),
                                            ("sorted", True)])
def test_apply_moe_matches_reference(J, arch, dispatch, train):
    """Eval under both dispatches (capacity at C = T) and train-time
    capacity dispatch with drops, the aux loss included."""
    jcfg, cfg, tree = _moe_pair(J, arch, 11, dispatch=dispatch)
    x = _x(11, cfg)
    out, aux = J.jax.jit(J.jax.vmap(lambda p, a: J.moe.apply_moe(jcfg, p, a, train=train)))(
        _jx(J, tree), J.jnp.asarray(x))
    got, gaux = moe.apply_moe(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x),
                              train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(gaux.numpy(), np.asarray(aux), **TOL)


def test_capacity_drops_exactly_the_references_pairs(J):
    """A tight capacity factor drops most pairs; the port drops the same
    (token, choice) pairs as the reference's mode="drop" scatter: with the
    expert MLP replaced by the identity-like probe below, the surviving
    gate mass per token must match."""
    jcfg, cfg, tree = _moe_pair(J, "dbrx-132b", 12, capacity_factor=0.25)
    x = _x(12, cfg, B=2, S=16)
    T = 32
    C = moe.capacity(cfg, T, train=True)
    assert C == J.moe.capacity(jcfg, T, train=True) == 4
    assert C * cfg.moe.n_experts < T * cfg.moe.top_k          # pairs are dropped
    out, _ = J.jax.jit(J.jax.vmap(lambda p, a: J.moe.apply_moe(jcfg, p, a, train=True)))(
        _jx(J, tree), J.jnp.asarray(x))
    got, _ = moe.apply_moe(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), **TOL)
    dropped = (np.abs(np.asarray(out)).sum(-1) == 0).sum()
    assert dropped > 0 and (got.abs().sum(-1) == 0).sum().item() == dropped


def test_aux_loss_at_k1_is_the_top1_count():
    cfg = dataclasses.replace(get_smoke_config("dbrx-132b"),
                              moe=MoEConfig(n_experts=4, top_k=1))
    p = tree_map(lambda t: t[None], moe.init_moe(cfg, M.ParamInit(torch.Generator().manual_seed(0))))
    x = torch.randn((1, 2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    _, aux = moe.apply_moe(cfg, p, x)
    _, top_e, gates = moe.route(cfg, p, x.reshape(1, -1, cfg.d_model))
    want = 4 * torch.sum(gates.mean(1) * torch.nn.functional.one_hot(top_e[..., 0], 4)
                         .float().mean(1), -1)
    assert torch.equal(aux, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sorted_gradient_matches_jax_grad(J, arch):
    jcfg, cfg, tree = _moe_pair(J, arch, 13)
    x = _x(13, cfg, B=1, S=5)
    ct = np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    f = lambda p, a: J.jnp.sum(J.jax.vmap(lambda pp, aa: J.moe.apply_moe(jcfg, pp, aa)[0])(p, a) * ct)
    jg = J.jax.jit(J.jax.grad(f, argnums=(0, 1)))(_jx(J, tree), J.jnp.asarray(x))
    pt = P.from_jax_params(cfg, tree)
    leaves = [l.requires_grad_() for l in tree_leaves(pt)]
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = moe.apply_moe(cfg, pt, tx)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves + [tx],
                                allow_unused=True)
    want = J.jax.tree_util.tree_leaves(jg[0]) + [jg[1]]
    for g, w in zip(grads, want, strict=True):
        g = torch.zeros(w.shape) if g is None else g      # the router's, via top-k values
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def test_dispatch_buffer_bytes_and_unknown_dispatch(J):
    cfg, jcfg = get_config("arctic-480b"), J.get_config("arctic-480b")
    for mode in ("sorted", "capacity"):
        for T in (1, 4096, 32768):
            assert moe.dispatch_buffer_bytes(cfg, T, mode=mode) == \
                J.moe.dispatch_buffer_bytes(jcfg, T, mode=mode)
    assert moe.dispatch_buffer_bytes(cfg, 32768, mode="sorted", dtype=torch.bfloat16) == \
        32768 * 2 * 7168 * 2
    with pytest.raises(ValueError, match="unknown dispatch mode"):
        moe.dispatch_buffer_bytes(cfg, 8, mode="dense")
    with pytest.raises(ValueError, match="unknown moe dispatch"):
        MoEConfig(n_experts=4, top_k=2, dispatch="scatter")


# --------------------------------------------------------------------------
# the model: params, score, prefill, CoDA, launcher
# --------------------------------------------------------------------------
_TREES = {}


def _model_pair(J, arch):
    """The smoke config's K reference replicas (drawn once per arch)."""
    jcfg, cfg = J.smoke(arch), get_smoke_config(arch)
    if arch not in _TREES:
        _TREES[arch] = _perturb(J, _stacked(J, lambda k: J.M.init_params(k, jcfg), 20), 20)
    return jcfg, cfg, _TREES[arch]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_round_trip_and_layout(J, arch):
    jcfg, cfg, tree = _model_pair(J, arch)
    port = P.from_jax_params(cfg, tree)
    jl = J.jax.tree_util.tree_leaves(tree)
    assert [tuple(t.shape) for t in tree_leaves(port)] == [x.shape for x in jl]
    m = cfg.moe
    assert tuple(port["layers"]["moe"]["w_gate"].shape) == (
        K, cfg.n_layers, m.n_experts, cfg.d_model, cfg.d_ff)
    for a, b in zip(jl, J.jax.tree_util.tree_leaves(P.to_jax_params(cfg, port))):
        np.testing.assert_array_equal(a, b)
    own = M.init_params(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert [tuple(t.shape) for t in tree_leaves(own)] == [x.shape[1:] for x in jl]
    assert own["layers"]["moe"]["router"].dtype == torch.float32     # moe.py:62
    assert own["layers"]["moe"]["w_up"].dtype == torch.bfloat16


def test_dbrx_two_full_width_layers_parameter_count(J):
    """7,751,337,985 parameters in 18 leaves at 2 of dbrx-132b's 40 layers,
    as ``jax.eval_shape`` of the reference's init counts them."""
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2)
    leaves = tree_leaves(M.init_params(cfg, device="meta"))
    shapes = J.jax.eval_shape(
        lambda k: J.M.init_params(k, dataclasses.replace(J.get_config("dbrx-132b"), n_layers=2)),
        J.jax.ShapeDtypeStruct((2,), J.jnp.uint32))
    jl = J.jax.tree_util.tree_leaves(shapes)
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jl]
    assert len(leaves) == 18 and sum(t.numel() for t in leaves) == 7_751_337_985


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_score_matches_reference(J, arch):
    jcfg, cfg, tree = _model_pair(J, arch)
    tok = np.random.default_rng(21).integers(0, cfg.vocab_size, (K, 3, 12)).astype(np.int32)
    for train in (False, True):
        want, aux = J.jax.jit(J.jax.vmap(
            lambda p, t: J.M.score(jcfg, p, {"tokens": t}, train=train)))(
            _jx(J, tree), J.jnp.asarray(tok))
        got, gaux = M.score(cfg, P.from_jax_params(cfg, tree),
                            {"tokens": torch.from_numpy(tok)}, train=train)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(gaux.numpy(), np.asarray(aux), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_step_matches_reference(J, arch):
    jcfg, cfg, tree = _model_pair(J, arch)
    tok = np.random.default_rng(22).integers(0, cfg.vocab_size, (K, 2, 16)).astype(np.int32)
    s, logits, (kc, vc) = J.jax.jit(J.jax.vmap(
        lambda p, t: J.M.prefill_step(jcfg, p, {"tokens": t})))(_jx(J, tree), J.jnp.asarray(tok))
    gs, glog, (gk, gv) = M.prefill_step(cfg, P.from_jax_params(cfg, tree),
                                        {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(gs.numpy(), np.asarray(s), atol=1e-5)
    np.testing.assert_allclose(glog.numpy(), np.asarray(logits), **TOL)
    assert tuple(gk.shape) == kc.shape == (K, cfg.n_layers, 2, 16, cfg.n_kv_heads, 128)
    for g, w in ((gk, kc), (gv, vc)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=2 ** -7, atol=1e-5)


def _coda_pair(J, arch, K_, seed):
    jcfg, cfg = J.smoke(arch), get_smoke_config(arch)
    jccfg = J.C.CoDAConfig(n_workers=K_, p_pos=0.7)
    from repro_torch.core import coda as C
    ccfg = C.CoDAConfig(n_workers=K_, p_pos=0.7)
    jst = _np(J, J.jax.jit(lambda k: J.C.init_state(k, jcfg, jccfg))(J.jax.random.PRNGKey(seed)))
    return jcfg, cfg, jccfg, ccfg, jst, P.state_from_jax(cfg, ccfg, jst)


def test_local_step_matches_reference(J):
    """One MoE local step on arctic-480b's smoke config (dense residual):
    capacity dispatch with drops, the aux loss at moe_aux_coef, the prox
    step."""
    from repro_torch.core import coda as C
    jcfg, cfg, jccfg, ccfg, jst, st = _coda_pair(J, "arctic-480b", 3, 30)
    rng = np.random.default_rng(30)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 6, 16)).astype(np.int32),
             "labels": (rng.random((3, 6)) < 0.7).astype(np.float32)}
    jnew, jloss = J.jax.jit(lambda s_, b_: J.C.local_step(jcfg, jccfg, s_, b_, 0.5))(
        _jx(J, jst), _jx(J, batch))
    new, loss = C.local_step(cfg, ccfg, st, {k: torch.from_numpy(v) for k, v in batch.items()},
                             0.5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-5)
    got, want = P.state_to_jax(cfg, new), _np(J, jnew)
    for field in ("params", "duals"):
        for g, w in zip(J.jax.tree_util.tree_leaves(got[field]),
                        J.jax.tree_util.tree_leaves(want[field]), strict=True):
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=field)


def test_fit_matches_reference_on_replayed_windows(J):
    """dbrx-132b --smoke through the reference's ``fit`` (K=4, 1 stage,
    T0=4, I=2, token batches of length 8 drawn with numpy) with recording
    samplers, replayed through the port's ``fit`` from the same initial
    state."""
    from repro_torch.core import coda as C
    from repro_torch.core import schedules as S
    jcfg, cfg = J.smoke("dbrx-132b"), get_smoke_config("dbrx-132b")
    K_, I, Bsz, p_pos = 4, 2, 8, 0.71
    key = J.jax.random.PRNGKey(31)
    rng = np.random.default_rng(31)
    jccfg = J.C.CoDAConfig(n_workers=K_, p_pos=p_pos)
    ccfg = C.CoDAConfig(n_workers=K_, p_pos=p_pos)
    kw = dict(n_workers=K_, eta0=0.5, T0=4, I0=I)
    windows, alphas = [], []

    def draw(store, lead):
        y = (rng.random(lead) < p_pos).astype(np.float32)
        tok = rng.integers(0, cfg.vocab_size, lead + (8,)).astype(np.int32)
        tok[..., :2] = np.where(y[..., None] > 0, 3, tok[..., :2])    # a planted signal
        store.append({"tokens": tok, "labels": y})
        return store[-1]

    jres = J.C.fit(key, jcfg, jccfg, J.S.ScheduleConfig(**kw), 1,
                   sample_window=lambda k, i: draw(windows, (i, K_, Bsz)),
                   sample_alpha_batch=lambda k, m: draw(alphas, (K_, m)))
    st0 = P.state_from_jax(cfg, ccfg, _np(J, J.C.init_state(key, jcfg, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    tt = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    res = C.fit(st0, cfg, ccfg, S.ScheduleConfig(**kw), 1,
                sample_window=lambda i: tt(next(wit)),
                sample_alpha_batch=lambda m: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds) == (4, 3)
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(cfg, res.state)
    for g, w in zip(J.jax.tree_util.tree_leaves(got["params"]),
                    J.jax.tree_util.tree_leaves(_np(J, jres.state["params"])), strict=True):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_moe_refuses_axis_order_optimizers(J):
    """sm3 and shampoo_blocked were refused on the moe family while
    ``params.ref_order`` read every 5-D leaf as a convolution; now the
    convolutions are found by their place in the tree, and ``init_state``
    builds their state with the reference's shapes: the expert leaves
    ``[K, L, E, d, ff]`` keep their axis order."""
    from repro_torch.core import coda as C
    cfg = get_smoke_config("dbrx-132b")
    for name in ("sm3", "shampoo_blocked"):
        st = C.init_state(cfg, C.CoDAConfig(n_workers=2, optimizer=name, shampoo_block=8))
        jst = J.jax.eval_shape(lambda k: J.C.init_state(
            k, J.smoke("dbrx-132b"), J.C.CoDAConfig(n_workers=2, optimizer=name,
                                                      shampoo_block=8)),
            J.jax.random.PRNGKey(0))
        assert [tuple(t.shape) for t in tree_leaves(st["opt"])] == \
            [x.shape for x in J.jax.tree_util.tree_leaves(jst["opt"])]
    assert not any(P.conv_flags(st["params"]))


@pytest.mark.parametrize("optimizer", ["sm3", "shampoo_blocked"])
def test_axis_order_optimizers_match_reference(J, optimizer):
    """The same gradients through both packages' ``apply_grads`` on
    dbrx-132b's smoke config (expert leaves ``[K, L, E, d, ff]``): sm3's
    accumulators bitwise and parameters at atol 1e-6 (the port's 1/√x
    against XLA's rsqrt); Shampoo (8-wide blocks over the reference's
    flattening) statistics bitwise, preconditioners at atol 1e-4 and
    parameters at atol 1e-5, as tests/test_torch_optimizer.py holds them."""
    from repro_torch.core import coda as C
    jcfg, cfg = J.smoke("dbrx-132b"), get_smoke_config("dbrx-132b")
    kw = dict(n_workers=K, p_pos=0.7, optimizer=optimizer, shampoo_block=8)
    jccfg, ccfg = J.C.CoDAConfig(**kw), C.CoDAConfig(**kw)
    jst = _np(J, J.jax.jit(lambda k: J.C.init_state(k, jcfg, jccfg))(J.jax.random.PRNGKey(32)))
    st = P.state_from_jax(cfg, ccfg, jst)
    rng = np.random.default_rng(32)
    jgp = J.jax.tree_util.tree_map(
        lambda l: (0.1 * rng.standard_normal(l.shape)).astype(np.float32), jst["params"])
    jgd = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in jst["duals"].items()}
    want = _np(J, J.jax.jit(lambda s_, g_: J.C.apply_grads(jccfg, s_, g_, J.jnp.float32(0.05)))(
        _jx(J, jst), (_jx(J, jgp), _jx(J, jgd))))
    gd = {k: torch.from_numpy(v) for k, v in jgd.items()}
    got = P.state_to_jax(cfg, C.apply_grads(ccfg, st, (P.from_jax_params(cfg, jgp), gd), 0.05),
                         ccfg)
    if optimizer == "sm3":
        fields = (("opt", 0), ("params", 1e-6))
    else:
        fields = (("s", 0), ("p", 1e-4), ("params", 1e-5))
    leaves = J.jax.tree_util.tree_leaves
    for field, atol in fields:
        if field in ("s", "p"):
            pairs = zip([l[field] for l in got["opt"]["leaves"]],
                        [l[field] for l in want["opt"]["leaves"]], strict=True)
        else:
            pairs = zip(leaves(got[field]), leaves(want[field]), strict=True)
        for g, w in pairs:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=field)


def test_launcher_runs_dbrx_smoke_on_cpu(J):
    """``--arch dbrx-132b --smoke --device cpu`` (depth cut to 1 by
    ``--n-layers``): the reference's output lines, with the reference's
    parameter count and bytes per round at that depth."""
    env = one_thread_env()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--arch", "dbrx-132b", "--smoke", "--n-layers", "1", "--stages", "1",
                          "--t0", "4", "--interval", "2", "--batch", "8", "--n-data", "256"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = J.M.count_params(dataclasses.replace(J.smoke("dbrx-132b"), n_layers=1))
    assert f"model: dbrx-132b params/worker={n:,} leaves=18 device=cpu" in out.stdout
    assert re.search(r"^done: 4 iters, 3 comm rounds, [\d.]+s, test AUC=\d\.\d{4}$",
                     out.stdout, re.M), out.stdout
    assert f"bytes/round/worker={(n + 3) * 4:,} " in out.stdout


def test_launcher_counts_grouped_matmul_in_eval_forwards_only():
    """On the CPU nothing launches; the counters' bookkeeping is the
    launcher's ``KERNELS`` table, which now lists K5."""
    from repro_torch.launch import train
    assert train.KERNELS["grouped_matmul"] is md
    assert train.data_config_for(get_smoke_config("arctic-480b"), 0.7).kind == "tokens"


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
CARD_CASES = [
    # group sizes, Kd, F, dtype
    ([3, 0, 6, 1], 7, 5, torch.float32),
    ([0, 0, 10, 0], 130, 515, torch.float32),          # ragged Kd and F
    ([10, 0, 0, 0], 64, 128, torch.bfloat16),
    ([1, 2, 3, 4], 33, 1000, torch.float32),
    ([1], 16, 16, torch.float32),                       # N = 1
    ([70, 0, 200, 3], 96, 300, torch.float32),          # the 128-row tiles
    ([70, 0, 200, 3], 96, 300, torch.bfloat16),
]

# gmm_wgmma (bf16, Kd and F multiples of 8): group sizes, Kd, F
WGMMA_CASES = [
    ([70, 0, 200, 3, 0], 136, 520),     # aligned ragged groups, empty groups, Kd off 64
    ([0, 1, 0, 0], 6144, 1000),         # N = 1, F off the 128/256 column tiles
    ([130, 5, 0, 64], 64, 256),         # a group across three 64-row tiles
    ([3, 0, 0, 2] * 8, 256, 512),       # decode: under 16 rows per group
]


@pytest.mark.cuda
@pytest.mark.parametrize("gs,Kd,F,dt", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, gs, Kd, F, dt):
    g = torch.Generator().manual_seed(sum(gs) + Kd)
    x = torch.randn((sum(gs), Kd), generator=g).to(cuda_device, dt)
    w = (torch.randn((len(gs), Kd, F), generator=g) * Kd ** -0.5).to(cuda_device, dt)
    sizes = torch.tensor(gs, dtype=torch.int32, device=cuda_device)
    before = md.launches
    got = md.grouped_matmul(x, w, sizes)
    torch.cuda.synchronize()
    assert md.launches == before + 1 and got.dtype == dt
    want = ref.grouped_matmul_ref(x, w, sizes)
    atol, rtol = (5e-5, 5e-5) if dt == torch.float32 else (1e-4, 2 ** -7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("gs,Kd,F", WGMMA_CASES)
def test_wgmma_kernel_matches_plain_on_card(cuda_device, gs, Kd, F):
    g = torch.Generator().manual_seed(sum(gs) + Kd + F)
    x = torch.randn((sum(gs), Kd), generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn((len(gs), Kd, F), generator=g) * Kd ** -0.5).to(cuda_device, torch.bfloat16)
    sizes = torch.tensor(gs, dtype=torch.int32, device=cuda_device)
    before = md.variant_launches["gmm_wgmma"]
    got = md.grouped_matmul(x, w, sizes)
    torch.cuda.synchronize()
    assert md.variant_launches["gmm_wgmma"] == before + 1
    want = ref.grouped_matmul_ref(x, w, sizes)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dt,kernel", [(torch.bfloat16, "gmm_wgmma"), (torch.float32, "gmm_tiles")])
def test_tile_kernels_read_a_strided_k_folded_stack_on_card(cuda_device, dt, kernel):
    """A [4, 2, 16, 128, 256] stack's layer slice, 4 × 16 groups, through
    the bf16 TMA maps and the fp32 cp.async tiles (≥ 16 rows per group)."""
    R, L, E, Kd, F = 4, 2, 16, 128, 256
    g = torch.Generator().manual_seed(9)
    stack = (torch.randn((R, L, E, Kd, F), generator=g) * Kd ** -0.5).to(cuda_device, dt)
    sizes = torch.randint(16, 40, (R * E,), generator=g).to(cuda_device)
    x = torch.randn((int(sizes.sum()), Kd), generator=g).to(cuda_device, dt)
    before = md.variant_launches[kernel]
    got = md.grouped_matmul(x, stack[:, 1], sizes)
    torch.cuda.synchronize()
    assert md.variant_launches[kernel] == before + 1
    atol, rtol = (5e-5, 5e-5) if dt == torch.float32 else (1e-4, 2 ** -7)
    torch.testing.assert_close(got.float(), ref.grouped_matmul_ref(x, stack[:, 1], sizes).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_reads_a_strided_k_folded_slice_on_card(cuda_device):
    R, L, E, Kd, F = 4, 2, 16, 40, 72
    g = torch.Generator().manual_seed(5)
    stack = torch.randn((R, L, E, Kd, F), generator=g).to(cuda_device)
    sizes = torch.randint(0, 5, (R * E,), generator=g).to(cuda_device)
    x = torch.randn((int(sizes.sum()), Kd), generator=g).to(cuda_device)
    got = md.grouped_matmul(x, stack[:, 1], sizes)
    torch.testing.assert_close(got, ref.grouped_matmul_ref(x, stack[:, 1], sizes),
                               atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_kernel_refuses_autograd_on_card(cuda_device):
    x = torch.randn((4, 8), device=cuda_device, requires_grad=True)
    w = torch.randn((2, 8, 8), device=cuda_device)
    with pytest.raises(RuntimeError, match="forward only"):
        md.grouped_matmul(x, w, torch.tensor([1, 3], device=cuda_device))
    with torch.no_grad():
        assert md.grouped_matmul(x, w, torch.tensor([1, 3], device=cuda_device)).shape == (4, 8)


@pytest.mark.cuda
def test_kernel_tiles_are_the_wrappers_geometry_on_card(cuda_device):
    """The CUDA source's tile constants are the ones ``launch_geometry``
    computes the grid from."""
    import ctypes
    got = (ctypes.c_int * 9)()
    _build.load().grouped_matmul_geometry(ctypes.addressof(got))
    assert list(got) == [md.ROWS_BM, md.ROWS_BN, md.TILE_BM, md.TILE_BN, md.MAX_GROUPS,
                         md.TILE_SMEM, md.WG_BM, md.wgmma_smem(128), md.wgmma_smem(256)]
