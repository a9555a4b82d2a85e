"""The executors' buffer donation (``coda.make_executor(..., donate=True)``,
the reference's default): a donated window, pair or stage end consumes its
state and writes every step into it, bitwise the same run with
``donate=False``.

Port-only: both sides of every comparison run the port, on the same state
made from a seed and the same numpy windows.  Covered: every optimizer
(sgd, momentum with an fp32 and a bf16 buffer, sm3, shampoo_blocked
refreshing every step and every second step) under CoDA and CODASCA; the
masked averaging (plain and int8), server momentum, int8 averaging, the
sketch, bf16 parameters and the pauc_dro duals; a stage boundary in every
run (the ``ref_params`` trap: the next window's in-place K2 must not reach
the proximal reference); crash-resume against the uninterrupted run; the
sharded executor on 2 gloo ranks with and without the overlapped pair;
the handed-over state's emptied containers; and the in-place K2/K3
wrappers against their out-of-place forms.  On the card the same wrapper
comparisons run the kernels (``cuda``-marked, skipped here).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import mlp_config
from repro_torch.core import coda as C
from repro_torch.core import optimizer as O
from repro_torch.core import schedules as S
from repro_torch.core.faults import FaultPlan
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.kernels import ops as kops
from repro_torch.kernels import opt_update as kopt
from repro_torch.kernels import prox_update as kprox
from repro_torch.launch import mesh as PM
from repro_torch.tree import tree_leaves, tree_map, tree_paths
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)
import _torch_donate_ranks as DR

MCFG = mlp_config(n_features=8, d=16)
K, I, B = 4, 2, 4

OPTIMIZERS = {
    "sgd": {},
    "momentum": dict(optimizer="momentum"),
    "momentum_bf16_buffer": dict(optimizer="momentum", opt_dtype=torch.bfloat16),
    "sm3": dict(optimizer="sm3"),
    "shampoo_every_step": dict(optimizer="shampoo_blocked", shampoo_block=8),
    "shampoo_every_2": dict(optimizer="shampoo_blocked", shampoo_block=8, precond_every=2),
}
PATHS = {
    "masked": dict(participation=0.75, straggler_prob=0.2, max_staleness=1, fault_seed=3),
    "masked_codasca": dict(algorithm="codasca", participation=0.75, straggler_prob=0.2,
                           straggler_windows=2, max_staleness=2, fault_seed=3),
    "masked_int8": dict(participation=0.75, avg_compress="int8", fault_seed=4),
    "server_momentum": dict(server_momentum=0.9, optimizer="momentum"),
    "server_momentum_codasca": dict(algorithm="codasca", server_momentum=0.5),
    "int8": dict(avg_compress="int8", optimizer="sm3"),
    "int8_codasca": dict(algorithm="codasca", avg_compress="int8"),
    "sketch": dict(stream_bins=32),
    "sketch_codasca_masked": dict(algorithm="codasca", stream_bins=32, participation=0.75),
    "bf16_params": dict(param_dtype=torch.bfloat16, optimizer="shampoo_blocked",
                        shampoo_block=8),
    "pauc_dro": dict(objective="pauc_dro", optimizer="momentum"),
}


def _window(seed, n=I):
    g = np.random.default_rng(seed)
    y = (g.random((n, K, B)) < 0.6).astype(np.float32)
    x = g.standard_normal((n, K, B, 8)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": torch.from_numpy(x), "labels": torch.from_numpy(y)}


def _alpha(seed):
    return {k: v[0] for k, v in _window(seed, 1).items()}


def _faults(ccfg, w):
    if not ccfg.faults_enabled:
        return None
    u, r = FaultPlan.from_config(ccfg).window(w)
    return {"weights": torch.from_numpy(u), "resync": torch.from_numpy(r)}


def _state(ccfg):
    return C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))


def _snap(state) -> dict:
    return {p: t.clone() for p, t in zip(tree_paths(state), tree_leaves(state))}


def _run(ccfg, donate: bool):
    """Five windows with stage ends after the second and the fourth: the
    end state, the losses, and how many leaves the windows after the first
    stage end handed back in the storage they were given."""
    exe = C.make_executor(MCFG, ccfg, donate=donate)
    st, losses, kept = _state(ccfg), [], []
    for w in range(5):
        ptrs = [t.untyped_storage().data_ptr() for t in tree_leaves(st)]
        st, lo = exe.window_step(st, _window(w), 0.3, faults=_faults(ccfg, w))
        kept.append(sum(t.untyped_storage().data_ptr() == p
                        for t, p in zip(tree_leaves(st), ptrs)))
        losses.append(lo.clone())
        if w in (1, 3):
            st = exe.stage_end(st, _alpha(100 + w))
    return _snap(st), torch.stack(losses), kept, len(tree_leaves(st))


def _assert_bitwise(a: dict, b: dict):
    assert list(a) == list(b)
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p


@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_donated_windows_are_bitwise_the_undonated_ones(opt, algorithm):
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, algorithm=algorithm, **OPTIMIZERS[opt])
    got, got_loss, kept, n = _run(ccfg, True)
    want, want_loss, moved, _ = _run(ccfg, False)
    _assert_bitwise(got, want)
    assert torch.equal(got_loss, want_loss)
    assert kept == [n] * 5                  # every leaf written in place
    assert max(moved) < n                   # without donation: new tensors


@pytest.mark.parametrize("path", list(PATHS))
def test_donated_paths_are_bitwise_the_undonated_ones(path):
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, **PATHS[path])
    got, got_loss, kept, n = _run(ccfg, True)
    want, want_loss, _, _ = _run(ccfg, False)
    _assert_bitwise(got, want)
    assert torch.equal(got_loss, want_loss)
    assert kept == [n] * 5


@pytest.mark.parametrize("opt", ["sgd", "momentum", "shampoo_every_2"])
def test_stage_end_gives_the_proximal_reference_its_own_buffers(opt):
    """After a donated stage end the references hold the iterate in buffers
    of their own; the next window's in-place writes leave them as they were,
    and its proximal steps pull toward them."""
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, **OPTIMIZERS[opt])
    exe = C.make_executor(MCFG, ccfg)
    st, _ = exe.window_step(_state(ccfg), _window(0), 0.3)
    st = exe.stage_end(st, _alpha(1))
    ptrs = {t.untyped_storage().data_ptr() for t in tree_leaves(st["params"])}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in tree_leaves(st["ref_params"])}
    at_stage = _snap({"params": st["params"], "ref_duals": st["ref_duals"]})
    st, _ = exe.window_step(st, _window(2), 0.3)
    for (p, want), got in zip(at_stage.items(),
                              tree_leaves({"params": st["ref_params"],
                                           "ref_duals": st["ref_duals"]})):
        assert torch.equal(got, want), p
    assert not torch.equal(tree_leaves(st["params"])[0], tree_leaves(st["ref_params"])[0])


def test_an_in_place_step_refuses_a_reference_sharing_the_parameters():
    """The trap the stage end's copy avoids: an out-of-place stage end lets
    ``ref_params`` share the parameters' buffers, and an in-place K2 over
    them would overwrite the proximal reference; the wrapper refuses."""
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6)
    st = C.stage_end(MCFG, ccfg, _state(ccfg), _alpha(1), resync=False)
    assert tree_leaves(st["ref_params"])[0] is tree_leaves(st["params"])[0]
    with pytest.raises(ValueError, match="overlaps"):
        C.local_step(MCFG, ccfg, st, {k: v[0] for k, v in _window(0).items()}, 0.3,
                     inplace=True)


def test_taking_a_state_with_shared_buffers_copies_them_once():
    """A donating executor given such a state (from a non-donating stage
    end) gives the shared leaves their own memory and runs bitwise as the
    non-donating executor does."""
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, optimizer="momentum")
    shared = C.stage_end(MCFG, ccfg, _state(ccfg), _alpha(1), resync=False)
    want, _ = C.make_executor(MCFG, ccfg, donate=False).window_step(
        tree_map(lambda t: t, shared), _window(0), 0.3)
    want = _snap(want)
    ids = {id(t) for t in tree_leaves(shared)}
    taken = C.take_state(shared)
    assert shared == {}
    spans = sorted(kprox.byte_span(t) for t in tree_leaves(taken) if t.numel())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))       # no two overlap
    # one of each shared pair is copied: the params or their references, and
    # the duals or theirs
    shared_leaves = tree_leaves(taken["params"]) + tree_leaves(taken["ref_duals"])
    assert len({id(t) for t in tree_leaves(taken)} - ids) == len(shared_leaves)
    got, _ = C.make_executor(MCFG, ccfg).window_step(taken, _window(0), 0.3)
    _assert_bitwise(_snap(got), want)


def test_server_momentum_copies_the_start_parameters():
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, server_momentum=0.9)
    st = _state(ccfg)
    start = C.start_copy(ccfg, st, communicate=True, inplace=True)
    for a, b in zip(tree_leaves(start), tree_leaves(st["params"])):
        assert torch.equal(a, b) and a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert C.start_copy(ccfg, st, communicate=True, inplace=False) is st["params"]
    assert C.start_copy(ccfg, st, communicate=False, inplace=True) is None


def test_the_handed_over_state_can_no_longer_be_read():
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, optimizer="sm3", stream_bins=16)
    exe = C.make_executor(MCFG, ccfg)
    st = _state(ccfg)
    params, opt, leaves = st["params"], st["opt"], st["opt"]["leaves"]
    new, _ = exe.window_step(st, _window(0), 0.3)
    assert st == {} and params == {} and opt == {} and leaves == []
    with pytest.raises(KeyError):
        st["params"]
    new2 = exe.stage_end(new, _alpha(1))
    assert new == {} and set(new2) >= {"params", "opt", "sk_acc"}
    kept = C.make_executor(MCFG, ccfg, donate=False)
    st = _state(ccfg)
    out, _ = kept.window_step(st, _window(0), 0.3)
    assert set(st) == set(out) and out is not st


def _fit(ccfg, donate, crash_after=None, **kw):
    ds = ShardedDataset(DataConfig(kind="features", n_features=8), 512, K, seed=0,
                        target_p=0.6, dirichlet_alpha=0.5)
    seen = [0]

    def sample_window(n):
        if crash_after is not None and seen[0] >= crash_after:
            raise RuntimeError("simulated crash")
        seen[0] += 1
        return ds.sample_window(n, B)

    st = _state(ccfg)
    res = C.fit(st, MCFG, ccfg, S.ScheduleConfig(n_workers=K, eta0=0.3, T0=8, I0=I), 2,
                sample_window, ds.sample_alpha_batch, rng=ds.draw_rng,
                executor=C.make_executor(MCFG, ccfg, donate=donate), **kw)
    return res, st


@pytest.mark.parametrize("kw", [dict(optimizer="momentum", opt_dtype=torch.bfloat16),
                                dict(algorithm="codasca", stream_bins=32, participation=0.75,
                                     optimizer="shampoo_blocked", shampoo_block=8,
                                     precond_every=3)],
                         ids=["momentum_bf16", "codasca_sketch_masked_shampoo"])
def test_crash_resume_under_donation_is_bitwise_the_uninterrupted_run(tmp_path, kw):
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, **kw)
    want, _ = _fit(ccfg, False)
    d = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="simulated"):
        _fit(ccfg, True, crash_after=5, ckpt_dir=d, ckpt_every=2)
    got, handed = _fit(ccfg, True, ckpt_dir=d, ckpt_every=2, resume=True)
    assert handed == {}                     # fit consumed the state it was given
    _assert_bitwise(_snap(got.state), _snap(want.state))
    assert got.history == want.history
    assert (got.comm_rounds, got.exposed_bytes) == (want.comm_rounds, want.exposed_bytes)


@pytest.fixture(scope="module")
def sharded():
    return {case: PM.run_ranks(DR.donated_and_not, 2, (case,), backend="gloo")
            for case in DR.CASES}


@pytest.mark.parametrize("case", list(DR.CASES))
def test_sharded_donation_on_two_ranks_is_bitwise_the_undonated_run(sharded, case):
    (got, got_loss, kept, n), (want, want_loss, moved, _) = \
        sharded[case][True], sharded[case][False]
    _assert_bitwise(got, want)
    assert torch.equal(got_loss, want_loss)
    assert kept == n and moved < n


# --------------------------------------------------------------------------
# the in-place K2/K3 wrappers
# --------------------------------------------------------------------------
def _leaf(seed, shape, dtype, device="cpu", offset=0):
    """A seeded leaf; ``offset`` elements into a larger buffer (a start the
    kernels' pair loads cannot use)."""
    g = torch.Generator().manual_seed(seed)
    n = int(np.prod(shape))
    return torch.randn((n + offset,), generator=g).to(device, dtype)[offset:].view(shape)


PROX_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32)]
# (shape, offset of v): an even count, an odd count (one element past the
# pairs), and a start off the pair alignment
LAYOUTS = {"even": ((4, 3, 3, 7), 0), "odd": ((5, 7), 0), "unaligned": ((4, 33), 1)}


def _prox_case(v_dt, g_dt, device, layout="even"):
    shape, off = LAYOUTS[layout]
    return [_leaf(i, shape, dt, device, off if i == 0 else 0)
            for i, dt in enumerate((v_dt, g_dt, v_dt))]


def _opt_case(mode, v_dt, b_dt, device, layout="even"):
    shape, off = LAYOUTS[layout]
    v, g, v0 = (_leaf(i, shape, v_dt, device, off if i == 0 else 0) for i in range(3))
    buf = _leaf(3, shape, b_dt, device, off).abs()
    seed = torch.tensor([0x1234ABCD], dtype=torch.int64, device=device)
    return v, g, v0, buf, seed


OPT_CASES = [("momentum", torch.float32, torch.float32),
             ("momentum", torch.float32, torch.bfloat16),
             ("momentum", torch.bfloat16, torch.bfloat16),
             ("precond", torch.float32, torch.float32),
             ("precond", torch.bfloat16, torch.float32)]


def _check_prox(v_dt, g_dt, device, layout="even"):
    v, g, v0 = _prox_case(v_dt, g_dt, device, layout)
    want = kprox.prox_update(v, g, v0, 0.3, 0.5)
    ptr = v.data_ptr()
    got = kprox.prox_update(v, g, v0, 0.3, 0.5, inplace=True)
    assert got is v and got.data_ptr() == ptr and torch.equal(got, want)


def _check_opt(mode, v_dt, b_dt, device, layout="even"):
    v, g, v0, buf, seed = _opt_case(mode, v_dt, b_dt, device, layout)
    want = kopt.opt_update(v, g, v0, buf, 0.3, 0.5, 0.9, seed, mode=mode)
    got = kopt.opt_update(v, g, v0, buf, 0.3, 0.5, 0.9, seed, mode=mode, inplace=True)
    assert got[0] is v and got[1] is buf
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("v_dt,g_dt", PROX_DTYPES)
def test_prox_update_in_place_is_bitwise_the_out_of_place_form(v_dt, g_dt, layout):
    _check_prox(v_dt, g_dt, "cpu", layout)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode,v_dt,b_dt", OPT_CASES)
def test_opt_update_in_place_is_bitwise_the_out_of_place_form(mode, v_dt, b_dt, layout):
    _check_opt(mode, v_dt, b_dt, "cpu", layout)


def test_in_place_updates_refuse_aliased_or_expanded_destinations():
    v, g, v0 = _prox_case(torch.float32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="overlaps"):
        kprox.prox_update(v, g, v, 0.3, 0.5, inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        kops.prox_update_tree([v], [g], [v[:, :1]], 0.3, 0.5, inplace=True, impl="ref")
    with pytest.raises(ValueError, match="contiguous"):
        kprox.prox_update(v.transpose(1, 2), g.transpose(1, 2), v0.transpose(1, 2), 0.3,
                          0.5, inplace=True)
    v, g, v0, buf, seed = _opt_case("precond", torch.float32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="contiguous"):      # SM3's expanded cover
        kopt.opt_update(v, g, v0, buf[:, :1].expand(v.shape), 0.3, 0.5, 1e-6, seed,
                        mode="precond", inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        kops.opt_update(v, g, v0, v, 0.3, 0.5, 0.9, seed, mode="momentum", inplace=True)
    # out of place, the same aliases are fine: nothing is written into them
    kprox.prox_update(v, g, v, 0.3, 0.5)


def test_optimizer_step_in_place_keeps_the_host_step_count():
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, optimizer="shampoo_blocked", shampoo_block=8,
                        precond_every=2)
    st = _state(ccfg)
    t = st["opt"]["t"]
    for n in range(1, 4):
        st, _ = C.local_step(MCFG, ccfg, st, {k: v[0] for k, v in _window(n).items()}, 0.3,
                             inplace=True)
        assert st["opt"]["t"] is t and O.host_count(t) == n and int(t[0]) == n


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the in-place K2/K3 need the card")
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("v_dt,g_dt", PROX_DTYPES)
def test_prox_kernel_in_place_is_bitwise_the_out_of_place_kernel(v_dt, g_dt, layout):
    _check_prox(v_dt, g_dt, "cuda", layout)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the in-place K2/K3 need the card")
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode,v_dt,b_dt", OPT_CASES)
def test_opt_kernel_in_place_is_bitwise_the_out_of_place_kernel(mode, v_dt, b_dt, layout):
    _check_opt(mode, v_dt, b_dt, "cuda", layout)
