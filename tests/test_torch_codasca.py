"""repro_torch's CODASCA, bucketed and masked averaging and server momentum
vs ``repro``'s vmap oracle, mirroring the vmap halves of
tests/test_codasca.py and tests/test_masked_window.py.

The same numpy inputs go through both packages; the reference's initial
state is carried across with ``repro_torch.params``.  Tolerances:

  * the averaging functions on the same inputs (``bucketing``'s masked and
    unmasked forms, fp32 and bf16 buckets, int8 or not): bitwise — each
    sum is taken over K rows in the same order and rounded where the
    reference rounds;
  * whole windows (local steps, then the averaging): atol 1e-5 in fp32
    (matmuls summed in another order), the bf16 rule of
    tests/test_torch_bf16.py in bf16;
  * the CoDA ≡ CODASCA equivalences inside the port, the variate
    invariants, byte accounting and the launchers' counters: exact.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import bucketing as JB
from repro.core import coda as JC
from repro.core import codasca as JCS
from repro_torch import params as P
from repro_torch.configs import mlp_config
from repro_torch.core import bucketing as B
from repro_torch.core import coda as C
from repro_torch.core import codasca as CS
from repro_torch.core import schedules as S
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.data.synthetic import dirichlet_partition
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMCFG = jax_mlp_config(n_features=16, d=32)
MCFG = mlp_config(n_features=16, d=32)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_STATE_KEYS = ("params", "duals", "ref_params", "ref_duals")
# the bf16 rule of tests/test_torch_bf16.py: the port's distance from the
# reference's bf16 result at most twice the reference's own bf16-vs-fp32
# distance, plus one bf16 ulp of the fp32 result's largest magnitude
BF16_FACTOR, BF16_ULP = 2.0, 2 ** -7


def _window(seed, I, K, B=8, p=0.7, nf=16):
    rng = np.random.default_rng(seed)
    y = (rng.random((I, K, B)) < p).astype(np.float32)
    x = rng.standard_normal((I, K, B, nf)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": x, "labels": y}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(K, seed=0, dtype="f32", **kw):
    """(reference config, reference numpy state, port config, port state)."""
    jd, td = DT[dtype]
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=jd, **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=td, **kw)
    jst = _np(JC.init_state(jax.random.PRNGKey(seed), JMCFG, jccfg))
    return jccfg, jst, ccfg, P.state_from_jax(MCFG, ccfg, jst)


def _faults(u, r):
    u, r = np.asarray(u, np.float32), np.asarray(r, np.float32)
    return ({"weights": jnp.asarray(u), "resync": jnp.asarray(r)},
            {"weights": torch.from_numpy(u), "resync": torch.from_numpy(r)})


def _errs(port, ref):
    """{state key: max |port − ref|} over every key of the reference state."""
    got = P.state_to_jax(MCFG, port)
    out = {}
    for k in ref:
        a = jax.tree_util.tree_leaves(got[k])
        b = jax.tree_util.tree_leaves(ref[k])
        assert len(a) == len(b), k
        out[k] = max(float(np.max(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32))))
                     for x, y in zip(a, b))
    return out


def _max_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _state_only(st):
    return {k: st[k] for k in ("params", "duals")}


# --------------------------------------------------------------------------
# the non-IID partitioner (the port's own draws)
# --------------------------------------------------------------------------
def test_dirichlet_partition_exact_and_keeps_every_positive():
    rng = np.random.default_rng(0)
    labels = (rng.random(977) < 0.71).astype(np.float32)
    for alpha in (0.05, 0.5, 5.0):
        shards = dirichlet_partition(np.random.default_rng(1), labels, 8, alpha)
        np.testing.assert_array_equal(np.sort(np.concatenate(shards)), np.arange(len(labels)))
        assert all(len(s) > 0 for s in shards)
        assert sum(int(labels[s].sum()) for s in shards) == int(labels.sum())


def test_dirichlet_skew_tracks_alpha_and_sampling_stays_in_shard():
    dcfg = DataConfig(kind="features", n_features=8)
    spread = {a: float(np.std(ShardedDataset(dcfg, 2048, 8, target_p=0.71,
                                             dirichlet_alpha=a).shard_p_pos))
              for a in (0.1, 1.0, 1000.0)}
    assert spread[0.1] > spread[1.0] > spread[1000.0], spread
    assert spread[0.1] > 0.2 and spread[1000.0] < 0.05
    ds = ShardedDataset(dcfg, 1024, 4, target_p=0.71, dirichlet_alpha=0.2)
    assert sum(ds.shard_sizes) == ds.n
    wb = ds.sample_window(3, 8)
    assert wb["labels"].shape == (3, 4, 8)
    for k in range(4):   # worker k's rows come from shard k
        rows = {tuple(r) for r in ds.inputs["features"][torch.from_numpy(ds.shards[k])].tolist()}
        assert all(tuple(r) in rows for r in wb["features"][:, k].reshape(-1, 8).tolist())


# --------------------------------------------------------------------------
# the equivalences inside the port: where the variates cancel, CODASCA IS CoDA
# --------------------------------------------------------------------------
def _case(K, I, seed=0, compress="", dtype="f32"):
    _, _, ccfg, st = _pair(K, seed, dtype, algorithm="codasca", avg_compress=compress)
    return ccfg, st, _t(_window(seed, I, K))


def _coda_of(ccfg):
    return dataclasses.replace(ccfg, algorithm="coda")


def test_codasca_first_window_is_coda_bitwise():
    ccfg, st0, wb = _case(4, 3)
    s1, l1 = CS.window_step(MCFG, ccfg, st0, wb, 0.1)
    s2, l2 = C.window_step(MCFG, _coda_of(ccfg), {k: st0[k] for k in _STATE_KEYS}, wb, 0.1)
    assert _max_err(_state_only(s1), _state_only(s2)) == 0.0
    assert torch.equal(l1, l2)


@pytest.mark.parametrize("dtype,I", [("f32", 2), ("bf16", 4)])
def test_codasca_homogeneous_equals_coda_step_for_step(dtype, I):
    """Identical per-worker batches keep c_k == c: the correction stays an
    exact zero over many windows, through the fp32 accumulator and its
    cast to the wire dtype in bf16 too; the variates keep the wire dtype."""
    ccfg, st_s, wb = _case(4, I, dtype=dtype)
    wb_h = {k: v[:, :1].expand(v.shape).clone() for k, v in wb.items()}
    st_c = {k: st_s[k] for k in _STATE_KEYS}
    for _ in range(3):
        st_s, _ = CS.window_step(MCFG, ccfg, st_s, wb_h, 0.1)
        st_c, _ = C.window_step(MCFG, _coda_of(ccfg), st_c, wb_h, 0.1)
    assert _max_err(_state_only(st_s), _state_only(st_c)) == 0.0
    assert all(cv.dtype == p.dtype for cv, p in zip(tree_leaves(st_s["cv_params"]),
                                                    tree_leaves(st_s["params"])))


@pytest.mark.parametrize("compress", ["", "int8"])
def test_codasca_k1_equals_coda_over_windows(compress):
    """K = 1: c_1 == c after every refresh, so CODASCA ≡ CoDA exactly with
    fresh batches each window, int8 included (c and c_1 share the
    quantizer)."""
    ccfg, st_s, _ = _case(1, 2, compress=compress)
    st_c = {k: st_s[k] for k in _STATE_KEYS}
    for seed in range(3):
        wb = _t(_window(seed, 2, 1))
        st_s, _ = CS.window_step(MCFG, ccfg, st_s, wb, 0.1)
        st_c, _ = C.window_step(MCFG, _coda_of(ccfg), st_c, wb, 0.1)
    assert _max_err(_state_only(st_s), _state_only(st_c)) == 0.0


@pytest.mark.parametrize("compress", ["", "int8"])
def test_codasca_variate_invariant_and_payload(compress):
    """After a heterogeneous window cg == mean_k cv (int8: both in the wire
    format), the variates are not zero, and the payload doubles."""
    ccfg, st0, wb = _case(8, 4 if not compress else 3, compress=compress)
    s1, _ = CS.window_step(MCFG, ccfg, st0, wb, 0.1)
    for field in ("params", "duals"):
        for cg, cv in zip(tree_leaves(s1[f"cg_{field}"]), tree_leaves(s1[f"cv_{field}"])):
            assert float((cg - cv.mean(0, keepdim=True)).abs().max()) < 1e-6
            assert torch.equal(cg, cg[:1].expand_as(cg))
    assert max(float(cv.abs().max()) for cv in tree_leaves(s1["cv_params"])) > 0
    mb = C.model_bytes(s1, compress or None)
    assert C.window_payload_bytes(s1, compress or None) == 2 * mb
    assert C.window_payload_bytes(_state_only(s1), compress or None) == mb


def test_codasca_bf16_variate_refresh_accumulates_fp32(monkeypatch):
    """The window-mean variate refresh is the fp32-accumulated mean of the
    raw gradients, cast once: with gradients [1, ε, ε, ...] (ε = 2⁻⁹, below
    a bf16 accumulator's ulp) the fp32 path lands on (1 + (I−1)ε)/I, not
    the bf16 accumulator's 1/I."""
    K, I, eps = 4, 32, 2.0 ** -9
    ccfg, st0, wb = _case(K, I, seed=3, dtype="bf16")
    g_t = np.full((I,), eps, np.float32)
    g_t[0] = 1.0
    wb["labels"] = torch.from_numpy(g_t)[:, None, None].expand(I, K, 8).clone()

    def stub(mcfg, c, state, batch):
        val = batch["labels"][0, 0]
        gp = tree_map(lambda p: torch.full(p.shape, float(val)).to(p.dtype), state["params"])
        gd = {f: torch.full((K,), float(val)) for f in state["duals"]}
        return torch.zeros(K), (gp, gd), torch.zeros(K, 8)

    monkeypatch.setattr(C, "grad_step_scores", stub)
    s1, _ = CS.window_step(MCFG, ccfg, st0, wb, 0.1)
    want = np.float32(1.0 + (I - 1) * eps) / np.float32(I)
    want16 = float(torch.tensor(want).to(torch.bfloat16))
    for leaf in tree_leaves(s1["cv_params"]):
        got = torch.unique(leaf.float())
        assert got.numel() == 1
        assert float(got[0]) == (want16 if leaf.dtype == torch.bfloat16 else want)
    assert want16 != 1.0 / I
    assert float(s1["cv_duals"]["a"][0]) == want


# --------------------------------------------------------------------------
# against the reference: the averaging on the same inputs (bitwise)
# --------------------------------------------------------------------------
def _drift(K, dtype, **kw):
    """Both packages' states after 3 local steps with no averaging (the
    reference's state carried across), and a random fresh-variate tree in
    the wire dtypes."""
    jccfg, jst, ccfg, _ = _pair(K, 1, dtype, **kw)
    jd, _ = JC.window_step(JMCFG, jccfg, _j(jst), _j(_window(2, 3, K)), 0.3,
                           communicate=False)
    jd = _np(jd)
    rng = np.random.default_rng(7)
    cv = {"params": jax.tree_util.tree_map(
              lambda l: (0.1 * rng.standard_normal(l.shape)).astype(np.float32), jd["params"]),
          "duals": {k: rng.standard_normal(v.shape).astype(np.float32)
                    for k, v in jd["duals"].items()}}
    jcv = jax.tree_util.tree_map(lambda a, l: jnp.asarray(a).astype(l.dtype), cv,
                                 {"params": jd["params"], "duals": jd["duals"]})
    pcv = {"params": P.from_jax_params(MCFG, _np(jcv["params"])),
           "duals": {k: torch.from_numpy(np.array(v)) for k, v in jcv["duals"].items()}}
    return jccfg, jd, ccfg, P.state_from_jax(MCFG, ccfg, jd), jcv, pcv


U_R = {"mixed": ([1, 0, 0.5, 1], [1, 1, 0, 1]), "half": ([1, 0, 1, 0], [1, 1, 1, 1]),
       "all": ([1, 1, 1, 1], [1, 1, 1, 1])}


@pytest.mark.parametrize("faults", ["mixed", "half", "all", None])
@pytest.mark.parametrize("compress", ["", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
def test_averaging_matches_reference_bitwise(algorithm, dtype, compress, faults):
    """``bucketing``'s masked and unmasked averaging (CoDA) and
    average-and-refresh (CODASCA) equal the reference's bit for bit on the
    same drifted state, fault vectors and fresh variates: the bf16 buckets
    round where the reference rounds (twice when masked)."""
    jccfg, jd, ccfg, pd, jcv, pcv = _drift(4, dtype, algorithm=algorithm,
                                           avg_compress=compress)
    comp = compress or None
    if faults is None:
        if algorithm == "coda":
            want = JB.average_state(_j(jd), (), comp)
            got = B.average_state(pd, comp)
        else:
            want = JB.average_and_refresh(_j(jd), jcv, (), comp, n_workers=4)
            got = B.average_and_refresh(pd, pcv, comp, n_workers=4)
    else:
        jfl, pfl = _faults(*U_R[faults])
        if algorithm == "coda":
            want = JB.masked_average_state(_j(jd), jfl, (), comp)
            got = B.masked_average_state(pd, pfl, comp)
        else:
            want = JB.masked_average_and_refresh(_j(jd), jcv, jfl, (), comp)
            got = B.masked_average_and_refresh(pd, pcv, pfl, comp)
    errs = _errs(got, _np(want))
    assert max(errs.values()) == 0.0, errs


def test_bf16_masked_mean_rounds_twice_as_the_reference():
    """The trap the bitwise test above holds: the reference rounds a bf16
    bucket's fp32-accumulated sum to bf16, then the fp32 quotient again.
    Rounding once (sum and divide in fp32) lands elsewhere on this input,
    so the port must round at the same two places."""
    jccfg, jd, ccfg, pd, _, _ = _drift(4, "bf16", participation=0.6)
    u, r = U_R["mixed"]
    jfl, pfl = _faults(u, r)
    want = _np(JB.masked_average_state(_j(jd), jfl, (), None))
    got = P.state_to_jax(MCFG, B.masked_average_state(pd, pfl, None))
    once = []
    uw = torch.tensor(u)
    for leaf in tree_leaves(pd["params"]):
        if leaf.dtype == torch.bfloat16:
            s = (leaf.float() * uw.reshape(-1, *[1] * (leaf.dim() - 1))).sum(0)
            once.append((s / uw.sum()).to(torch.bfloat16).float().numpy())
    twice = [np.asarray(w)[0] for w, l in zip(jax.tree_util.tree_leaves(want["params"]),
                                              tree_leaves(pd["params"]))
             if l.dtype == torch.bfloat16]
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert any((a != b).any() for a, b in zip(once, twice))


def test_bucket_layout_bytes_equal_the_payload_by_dtype():
    """The per-dtype bucket layout (rows, offsets, sizes) adds up to
    ``window_payload_by_dtype`` in both packages' accounting: bf16 params
    with fp32 duals and score bias, CODASCA doubling, the sketch and the
    mask lanes in the f32 bucket."""
    for kw in (dict(), dict(algorithm="codasca"), dict(stream_bins=16),
               dict(algorithm="codasca", stream_bins=16)):
        for dtype in ("f32", "bf16"):
            jccfg, jst, ccfg, st = _pair(4, 0, dtype, **kw)
            for masked in (False, True):
                lay = B.bucket_layout(st, masked=masked)
                by = C.window_payload_by_dtype(st, masked=masked)
                assert {t: b["bytes"] for t, b in lay.items()} == by, (kw, dtype, masked)
                assert by == JC.window_payload_by_dtype(jst, masked=masked)
                assert sum(by.values()) == C.window_payload_bytes(st, masked=masked) == \
                    JC.window_payload_bytes(jst, masked=masked)
                for b in lay.values():
                    offs = [o for _, o, _ in b["rows"]]
                    sizes = [n for _, _, n in b["rows"]]
                    assert offs == list(np.cumsum([0] + sizes[:-1]))
                    assert sum(sizes) == b["elements"]
            assert C.mask_payload_bytes(st) == JC.mask_payload_bytes(jst)
    with pytest.raises(ValueError):
        C.window_payload_by_dtype(st, "int8")


# --------------------------------------------------------------------------
# against the reference: whole windows
# --------------------------------------------------------------------------
def _ref_window(jccfg, jst, wb, eta, faults=None):
    step = JCS.window_step if jccfg.algorithm == "codasca" else JC.window_step
    kw = {} if faults is None else {"faults": faults}
    return step(JMCFG, jccfg, _j(jst), _j(wb), eta, **kw)


def _port_window(ccfg, st, wb, eta, faults=None):
    return C.make_executor(MCFG, ccfg).window_step(st, _t(wb), eta, faults=faults)


WINDOW_CASES = {
    "codasca": dict(algorithm="codasca"),
    "codasca_int8": dict(algorithm="codasca", avg_compress="int8"),
    "codasca_sketch": dict(algorithm="codasca", stream_bins=32),
    "masked_coda": dict(participation=0.6),
    "masked_coda_int8": dict(participation=0.6, avg_compress="int8"),
    "masked_coda_sketch": dict(participation=0.6, stream_bins=32),
    "masked_codasca": dict(algorithm="codasca", participation=0.6),
    "masked_codasca_int8": dict(algorithm="codasca", participation=0.6, avg_compress="int8"),
    "server_momentum": dict(server_momentum=0.9),
    "server_momentum_codasca": dict(algorithm="codasca", server_momentum=0.9),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_two_windows_match_reference(case):
    """Two windows (the variates and the momentum buffer live in the
    second) through the executor, against the reference's vmap oracle at
    atol 1e-5; the fault vectors replayed by both packages' FaultPlans."""
    from repro.core import faults as JF
    from repro_torch.core import faults as F
    kw = WINDOW_CASES[case]
    jccfg, jst, ccfg, st = _pair(4, 3, **kw)
    masked = ccfg.faults_enabled
    jplan = JF.FaultPlan(n_workers=4, seed=3, dropout=0.4, straggle=0.3,
                         straggle_windows=1, max_staleness=1)
    plan = F.FaultPlan(n_workers=4, seed=3, dropout=0.4, straggle=0.3,
                       straggle_windows=1, max_staleness=1)
    for w in range(2):
        wb = _window(10 + w, 3, 4)
        jfl = pfl = None
        if masked:
            (ju, jr), (u, r) = jplan.window(w), plan.window(w)
            assert np.array_equal(ju, u) and np.array_equal(jr, r)
            jfl, pfl = _faults(u, r)
        jst, jl = _ref_window(jccfg, jst, wb, 0.3, jfl)
        jst = _np(jst)
        st, losses = _port_window(ccfg, st, wb, 0.3, pfl)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=1e-5)
    errs = _errs(st, jst)
    assert set(errs) == set(jst)
    assert max(errs.values()) < 1e-5, errs
    if "sk_new" in jst:   # integer counts: exact
        for k in ("sk_acc", "sk_new", "sk_loc"):
            assert errs[k] == 0.0, (k, errs[k])
    if "srv_m" in jst:
        assert max(float(m.abs().max()) for m in tree_leaves(st["srv_m"])) > 0


@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
@pytest.mark.parametrize("compress", ["", "int8"])
def test_bf16_masked_window_matches_reference(algorithm, compress):
    """A masked window on bf16 parameters against the reference under the
    bf16 rule (its own bf16-vs-fp32 distance, doubled, plus one bf16 ulp):
    the port's masked merge of its own bf16 local steps."""
    u, r = U_R["mixed"]
    jfl, pfl = _faults(u, r)
    kw = dict(algorithm=algorithm, participation=0.6, avg_compress=compress)
    jc16, jst16, ccfg, st = _pair(4, 4, "bf16", **kw)
    jc32 = dataclasses.replace(jc16, param_dtype=jnp.float32)
    jst32 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jst16)
    wb = _window(5, 3, 4)
    ref16 = _np(_ref_window(jc16, jst16, wb, 0.3, jfl)[0])
    ref32 = _np(_ref_window(jc32, jst32, wb, 0.3, jfl)[0])
    got = P.state_to_jax(MCFG, _port_window(ccfg, st, wb, 0.3, pfl)[0])
    fields = ("params", "duals") + (("cv_params", "cg_params") if algorithm == "codasca"
                                    else ())
    for f in fields:
        for i, (p, r16, r32) in enumerate(zip(jax.tree_util.tree_leaves(got[f]),
                                              jax.tree_util.tree_leaves(ref16[f]),
                                              jax.tree_util.tree_leaves(ref32[f]), strict=True)):
            p, r16, r32 = (np.asarray(x, np.float32) for x in (p, r16, r32))
            lim = BF16_FACTOR * float(np.abs(r16 - r32).max()) + BF16_ULP * float(
                np.abs(r32).max())
            assert float(np.abs(p - r16).max()) <= lim, (f, i)


# --------------------------------------------------------------------------
# masked semantics held in the port (tests/test_faults.py's vmap cases)
# --------------------------------------------------------------------------
def _masked_case(algorithm, u, r, participation=0.6, **kw):
    _, _, ccfg, st0 = _pair(4, 0, algorithm=algorithm, participation=participation, **kw)
    _, pfl = _faults(u, r)
    return ccfg, C.make_executor(MCFG, ccfg), st0, _t(_window(1, 2, 4, B=4, p=0.5)), pfl


def _local(ccfg, st0, wb):
    return C.window_step(MCFG, ccfg, st0, wb, 0.3, communicate=False)[0]


def test_masked_merge_is_exact_weighted_participant_mean():
    u = np.array([1.0, 0.0, 0.5, 0.0], np.float32)
    ccfg, exe, st0, wb, fl = _masked_case("coda", u, np.ones(4))
    merged, _ = exe.window_step(st0, wb, 0.3, faults=fl)
    local = _local(ccfg, st0, wb)
    uw = torch.from_numpy(u)
    for name in ("params", "duals"):
        for got, loc in zip(tree_leaves(merged[name]), tree_leaves(local[name])):
            rows = loc.reshape(4, -1)
            want = (rows * uw[:, None]).sum(0) / uw.sum()
            assert float((got.reshape(4, -1) - want).abs().max()) < 1e-6, name


def test_masked_straggler_keeps_own_iterate():
    u = r = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    ccfg, exe, st0, wb, fl = _masked_case("coda", u, r)
    merged, _ = exe.window_step(st0, wb, 0.3, faults=fl)
    local = _local(ccfg, st0, wb)
    for name in ("params", "duals"):
        for got, loc in zip(tree_leaves(merged[name]), tree_leaves(local[name])):
            assert torch.equal(got[2], loc[2]), name
            assert not torch.equal(got[0], loc[0])


def test_codasca_participant_mean_invariant_at_half_participation():
    ccfg, exe, st0, wb, fl = _masked_case("codasca", [1, 0, 1, 0], np.ones(4),
                                          participation=0.5)
    st2, _ = exe.window_step(st0, wb, 0.3, faults=fl)
    for field in ("params", "duals"):
        for g, v in zip(tree_leaves(st2[f"cg_{field}"]), tree_leaves(st2[f"cv_{field}"])):
            assert torch.equal(g[0], (v[0] + v[2]) / 2.0)
            assert torch.equal(g, g[:1].expand_as(g))
            assert float(v[1].abs().max()) == 0.0 and float(v[3].abs().max()) == 0.0


@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
def test_all_ones_fault_vectors_match_unmasked_path(algorithm):
    ccfg, exe, st0, wb, fl = _masked_case(algorithm, np.ones(4), np.ones(4))
    masked, _ = exe.window_step(st0, wb, 0.3, faults=fl)
    plain_cfg = dataclasses.replace(ccfg, participation=1.0)
    plain, _ = C.make_executor(MCFG, plain_cfg).window_step(st0, wb, 0.3)
    assert _max_err(masked, plain) < 1e-6


def test_masked_sketch_deltas_of_absent_workers_stay_local():
    """Only participants' sketch deltas fold into the accumulator; an absent
    worker's ``sk_new`` survives bit for bit, participants' reset."""
    K = 8
    _, _, ccfg, st0 = _pair(K, 0, participation=0.5, stream_bins=32)
    wb = _t(_window(1, 2, K, B=4, p=0.6))
    u = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.float32)
    _, fl = _faults(u, np.ones(K))
    local = _local(ccfg, st0, wb)
    merged, _ = C.make_executor(MCFG, ccfg).window_step(st0, wb, 0.3, faults=fl)
    for side in ("pos", "neg"):
        nl, nm = local["sk_new"][side], merged["sk_new"][side]
        for k in range(K):
            if u[k] > 0:
                assert float(nm[k].abs().max()) == 0.0
            else:
                assert torch.equal(nm[k], nl[k])
        want = st0["sk_acc"][side][0] + sum(nl[k] for k in range(K) if u[k] > 0)
        for k in range(K):
            assert torch.equal(merged["sk_acc"][side][k], want)


@pytest.mark.parametrize("algorithm", ["coda", "codasca"])
def test_no_positive_window_takes_guard_path_not_nan(algorithm):
    ccfg, exe, st0, _, fl = _masked_case(algorithm, [1, 0, 1, 1], np.ones(4))
    wb = _t(_window(5, 2, 4, B=4, p=0.0))
    st2, losses = exe.window_step(st0, wb, 0.3, faults=fl)
    assert all(bool(torch.isfinite(l.float()).all()) for l in tree_leaves(st2))
    assert bool(torch.isfinite(losses).all())


# --------------------------------------------------------------------------
# config, executor and fit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("bad", [dict(algorithm="CODASCA"), dict(avg_compress="int4")])
def test_config_rejects_unknown_algorithm(bad):
    with pytest.raises(ValueError):
        C.CoDAConfig(n_workers=2, **bad)


def test_init_state_extends_for_codasca_and_momentum():
    ccfg = C.CoDAConfig(n_workers=3, algorithm="codasca", server_momentum=0.5,
                        param_dtype=torch.bfloat16)
    st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    jst = JC.init_state(jax.random.PRNGKey(0), JMCFG, JC.CoDAConfig(
        n_workers=3, algorithm="codasca", server_momentum=0.5, param_dtype=jnp.bfloat16))
    assert sorted(st) == sorted(jst)
    for k in ("cv_params", "cg_params", "cv_duals", "cg_duals", "srv_m"):
        got, want = tree_leaves(st[k]), jax.tree_util.tree_leaves(jst[k])
        assert [(tuple(g.shape), str(g.dtype)[6:]) for g in got] == \
            [(tuple(w.shape), str(w.dtype)) for w in want]
        assert all(float(g.float().abs().max()) == 0.0 for g in got)


def test_codasca_fit_accounting():
    """fit() with CODASCA on Dirichlet shards: rounds, finite losses, the
    doubled payload in comm_bytes and in the exposed bytes."""
    K = 4
    ds = ShardedDataset(DataConfig(kind="features", n_features=16), 1024, K,
                        target_p=0.7, dirichlet_alpha=0.3)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=ds.p_pos, algorithm="codasca")
    sched = S.ScheduleConfig(n_workers=K, eta0=0.5, T0=8, I0=4)
    st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    res = C.fit(st, MCFG, ccfg, sched, 2, sample_window=lambda i: ds.sample_window(i, 16),
                sample_alpha_batch=ds.sample_alpha_batch)
    sl = S.stages(sched, 2)
    assert res.comm_rounds == C.comm_rounds(sl)
    assert all(np.isfinite(h[2]) for h in res.history)
    n_windows = sum(-(-s.T // s.I) for s in sl)
    assert C.comm_bytes(sl, res.state) == n_windows * 2 * C.model_bytes(res.state) + 2 * 4
    assert res.exposed_bytes == C.comm_bytes(sl, res.state) and res.overlapped_bytes == 0


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("flags", [
    ("--algorithm", "codasca", "--participation", "0.75", "--straggler-prob", "0.2",
     "--max-staleness", "1", "--server-momentum", "0"),
    ("--algorithm", "codasca", "--server-momentum", "0.9"),
])
def test_launchers_print_the_same_counters(flags):
    """Both launchers with the same CODASCA flags print the same
    iterations, communication rounds, bytes per round per worker (twice
    the mlp's 99,856) and schedule total, and the same fault line."""
    args = ("--stages", "2", "--t0", "16", "--n-data", "1024", *flags)
    env = one_thread_env(JAX_PLATFORMS="cpu")
    ours = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device",
                           "cpu", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    theirs = subprocess.run([sys.executable, "-m", "repro.launch.train", *args], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=300)
    assert ours.returncode == 0, ours.stderr
    assert theirs.returncode == 0, theirs.stderr
    pattern = (r"^done: (\d+) iters, (\d+) comm rounds, .*\n"
               r"bytes/round/worker=([\d,]+) \(schedule total ([\d,]+)\)$")
    got, want = (re.search(pattern, out.stdout, re.M) for out in (ours, theirs))
    assert got and want, (ours.stdout, theirs.stdout)
    assert got.groups() == want.groups()
    assert got.group(3) == f"{2 * (24961 + 3) * 4:,}"
    fault = [l for l in ours.stdout.splitlines() if l.startswith("fault injection:")]
    assert fault == [l for l in theirs.stdout.splitlines() if l.startswith("fault injection:")]
    assert len(fault) == ("--participation" in flags)


def _chip_smoke():
    """chip_smoke.py as a module (loaded once per process)."""
    import importlib.util
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(ROOT, "chip_smoke.py"))
        sys.modules["chip_smoke"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["chip_smoke"])
    return sys.modules["chip_smoke"]


SMOKE = _chip_smoke()
SMOKE_PATHS = {label: args for label, args, _ in SMOKE.MLP_PATHS}
SMOKE_PATHS.update({label: SMOKE.RN_ARGS + args for label, args, _ in SMOKE.RN_PATHS})
SMOKE_PATHS.update(SMOKE.SHARD_VMAP_PATHS)
SMOKE_PATHS.update({label: args for label, args, *_ in SMOKE.SHARDED_PATHS})
SMOKE_PATHS.update([SMOKE.RN_SHARD_DET])


@pytest.mark.parametrize("label", sorted(SMOKE.BYTES_PER_ROUND))
def test_chip_smoke_payload_constants_equal_the_references(label):
    """chip_smoke.py holds each card path's printed bytes/round/worker to a
    constant; each equals what the reference's accounting gives for the
    same launcher flags (its state's shapes only, via ``jax.eval_shape``)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.launch import train
    a = train.build_parser().parse_args(SMOKE_PATHS[label])
    jmcfg = jax_mlp_config() if a.arch == "mlp" else jax_get_config(a.arch)
    jccfg = JC.CoDAConfig(n_workers=a.workers, avg_compress=a.compress, algorithm=a.algorithm,
                          objective=a.objective, server_momentum=a.server_momentum,
                          stream_bins=a.metric_bins if a.metrics == "sketch" else 0,
                          participation=a.participation, straggler_prob=a.straggler_prob,
                          optimizer=a.optimizer)
    st = jax.eval_shape(lambda k: JC.init_state(k, jmcfg, jccfg), jax.random.PRNGKey(0))
    assert SMOKE.BYTES_PER_ROUND[label] == JC.window_payload_bytes(st, a.compress or None)
