"""repro_torch.metrics (streaming sketch, Metric backends, report lines) and
the sketch's training integration vs repro.metrics / repro.core.coda,
mirroring tests/test_metrics.py.

Tolerances and why:

  * bin indices and sketch counts: bitwise — the same fp32 binning
    formula with the same constants, and integer-valued fp32 counts below
    2²⁴ (exact in any order), on the host path, the tensor path and inside
    training;
  * AUC/pAUC from counts and their resolution bounds: exact — the same
    float64 NumPy code on the same counts;
  * the exact backend: 1e-6 — the reference ranks in jnp float32, the port
    in float64;
  * report lines: identical strings;
  * a window / ``fit`` with the sketch on: counts bitwise (the scores agree
    to ~1e-7 and none of these lands that close to a bin edge), parameters
    atol 1e-5 / 1e-4 as in tests/test_torch_coda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.core import schedules as JS
from repro.metrics import report as jreport
from repro.metrics import streaming as jstream
from repro_torch import params as P
from repro_torch.configs import mlp_config
from repro_torch.core import coda as C
from repro_torch.core import objective as O
from repro_torch.core import schedules as S
from repro_torch.metrics import report, streaming

NF = 8
MCFG, JMCFG = mlp_config(n_features=NF, d=16), jax_mlp_config(n_features=NF, d=16)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _scores(rng, lo, hi, bins, n=4000):
    """Random scores plus every bin edge, its fp32 neighbours, the range ends
    and values beyond them."""
    edges = (np.float32(lo) + np.arange(bins + 1, dtype=np.float32)
             / np.float32(streaming._scale(lo, hi, bins)))
    near = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                           np.nextafter(edges, np.float32(np.inf))])
    out = np.array([lo, hi, lo - 1, hi + 1, -1e6, 1e6, np.inf, -np.inf], np.float32)
    mid = 0.5 * (lo + hi)
    rand = (mid + (hi - lo) * 0.4 * rng.standard_normal(n)).astype(np.float32)
    return np.concatenate([rand, near.astype(np.float32), out])


@pytest.mark.parametrize("bins,lo,hi", [(7, -8.0, 8.0), (64, 0.0, 1.0),
                                        (2048, -8.0, 8.0), (100, -3.3, 5.1)])
def test_binning_and_counts_match_reference_bitwise(bins, lo, hi):
    rng = np.random.default_rng(bins)
    s = _scores(rng, lo, hi, bins)
    want = np.asarray(jstream.bin_index(jnp.asarray(s), lo, hi, bins))
    np.testing.assert_array_equal(jstream._bin_index_np(s, lo, hi, bins), want)
    np.testing.assert_array_equal(streaming._bin_index_np(s, lo, hi, bins), want)
    np.testing.assert_array_equal(streaming.bin_index(torch.from_numpy(s), lo, hi, bins).numpy(),
                                  want)
    # per-worker rows, as the training path calls it: [K, bins] and [K, T]
    K = 3
    T = s.size // K
    sk = s[:K * T].reshape(K, T)
    y = (rng.random((K, T)) < 0.6).astype(np.float32)
    p0 = rng.integers(0, 5, (K, bins)).astype(np.float32)
    n0 = rng.integers(0, 5, (K, bins)).astype(np.float32)
    gp, gn = streaming.update_counts(torch.from_numpy(p0), torch.from_numpy(n0),
                                     torch.from_numpy(sk), torch.from_numpy(y), lo, hi)
    for k in range(K):
        wp, wn = jstream.update_counts(jnp.asarray(p0[k]), jnp.asarray(n0[k]),
                                       jnp.asarray(sk[k]), jnp.asarray(y[k]), lo, hi)
        np.testing.assert_array_equal(gp[k].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(gn[k].numpy(), np.asarray(wn))


def test_host_sketch_update_and_merge_match_reference():
    rng = np.random.default_rng(1)
    a, ja = streaming.empty_sketch(256), jstream.empty_sketch(256)
    for i in range(3):
        s = _scores(rng, -8.0, 8.0, 256, n=500)
        y = (rng.random(s.size) < 0.5).astype(np.float32)
        a, ja = streaming.update(a, torch.from_numpy(s), y), jstream.update(ja, s, y)
    b = streaming.update(streaming.empty_sketch(256), s[::-1].copy(), y)
    jb = jstream.update(jstream.empty_sketch(256), s[::-1].copy(), y)
    for got, want in ((a, ja), (streaming.merge(a, b), jstream.merge(ja, jb))):
        np.testing.assert_array_equal(got.pos, want.pos)
        np.testing.assert_array_equal(got.neg, want.neg)
        assert (got.under, got.over, got.count, got.nbytes) == \
            (want.under, want.over, want.count, want.nbytes)
        assert (got.clipped, got.edge_mass) == (want.clipped, want.edge_mass)
    with pytest.raises(ValueError, match="incompatible"):
        streaming.merge(a, streaming.empty_sketch(128))
    with pytest.raises(ValueError):
        streaming.empty_sketch(0)


def _count_cases(rng):
    bins = 32
    yield rng.integers(0, 9, bins).astype(np.float32), rng.integers(0, 9, bins).astype(np.float32)
    yield np.zeros(bins, np.float32), rng.integers(0, 9, bins).astype(np.float32)  # no positives
    one = np.zeros(bins, np.float32)
    one[5] = 7
    yield one, one * 2                                                           # all tied
    p, n = np.zeros(bins, np.float32), np.zeros(bins, np.float32)
    p[20:], n[:12] = 3, 4
    yield p, n                                                                   # separable


@pytest.mark.parametrize("beta", [0.1, 0.3, 1.0])
def test_auc_and_pauc_from_counts_match_reference(beta):
    for pos, neg in _count_cases(np.random.default_rng(2)):
        for got, want in ((streaming.auc_from_counts, jstream.auc_from_counts),
                          (streaming.auc_resolution, jstream.auc_resolution)):
            assert got(torch.from_numpy(pos), neg) == want(pos, neg)
        for got, want in ((streaming.pauc_from_counts, jstream.pauc_from_counts),
                          (streaming.pauc_resolution, jstream.pauc_resolution)):
            assert got(pos, neg, beta) == want(pos, neg, beta)


@pytest.mark.parametrize("kind", ["auc", "pauc"])
@pytest.mark.parametrize("backend", ["exact", "sketch"])
def test_metric_backends_match_reference(kind, backend):
    rng = np.random.default_rng(3)
    y = (rng.random(3000) < 0.3).astype(np.float32)
    s = (rng.random(3000) + 0.4 * y).astype(np.float32)
    kw = {"bins": 512, "lo": 0.0, "hi": 1.5} if backend == "sketch" else {}
    m = streaming.make_metric(kind, backend, beta=0.2, **kw)
    jm = jstream.make_metric(kind, backend, beta=0.2, **kw)
    assert (m.name, m.backend) == (jm.name, jm.backend)
    st = m.merge(m.update(m.init(), torch.from_numpy(s[:1000]), y[:1000]),
                 m.update(m.init(), s[1000:], torch.from_numpy(y[1000:])))
    jst = jm.merge(jm.update(jm.init(), s[:1000], y[:1000]),
                   jm.update(jm.init(), s[1000:], y[1000:]))
    tol = 1e-6 if (backend, kind) == ("exact", "auc") else 0
    assert abs(m.finalize(st) - jm.finalize(jst)) <= tol
    assert m.resolution(st) == jm.resolution(jst)
    assert m.state_bytes(st) == jm.state_bytes(jst)
    assert abs(m.compute(s, y) - jm.compute(s, y)) <= tol
    for bad in (("roc", "exact"), ("auc", "bins")):
        with pytest.raises(ValueError):
            streaming.make_metric(*bad)
    om = O.AUCObjective(0.3).metric(backend, **kw)
    assert (om.name, om.backend) == ("auc", backend)


def test_report_lines_match_reference():
    rng = np.random.default_rng(4)
    s = rng.normal(0, 5, 2000).astype(np.float32)
    s[:40] = 50.0                                           # clipped: a warning
    y = (rng.random(2000) < 0.5).astype(np.float32)
    m, jm = streaming.make_metric("auc", "sketch"), jstream.make_metric("auc", "sketch")
    st, jst = m.update(m.init(), s, y), jm.update(jm.init(), s, y)
    assert report.metric_line("train", "eval 1", m, st, n_seen=2000) == \
        jreport.metric_line("train", "eval 1", jm, jst, n_seen=2000)
    K, bins = 3, 64
    pos = rng.integers(0, 5, (K, bins)).astype(np.float32)
    neg = rng.integers(0, 5, (K, bins)).astype(np.float32)
    pos[2] = 0                                              # a single-class lane: "-"
    got = report.worker_skew_line("train", "final", m,
                                  {"pos": torch.from_numpy(pos), "neg": torch.from_numpy(neg)},
                                  -8.0, 8.0)
    want = jreport.worker_skew_line("train", "final", jm,
                                    {"pos": pos, "neg": neg}, -8.0, 8.0)
    assert got == want and "-" in got


# --------------------------------------------------------------------------
# training integration
# --------------------------------------------------------------------------
def _window(seed, I, K, B):
    rng = np.random.default_rng(seed)
    y = (rng.random((I, K, B)) < 0.7).astype(np.float32)
    x = rng.standard_normal((I, K, B, NF)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": x, "labels": y}


def _pair(K, seed, **kw):
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    jst = _np(JC.init_state(jax.random.PRNGKey(seed), JMCFG, jccfg))
    return jccfg, jst, ccfg, P.state_from_jax(MCFG, ccfg, jst)


def _sketch_equal(got, want):
    for k in ("sk_acc", "sk_new", "sk_loc"):
        for f in ("pos", "neg"):
            np.testing.assert_array_equal(got[k][f], np.asarray(want[k][f]), err_msg=k + f)


def test_window_with_sketch_matches_reference():
    """Three local steps fill the per-worker deltas; the average folds them
    into sk_acc (replicated) and sk_loc (per worker) and clears them."""
    jccfg, jst, ccfg, st = _pair(4, 0, stream_bins=64, stream_range=(0.0, 1.0))
    assert set(st) == set(jst) >= {"sk_acc", "sk_new", "sk_loc"}
    wb = _window(0, 3, 4, 8)
    for communicate in (False, True):
        jnew, _ = JC.window_step(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                                 {k: jnp.asarray(v) for k, v in wb.items()}, 0.1,
                                 communicate=communicate)
        new, _ = C.window_step(MCFG, ccfg, st, _t(wb), 0.1, communicate=communicate)
        got = P.state_to_jax(MCFG, new)
        _sketch_equal(got, _np(jnew))
        np.testing.assert_allclose(got["params"]["score_head"]["w"],
                                   np.asarray(jnew["params"]["score_head"]["w"]), atol=1e-5)
    assert float(new["sk_acc"]["pos"].sum() + new["sk_acc"]["neg"].sum()) == 4 * 3 * 8 * 4
    assert float(new["sk_new"]["pos"].abs().sum()) == 0.0
    torch.testing.assert_close(new["sk_acc"]["pos"], new["sk_loc"]["pos"].sum(0).expand(4, -1),
                               rtol=0, atol=0)
    assert C.streaming_payload_bytes(new) == JC.streaming_payload_bytes(jst) == 2 * 64 * 4
    assert C.window_payload_bytes(new) == JC.window_payload_bytes(jst) == \
        C.model_bytes(new) + 2 * 64 * 4
    with pytest.raises(ValueError, match="int8"):
        C.CoDAConfig(n_workers=2, stream_bins=64, avg_compress="int8")


def test_fit_with_sketch_and_eval_hook_matches_reference():
    """The whole slice with the sketch on, on replayed windows, with an eval
    hook every window that reads the merged sketch: the same history (loss
    and eval entries) and bitwise the same counts as the reference."""
    K, I, B = 4, 4, 16
    kw = dict(stream_bins=128)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    key = jax.random.PRNGKey(5)
    windows, alphas = [], []

    def record(store, lead, n, seed):
        rng = np.random.default_rng(seed + len(store))
        y = (rng.random(lead + (n,)) < 0.7).astype(np.float32)
        x = rng.standard_normal(lead + (n, NF)).astype(np.float32) + 0.5 * (2 * y[..., None] - 1)
        store.append({"features": x, "labels": y})
        return {k: jnp.asarray(v) for k, v in store[-1].items()}

    jeval = lambda st: jstream.auc_from_counts(np.asarray(st["sk_acc"]["pos"][0]),
                                               np.asarray(st["sk_acc"]["neg"][0]))
    sched = dict(n_workers=K, eta0=0.5, T0=8, I0=I)
    jres = JC.fit(key, JMCFG, jccfg, JS.ScheduleConfig(**sched), 2,
                  sample_window=lambda k, i: record(windows, (i, K), B, 0),
                  sample_alpha_batch=lambda k, m: record(alphas, (K,), m, 500),
                  eval_every=1, eval_fn=jeval)
    st0 = P.state_from_jax(MCFG, ccfg, _np(JC.init_state(key, JMCFG, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    seen = []

    def eval_fn(st):
        sk = streaming.sketch_from_rows(st["sk_acc"], *ccfg.stream_range)
        seen.append(sk.count)
        return streaming.auc_from_counts(sk.pos, sk.neg)

    res = C.fit(st0, MCFG, ccfg, S.ScheduleConfig(**sched), 2,
                sample_window=lambda i: _t(next(wit)),
                sample_alpha_batch=lambda m: _t(next(ait)), eval_every=1, eval_fn=eval_fn)
    assert next(wit, None) is None and next(ait, None) is None
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    assert len(res.history) == 2 * 8          # 8 windows, each a loss and an eval
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    assert [h[2] for h in res.history[1::2]] == [h[2] for h in jres.history[1::2]]
    assert seen == [K * B * I * (w + 1) for w in range(8)]
    _sketch_equal(P.state_to_jax(MCFG, res.state), _np(jres.state))
    lanes = streaming.worker_sketches(res.state["sk_loc"], *ccfg.stream_range)
    assert [sk.count for sk in lanes] == [B * 32] * K
