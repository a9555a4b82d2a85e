"""bf16 parameters through the port's CoDA steps vs ``repro``: a local
step per optimizer, ``average`` (plain and int8) and ``fit`` on replayed
windows, under the bf16 rule of tests/test_torch_bf16.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16 import (K, ULP, _cfgs, _coda_pair, _f32, _jx, _np, _rule, _rule_trees,
                         _train_batch, _widen)
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from repro.core import coda as JC
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro_torch import params as P
from repro_torch.core import coda as C
from repro_torch.core import schedules as S
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("arch,kw", [
    ("mlp", dict(optimizer="sgd")),
    ("mlp", dict(optimizer="momentum")),
    ("mlp", dict(optimizer="momentum", opt_dtype=jnp.bfloat16)),
    ("mlp", dict(optimizer="sm3")),
    ("mlp", dict(optimizer="shampoo_blocked", shampoo_block=8)),
    ("mlp", dict(optimizer="sgd", objective="pauc_dro")),
    ("stablelm-1.6b", dict(optimizer="sgd")),
    ("dbrx-132b", dict(optimizer="momentum")),
], ids=["mlp_sgd", "mlp_momentum", "mlp_momentum_bf16_buffer", "mlp_sm3", "mlp_shampoo",
        "mlp_pauc_dro", "stablelm_sgd", "dbrx_momentum"])
def test_local_step_matches_reference_in_bf16(arch, kw):
    """One local step from the same bf16 state: the losses and the new bf16
    parameters under the rule; every parameter leaf keeps its dtype."""
    jcfg, cfg, st16, st32, st, (j16, j32), ccfg = _coda_pair(arch, 4, **kw)
    batch = _train_batch(cfg, 4, (K, 6))
    step = lambda c, s: _np(JC.local_step(jcfg, c, _jx(s), _jx(batch), 0.5))
    (n16, l16), (n32, l32) = step(j16, st16), step(j32, st32)
    new, loss = C.local_step(cfg, ccfg, st, P.from_jax_params(cfg, batch), 0.5)
    assert [t.dtype for t in tree_leaves(new["params"])] == \
        [t.dtype for t in tree_leaves(st["params"])]
    _rule(loss, l16, l32, "losses")
    _rule_trees(P.to_jax_params(cfg, new["params"]), n16["params"], n32["params"], "params")
    _rule_trees({k: v.numpy() for k, v in new["duals"].items()}, n16["duals"],
                n32["duals"], "duals")


@pytest.mark.parametrize("compress", ["", "int8"])
def test_average_keeps_bf16_and_matches_reference(compress):
    """Each leaf keeps its dtype; a bf16 leaf is averaged in fp32 and rounded
    once, as ``jnp.mean`` does: within one bf16 ulp of the reference."""
    jcfg, cfg, st16, _, st, _, _ = _coda_pair("stablelm-1.6b", 5)
    rng = np.random.default_rng(5)
    # workers that differ, so the mean is not a no-op
    st16 = dict(st16, params=jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(np.asarray(x, np.float32)
                                          + rng.normal(0, 0.05, x.shape), x.dtype)),
        st16["params"]))
    want = _np(JC.average(_jx(st16), compress=compress or None))
    got = C.average(P.state_from_jax(cfg, C.CoDAConfig(n_workers=K), st16),
                    compress=compress or None)
    assert [t.dtype for t in tree_leaves(got["params"])] == \
        [t.dtype for t in tree_leaves(st["params"])]
    for g, w in zip(tree_leaves(got["params"]), jax.tree_util.tree_leaves(want["params"]),
                    strict=True):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(_f32(g), w, rtol=ULP, atol=1e-7)
        assert torch.equal(g[0], g[1])
    # the payload counts a bf16 leaf at 2 bytes, as the reference does
    assert C.model_bytes(got, compress or None) == JC.model_bytes(want, compress or None)
    if not compress:
        leaves = tree_leaves(got["params"]) + list(got["duals"].values())
        assert C.window_payload_bytes(got) == sum(
            l.numel() // K * (2 if l.dtype == torch.bfloat16 else 4) for l in leaves)


@pytest.mark.parametrize("arch", ["mlp", "stablelm-1.6b"])
def test_fit_matches_reference_on_replayed_windows_in_bf16(arch, monkeypatch):
    """``fit`` (K=2, 2 stages, T0=4, I=2) on the reference's recorded
    windows from its bf16 initial state: the loss history and the final
    parameters under the rule; the fp32 twin is the reference's ``fit``
    replaying the same windows from the widened initial state."""
    jcfg, cfg = _cfgs(arch)
    key = jax.random.PRNGKey(6)
    if arch == "mlp":
        dcfg = JDataConfig(kind="features", n_features=16, signal=1.5)
    else:
        dcfg = JDataConfig(kind="tokens", vocab_size=cfg.vocab_size, seq_len=12, signal=2.0)
    ds = JShardedDataset(key, dcfg, 256, K, target_p=0.71)
    kw = dict(n_workers=K, eta0=0.5, T0=4, I0=2)
    windows, alphas = [], []

    def record(store, batch):
        store.append(_np(batch))
        return batch

    j16 = JC.CoDAConfig(n_workers=K, p_pos=ds.p_pos, param_dtype=jnp.bfloat16)
    jres = JC.fit(key, jcfg, j16, JS.ScheduleConfig(**kw), 2,
                  sample_window=lambda k, i: record(windows, ds.sample_window(k, i, 8)),
                  sample_alpha_batch=lambda k, m: record(alphas, ds.sample_alpha_batch(k, m)))
    st16 = _np(JC.init_state(key, jcfg, j16))
    st32 = dict(st16, params=_widen(st16["params"]), ref_params=_widen(st16["ref_params"]))
    j32 = dataclasses.replace(j16, param_dtype=jnp.float32)
    wit, ait = iter(windows), iter(alphas)
    with monkeypatch.context() as m:     # the fit starts from the widened state
        m.setattr(JC, "init_state", lambda *_: _jx(st32))
        jres32 = JC.fit(key, jcfg, j32, JS.ScheduleConfig(**kw), 2,
                        sample_window=lambda k, i: _jx(next(wit)),
                        sample_alpha_batch=lambda k, m_: _jx(next(ait)))
    ccfg = C.CoDAConfig(n_workers=K, p_pos=ds.p_pos, param_dtype=torch.bfloat16)
    tt = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    wit, ait = iter(windows), iter(alphas)
    res = C.fit(P.state_from_jax(cfg, ccfg, st16), cfg, ccfg, S.ScheduleConfig(**kw), 2,
                sample_window=lambda i: tt(next(wit)),
                sample_alpha_batch=lambda m_: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history] \
        == [h[:2] for h in jres32.history]
    _rule([h[2] for h in res.history], [h[2] for h in jres.history],
          [h[2] for h in jres32.history], "losses")
    _rule_trees(P.to_jax_params(cfg, res.state["params"]), _np(jres.state["params"]),
                _np(jres32.state["params"]), "params")
    assert res.state["params"]["score_head"]["w"].dtype == torch.bfloat16
