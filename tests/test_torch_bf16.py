"""bf16 parameters through the port vs ``repro`` with
``init_params(dtype=bfloat16)`` / ``CoDAConfig(param_dtype=bfloat16)``: the
forward of every ported family, ``prefill_step``, a local step per
optimizer, ``average`` (plain and int8), ``fit`` on replayed windows, the
serving engine, and the weights carried across bit for bit.

The bf16 tolerance.  Two bf16 computations of one function round in
different places (torch and XLA fuse and order their bf16 operations
differently), so they differ by bf16 noise, which an fp32 tolerance cannot
describe.  The noise is measured in each test: the reference run again in
fp32 on the same weights (every bf16 leaf widened exactly).  The rule: the
port's max |difference| from the reference's bf16 result is at most
``FACTOR`` = 2 times the reference's own max |difference| between its bf16
and fp32 results, plus one bf16 ulp of the largest fp32 value (2⁻⁷ of it).
A second rounding of the same function lands about as far from the first
as the first from fp32; the factor leaves room for the spread of a maximum.
Engine tokens are equal to the reference engine's, except after a step
where the reference's top-2 logit gap is within that noise (the rule's
limit for those logits); then the rest of that request is not compared.
MoE routing is a choice too: where the reference's k-th and (k+1)-th router
logits of a token lie within ``ROUTE_MARGIN`` (2⁻⁵, four bf16 ulps at the
logits' O(1) scale) in some layer, bf16 noise may pick the other expert,
and the sequence (every later position attends to that token) is left out
of the comparison; each test still compares some sequences.
Weights crossing between the packages: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.core import schedules as JS
from repro.kernels import ref as jax_kref
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.models import attention as JA
from repro.models import blocks as JBL
from repro.models import embeddings as JE
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import loadgen as JLG
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_smoke_config, mlp_config
from repro_torch.core import coda as C
from repro_torch.core import schedules as S
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as kref
from repro_torch.models import model as M
from repro_torch.serving import loadgen as LG
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves

FACTOR, ULP = 2.0, 2 ** -7
ROUTE_MARGIN = 2 ** -5
K = 2
ARCHS = ["mlp", "resnet50", "stablelm-1.6b", "qwen2.5-14b", "chatglm3-6b",
         "phi3-medium-14b", "dbrx-132b", "arctic-480b"]


def _cfgs(arch):
    if arch == "mlp":
        return jax_mlp_config(n_features=16, d=32), mlp_config(n_features=16, d=32)
    return jax_smoke(arch), get_smoke_config(arch)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _widen(tree):
    """Every bf16 leaf widened to fp32 (exact)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else x, tree)


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _rule(port, ref16, ref32, what=""):
    """|port − ref16| ≤ FACTOR·|ref16 − ref32| + one bf16 ulp of max|ref32|."""
    p, r, f = _f32(port), _f32(ref16), _f32(ref32)
    lim = FACTOR * float(np.abs(r - f).max()) + ULP * float(np.abs(f).max())
    err = float(np.abs(p - r).max())
    assert err <= lim, f"{what}: port vs reference bf16 {err:.3g} > limit {lim:.3g}"


def _rule_trees(port, ref16, ref32, what=""):
    for i, (p, r, f) in enumerate(zip(jax.tree_util.tree_leaves(port),
                                      jax.tree_util.tree_leaves(ref16),
                                      jax.tree_util.tree_leaves(ref32), strict=True)):
        _rule(p, r, f, f"{what} leaf {i}")


def _route_margin(jcfg, p, tok):
    """The reference's bf16 forward of one replica ``p`` over ``tok [B, S]``:
    each token's smallest gap, over the layers, between its k-th and
    (k+1)-th router logits (as log-gates from ``moe.route``): [B, S]."""
    x = JE.embed(p["embed"], tok)
    B, S, d = x.shape
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    k = jcfg.moe.top_k
    gap = jnp.full((B, S), jnp.inf)
    for i in range(jcfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], p["layers"])
        h = JE.apply_norm(jcfg, lp["norm1"], x)
        h2 = JE.apply_norm(jcfg, lp["norm2"],
                           x + JA.attend(jcfg, lp["attn"], h, pos, window=None))
        _, _, gates = JMoE.route(jcfg, lp["moe"], h2.reshape(B * S, d))
        lg = jnp.log(jnp.sort(gates, axis=-1)[:, ::-1])
        gap = jnp.minimum(gap, (lg[:, k - 1] - lg[:, k]).reshape(B, S))
        x = JBL.apply_layer(jcfg, lp, x, pos, -1, kind="decoder", causal=True)[0]
    return gap


def _settled(jcfg, tree, tok):
    """[K, B]: the sequences whose every token routes with a margin of at
    least ROUTE_MARGIN in every layer of the reference (every sequence of a
    dense model); at least one must be."""
    if jcfg.family != "moe":
        return np.ones(tok.shape[:2], bool)
    ok = np.stack([np.asarray(_route_margin(
        jcfg, jax.tree_util.tree_map(lambda a: jnp.asarray(a[w]), tree),
        jnp.asarray(tok[w]))).min(-1) >= ROUTE_MARGIN for w in range(tok.shape[0])])
    assert ok.any(), "every sequence routes near a tie"
    return ok


def _stacked(jcfg, seed, dtype=jnp.bfloat16):
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    return _np(jax.vmap(lambda k: JM.init_params(k, jcfg, dtype=dtype))(keys))


def _inputs(cfg, seed, lead=(K, 3)):
    rng = np.random.default_rng(seed)
    if cfg.family == "mlp":
        return {"features": rng.standard_normal(lead + (cfg.n_features,)).astype(np.float32)}
    if cfg.family == "cnn":
        # the reference's convolution takes bf16 weights only with bf16 images
        x = rng.standard_normal(lead + (16 * 16, 3)).astype(np.float32)
        return {"images": np.asarray(jnp.asarray(x, jnp.bfloat16))}
    return {"tokens": rng.integers(0, cfg.vocab_size, lead + (12,)).astype(np.int32)}


def _widen_inputs(batch):
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else v
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_dtypes_are_the_references(arch):
    """``init_params(dtype=bfloat16)``: every leaf in the reference's dtype
    (norms, the router and the score bias stay fp32), in its order."""
    jcfg, cfg = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jcfg, dtype=jnp.bfloat16),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = [str(x.dtype) for x in jax.tree_util.tree_leaves(shapes)]
    got = [str(t.dtype).replace("torch.", "")
           for t in tree_leaves(M.init_params(cfg, dtype=torch.bfloat16, device="meta"))]
    assert got == want and "bfloat16" in got


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference_in_bf16(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _stacked(jcfg, 1)
    batch = _inputs(cfg, 1)
    score = lambda t, b: np.asarray(jax.vmap(lambda p, x: JM.score(jcfg, p, x)[0])(
        _jx(t), _jx(b)))
    ref16, ref32 = score(tree, batch), score(_widen(tree), _widen_inputs(batch))
    got, aux = M.score(cfg, P.from_jax_params(cfg, tree), P.from_jax_params(cfg, batch))
    assert got.dtype == torch.float32 and got.shape == (K, 3)
    assert aux.dtype == torch.float32 and aux.shape == (K,)
    ok = _settled(jcfg, tree, batch["tokens"]) if "tokens" in batch else np.ones((K, 3), bool)
    _rule(_f32(got)[ok], ref16[ok], ref32[ok], arch)


def test_cnn_fp32_images_with_bf16_weights_raise_in_both():
    """The reference's ResNet convolves fp32 images with bf16 weights only
    after a dtype error, and so does the port: neither casts the images."""
    jcfg, cfg = _cfgs("resnet50")
    tree = _stacked(jcfg, 2)
    x = _widen_inputs(_inputs(cfg, 2))
    with pytest.raises(TypeError):
        jax.vmap(lambda p, b: JM.score(jcfg, p, b))(_jx(tree), _jx(x))
    with pytest.raises(RuntimeError):
        M.score(cfg, P.from_jax_params(cfg, tree), P.from_jax_params(cfg, x))


@pytest.mark.parametrize("arch,use_window", [("stablelm-1.6b", False), ("qwen2.5-14b", True),
                                             ("chatglm3-6b", False), ("dbrx-132b", False)])
def test_prefill_step_matches_reference_in_bf16(arch, use_window):
    """Scores, last-position logits and the bf16 caches of ``prefill_step``
    on bf16 weights (the logits are the bf16 LM head's)."""
    jcfg, cfg = (dataclasses.replace(c, window=5) for c in _cfgs(arch))
    tree = _stacked(jcfg, 3)
    tok = _inputs(cfg, 3)["tokens"]
    run = lambda t: _np(jax.vmap(lambda p, x: JM.prefill_step(
        jcfg, p, {"tokens": x}, use_window=use_window))(_jx(t), jnp.asarray(tok)))
    (s16, l16, kv16), (s32, l32, kv32) = run(tree), run(_widen(tree))
    s, logits, (kc, vc) = M.prefill_step(cfg, P.from_jax_params(cfg, tree),
                                         {"tokens": torch.from_numpy(tok)},
                                         use_window=use_window)
    assert s.dtype == torch.float32 and logits.dtype == torch.bfloat16
    assert kc.dtype == vc.dtype == torch.bfloat16 and l16.dtype == jnp.bfloat16
    ok = _settled(jcfg, tree, tok)
    seq = lambda c: np.swapaxes(_f32(c), 1, 2)[ok]          # [K, L, B, ...] by sequence
    _rule(_f32(s)[ok], s16[ok], s32[ok], "scores")
    _rule(_f32(logits)[ok], l16[ok], l32[ok], "logits")
    _rule(seq(kc), seq(kv16[0]), seq(kv32[0]), "k cache")
    _rule(seq(vc), seq(kv16[1]), seq(kv32[1]), "v cache")


def _coda_pair(arch, seed, **kw):
    """(jax cfg, port cfg, reference bf16 state, its fp32 twin, port state,
    reference CoDA configs (bf16, fp32), port config)."""
    jcfg, cfg = _cfgs(arch)
    j16 = JC.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=jnp.bfloat16, **kw)
    j32 = dataclasses.replace(j16, param_dtype=jnp.float32)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=torch.bfloat16,
                        **{k: (torch.bfloat16 if v is jnp.bfloat16 else v)
                           for k, v in kw.items()})
    st16 = _np(JC.init_state(jax.random.PRNGKey(seed), jcfg, j16))
    st32 = dict(st16, params=_widen(st16["params"]), ref_params=_widen(st16["ref_params"]))
    return jcfg, cfg, st16, st32, P.state_from_jax(cfg, ccfg, st16), (j16, j32), ccfg


def _train_batch(cfg, seed, lead):
    rng = np.random.default_rng(seed)
    b = _inputs(cfg, seed, lead)
    b["labels"] = (rng.random(lead) < 0.7).astype(np.float32)
    return b


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


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_attention_bwd_in_bf16_matches_the_references_vjp(causal, window):
    """K4's backward (plain tensor code, fp32 inside) on bf16 q, k, v, o
    and dO — the CoDA path's on the card — returns each gradient in bf16,
    under the rule against ``jax.vjp`` of the reference's plain attention on
    the bf16 inputs and on the same values in fp32."""
    rng = np.random.default_rng(9)
    bf = lambda *shape: np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    q, k, v, do = bf(2, 12, 4, 16), bf(2, 12, 2, 16), bf(2, 12, 2, 16), bf(2, 12, 4, 16)

    def vjp(*xs):
        _, f = jax.vjp(lambda a, b, c: jax_kref.attention_full(a, b, c, causal=causal,
                                                               window=window),
                       *(jnp.asarray(x) for x in xs[:3]))
        return [np.asarray(g, np.float32) for g in f(jnp.asarray(xs[3]))]

    ref16, ref32 = vjp(q, k, v, do), vjp(*(np.asarray(x, np.float32) for x in (q, k, v, do)))
    tq, tk, tv, tdo = (P.from_jax_params(mlp_config(), {"x": x})["x"] for x in (q, k, v, do))
    o, lse = kref.attention_full(tq, tk, tv, causal=causal, window=window, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = FA.attention_bwd(tq, tk, tv, o, lse, tdo, causal, window)
    for g, r16, r32, name in zip(got, ref16, ref32, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == r16.shape, name
        _rule(g, r16, r32, name)


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


def _engine_run(eng, run, tcfg, vocab):
    reqs, _ = run.run_trace(eng, run.make_trace(run.TraceConfig(**tcfg), vocab))
    return reqs


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_engine_serves_bf16_weights_as_the_reference_engine(arch):
    """The same trace through the reference engine on bf16 weights (and on
    their fp32 twin) and through the port's: every request done, the tokens
    equal up to a near tie of the reference, the score-head logits under
    the rule, and the engine's caches still fp32."""
    jcfg, cfg = _cfgs(arch)
    jp = jax.jit(lambda k: JM.init_params(k, jcfg, dtype=jnp.bfloat16))(jax.random.PRNGKey(7))
    jp32 = _widen(_np(jp))
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    tcfg = dict(kind="batch", n_requests=6, prompt_len=(4, 20), max_new=(3, 7), seed=7)
    kw = dict(slots=3, max_len=32, prefill_chunk=4)
    jreqs = _engine_run(JEngine(jcfg, jp, **kw), JLG, tcfg, cfg.vocab_size)
    jreqs32 = _engine_run(JEngine(jcfg, _jx(jp32), **kw), JLG, tcfg, cfg.vocab_size)
    eng = ServingEngine(cfg, p, **kw)
    reqs = _engine_run(eng, LG, tcfg, cfg.vocab_size)
    assert eng.tokens_prefilled == sum(len(r.prompt_used) for r in reqs)
    assert all(r.status == j.status == "done" for r, j in zip(reqs, jreqs, strict=True))
    # the requests whose prompt (which the score logit reads) routes clear of
    # a tie in the reference
    ok = [cfg.family != "moe" or float(np.min(_route_margin(
        jcfg, jp, jnp.asarray([list(j.prompt_used)], jnp.int32)))) >= ROUTE_MARGIN
        for j in jreqs]
    assert any(ok)
    pick = lambda rs: [r.score for r, o in zip(rs, ok) if o]
    _rule(pick(reqs), pick(jreqs), pick(jreqs32), "score logits")
    # the engine's caches stay fp32 whatever the weights, as the reference's
    floats = [t.dtype for t in tree_leaves(eng.cache) if t.is_floating_point()]
    want = [x.dtype for x in jax.tree_util.tree_leaves(JEngine(jcfg, jp, **kw).cache)
            if jnp.issubdtype(x.dtype, jnp.floating)]
    assert floats and set(floats) == {torch.float32} and {str(d) for d in want} == {"float32"}

    def last_logits(params, seq):
        tok = jnp.asarray(np.asarray(seq, np.int32)[None])
        return np.asarray(JM.prefill_step(jcfg, params, {"tokens": tok})[1][0], np.float32)

    for r, j, o in zip(reqs, jreqs, ok):
        if r.generated == j.generated or not o:
            continue
        i = next(n for n, (a, b) in enumerate(zip(r.generated, j.generated)) if a != b)
        seq = list(j.prompt_used) + j.generated[:i]
        l16, l32 = last_logits(jp, seq), last_logits(_jx(jp32), seq)
        top = np.sort(l16)[-2:]
        lim = FACTOR * float(np.abs(l16 - l32).max()) + ULP * float(np.abs(l32).max())
        assert top[1] - top[0] <= lim, (r.uid, i, top[1] - top[0], lim)
        assert r.generated[:i] == j.generated[:i]


def test_bf16_params_cross_bitwise():
    """The reference's bf16 leaves come across as their bits (numpy has no
    bf16; the port reads the uint16 view) and go back as the exact fp32
    value, which rounds to the same bits: a round trip leaves every bit."""
    jcfg, cfg = _cfgs("dbrx-132b")
    tree = _stacked(jcfg, 8)
    port = P.from_jax_params(cfg, tree)
    for t, x in zip(tree_leaves(port), jax.tree_util.tree_leaves(tree), strict=True):
        if x.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          np.asarray(x).view(np.uint16))
        else:
            assert t.dtype == torch.float32
    back = P.to_jax_params(cfg, port)
    for b, x in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(b, np.asarray(x, np.float32))
    again = P.from_jax_params(cfg, jax.tree_util.tree_map(
        lambda b, x: np.asarray(jnp.asarray(b, x.dtype)), back, tree))
    for a, t in zip(tree_leaves(again), tree_leaves(port), strict=True):
        assert a.dtype == t.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
