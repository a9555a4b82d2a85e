"""The port's dense family (embeddings, RoPE, mlp, attention, blocks, model,
CoDA training) vs ``repro`` on the four dense smoke configs, on weights
carried across with ``repro_torch.params`` and inputs made with numpy.

The reference runs each worker through ``jax.vmap``; the port runs the K
workers as a batched axis.  Tolerances (fp32 matmuls and reductions summed
in another order):
  * norms, RoPE: atol 1e-6; mlp, attention, the layer stack, hidden
    states: atol 1e-5, rtol 1e-5;
  * scores (sigmoid outputs): atol 1e-5; last-position logits: atol 1e-5,
    rtol 1e-5;
  * bf16 KV caches: one bf16 ulp (rtol 2⁻⁷) on top of the fp32 atol 1e-5,
    since an fp32 value a few ulp apart may round to the neighbouring bf16;
  * one local step: atol 1e-5; ``fit`` on replayed windows (16 local steps):
    losses rtol 1e-4 (atol 1e-6), final parameters atol 1e-4, as
    tests/test_torch_coda.py holds the mlp;
  * parameter counts, leaf layouts, byte accounting: exact.
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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import coda as JC
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import embeddings as JE
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import DENSE_ARCHS, get_config, get_smoke_config
from repro_torch.core import coda as C
from repro_torch.core import schedules as S
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import embeddings as E
from repro_torch.models import mlp as MLP
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"atol": 1e-5, "rtol": 1e-5}
K = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _stacked(init, K, seed):
    """K replicas of a reference init, stacked on a leading axis (numpy)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    return _np(jax.vmap(init)(keys))


def _perturb(tree, seed, scale=0.1):
    """Non-zero biases and norm parameters, so their broadcasts are tested."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, scale, x.shape).astype(x.dtype)
        if x.ndim <= 3 and x.shape[-1] > 1 else x, tree)


def _tokens(seed, cfg, Bsz, Slen):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (K, Bsz, Slen)).astype(np.int32)


def _cfgs(arch):
    return jax_smoke_config(arch), get_smoke_config(arch)


def _bf16_close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_are_the_references(arch):
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (arch, f.name)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2.5-14b"])   # layernorm, rmsnorm
def test_norm_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    d = cfg.d_model
    rng = np.random.default_rng(1)
    p = {"scale": rng.normal(1, 0.2, (K, d)).astype(np.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = rng.normal(0, 0.2, (K, d)).astype(np.float32)
    x = (3 * rng.standard_normal((K, 4, 8, d)) + 0.5).astype(np.float32)
    want = jax.vmap(lambda p_, x_: JE.apply_norm(jcfg, p_, x_))(_jx(p), jnp.asarray(x))
    got = E.apply_norm(cfg, P.from_jax_params(cfg, p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("arch,mode", [("stablelm-1.6b", "partial"), ("qwen2.5-14b", "1d"),
                                       ("chatglm3-6b", "2d-partial")])
def test_rope_matches_reference(arch, mode):
    jcfg, cfg = _cfgs(arch)
    assert cfg.rope == mode
    assert E.rope_dims(cfg) == JE.rope_dims(jcfg)
    x = np.random.default_rng(2).standard_normal((K, 3, 24, 4, cfg.head_dim)).astype(np.float32)
    want = JE.apply_rope(jcfg, jnp.asarray(x.reshape(K * 3, 24, 4, -1)),
                         jnp.arange(24)[None, :])
    got = E.apply_rope(cfg, torch.from_numpy(x), torch.arange(24))
    np.testing.assert_allclose(got.numpy().reshape(K * 3, 24, 4, -1), np.asarray(want),
                               atol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    jcfg, cfg = (dataclasses.replace(c, act=act) for c in _cfgs("stablelm-1.6b"))
    tree = _stacked(lambda k: JMLP.init_mlp(k, jcfg), K, 3)
    x = np.random.default_rng(3).standard_normal((K, 4, 8, cfg.d_model)).astype(np.float32)
    want = jax.vmap(lambda p, x_: JMLP.apply_mlp(jcfg, p, x_))(_jx(tree), jnp.asarray(x))
    got = MLP.apply_mlp(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("window", [None, 5])
def test_attend_matches_reference(arch, window):
    jcfg, cfg = _cfgs(arch)
    tree = _perturb(_stacked(lambda k: JA.init_attention(k, jcfg), K, 4), 4)
    Slen = 12
    x = np.random.default_rng(4).standard_normal((K, 3, Slen, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(Slen)[None, :]
    o, (kc, vc) = jax.vmap(lambda p, x_: JA.attend(jcfg, p, x_, pos, window=window,
                                                   return_kv=True))(_jx(tree), jnp.asarray(x))
    got, (gk, gv) = A.attend(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x),
                             torch.arange(Slen), window=window, return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(o), **TOL)
    assert gk.dtype == gv.dtype == torch.bfloat16
    assert tuple(gk.shape) == kc.shape == (K, 3, Slen, cfg.n_kv_heads, cfg.head_dim)
    _bf16_close(gk, kc)
    _bf16_close(gv, vc)


@pytest.mark.parametrize("mode,every", [("none", 0), ("optional", 0), ("all_but_global", 2)])
@pytest.mark.parametrize("use_window", [False, True])
def test_layer_windows_match_reference(mode, every, use_window):
    jcfg, cfg = (dataclasses.replace(c, n_layers=5, window=7, window_mode=mode,
                                     global_attn_every=every)
                 for c in _cfgs("stablelm-1.6b"))
    want = np.asarray(JB.layer_windows(jcfg, 64, use_window))
    np.testing.assert_array_equal(B.layer_windows(cfg, 64, use_window).numpy(), want)
    assert B.layer_windows_static(cfg, use_window) == JB.layer_windows_static(jcfg, use_window)
    assert [-1 if w is None else w for w in B.layer_windows_static(cfg, use_window)] == \
        want.tolist()


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "chatglm3-6b"])
@pytest.mark.parametrize("use_window", [False, True])
def test_apply_stack_matches_reference(arch, use_window):
    jcfg, cfg = (dataclasses.replace(c, window=6) for c in _cfgs(arch))
    tree = _perturb(_stacked(lambda k: JB.init_stack(k, jcfg, jcfg.n_layers, "decoder"),
                             K, 5), 5)
    Slen = 16
    x = np.random.default_rng(5).standard_normal((K, 2, Slen, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(Slen)[None, :]
    wins = JB.layer_windows(jcfg, Slen, use_window)
    want, _ = jax.vmap(lambda p, x_: JB.apply_stack(jcfg, p, x_, pos, wins))(
        _jx(tree), jnp.asarray(x))
    got, aux = B.apply_stack(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x),
                             torch.arange(Slen), B.layer_windows_static(cfg, use_window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.shape == (K,) and not aux.any()


def _model_pair(arch, seed, **replace):
    jcfg, cfg = (dataclasses.replace(c, **replace) for c in _cfgs(arch))
    tree = _perturb(_stacked(lambda k: JM.init_params(k, jcfg), K, seed), seed, 0.02)
    return jcfg, cfg, tree


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_score_matches_reference(arch):
    jcfg, cfg, tree = _model_pair(arch, 6)
    tok = _tokens(6, cfg, 3, 20)
    want, _ = jax.vmap(lambda p, t: JM.score(jcfg, p, {"tokens": t}))(_jx(tree), jnp.asarray(tok))
    got, aux = M.score(cfg, P.from_jax_params(cfg, tree), {"tokens": torch.from_numpy(tok)})
    assert got.shape == (K, 3) and got.dtype == torch.float32
    assert aux.shape == (K,) and not aux.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("arch,use_window", [(a, False) for a in DENSE_ARCHS]
                         + [("qwen2.5-14b", True)])
def test_prefill_step_matches_reference(arch, use_window):
    jcfg, cfg, tree = _model_pair(arch, 7, window=9)
    tok = _tokens(7, cfg, 2, 24)
    s, logits, (kc, vc) = jax.vmap(lambda p, t: JM.prefill_step(
        jcfg, p, {"tokens": t}, use_window=use_window))(_jx(tree), jnp.asarray(tok))
    gs, glog, (gk, gv) = M.prefill_step(cfg, P.from_jax_params(cfg, tree),
                                        {"tokens": torch.from_numpy(tok)},
                                        use_window=use_window)
    np.testing.assert_allclose(gs.numpy(), np.asarray(s), atol=1e-5)
    assert glog.shape == (K, 2, cfg.vocab_size)
    np.testing.assert_allclose(glog.numpy(), np.asarray(logits), **TOL)
    assert tuple(gk.shape) == kc.shape == (K, cfg.n_layers, 2, 24, cfg.n_kv_heads,
                                           cfg.head_dim)
    _bf16_close(gk, kc)
    _bf16_close(gv, vc)


@pytest.mark.parametrize("tied", [False, True])
def test_lm_logits_matches_reference(tied):
    jcfg, cfg, tree = _model_pair("phi3-medium-14b", 8, tie_embeddings=tied)
    assert ("lm_head" in tree) is not tied
    h = np.random.default_rng(8).standard_normal((K, 5, cfg.d_model)).astype(np.float32)
    want = jax.vmap(lambda p, x: JM.lm_logits(jcfg, p, x))(_jx(tree), jnp.asarray(h))
    got = M.lm_logits(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_params_round_trip_and_layout(arch):
    """The stacked-layer tree crosses both ways unchanged, in jax's leaf
    order, with the port's own init giving the same shapes."""
    jcfg, cfg, tree = _model_pair(arch, 9)
    port = P.from_jax_params(cfg, tree)
    jl = jax.tree_util.tree_leaves(tree)
    assert [tuple(t.shape) for t in tree_leaves(port)] == [x.shape for x in jl]
    assert tuple(port["layers"]["attn"]["wq"].shape) == (
        K, cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    for a, b in zip(jl, jax.tree_util.tree_leaves(P.to_jax_params(cfg, port))):
        np.testing.assert_array_equal(a, b)
    own = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == [x.shape[1:] for x in jl]
    assert own["score_head"]["b"].dtype == own["final_norm"]["scale"].dtype == torch.float32


def test_stablelm_full_width_parameter_count():
    """1,644,369,921 parameters in 17 leaves, as ``jax.eval_shape`` of the
    reference's init counts them; the port counts on the meta device."""
    cfg = get_config("stablelm-1.6b")
    leaves = tree_leaves(M.init_params(cfg, device="meta"))
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_get_config("stablelm-1.6b")),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    jl = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == len(jl) == 17
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jl]
    assert sum(t.numel() for t in leaves) == 1_644_369_921


@pytest.mark.parametrize("arch,n_params,n_leaves", [
    ("chatglm3-6b", 6_243_588_097, 17),      # chip_smoke.py's full-depth hd-128 prefill
    ("qwen2.5-14b", 14_770_038_785, 17),
    ("phi3-medium-14b", 14_659_512_321, 14),
])
def test_full_width_parameter_count_and_leaves(arch, n_params, n_leaves):
    """The port's full-width tree, made on the meta device (no allocation),
    has the reference's leaf shapes in the reference's order, as
    ``jax.eval_shape`` of its init gives them, and the count chip_smoke.py
    checks on the card."""
    leaves = tree_leaves(M.init_params(get_config(arch), device="meta"))
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_get_config(arch)),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    jl = jax.tree_util.tree_leaves(shapes)
    assert len(leaves) == len(jl) == n_leaves
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jl]
    assert [t.dtype for t in leaves] == [torch.float32] * n_leaves
    assert {str(x.dtype) for x in jl} == {"float32"}
    assert sum(t.numel() for t in leaves) == sum(int(np.prod(x.shape)) for x in jl) == n_params


def _coda_pair(arch, K_, seed):
    jcfg, cfg = _cfgs(arch)
    jccfg = JC.CoDAConfig(n_workers=K_, p_pos=0.7)
    ccfg = C.CoDAConfig(n_workers=K_, p_pos=0.7)
    jst = _np(JC.init_state(jax.random.PRNGKey(seed), jcfg, jccfg))
    return jcfg, cfg, jccfg, ccfg, jst, P.state_from_jax(cfg, ccfg, jst)


def test_local_step_matches_reference_with_zero_lm_head_gradient():
    jcfg, cfg, jccfg, ccfg, jst, st = _coda_pair("stablelm-1.6b", 3, 10)
    rng = np.random.default_rng(10)
    y = (rng.random((3, 6)) < 0.7).astype(np.float32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (3, 6, 16)).astype(np.int32),
             "labels": y}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, (gp, _), _ = C.grad_step_scores(cfg, ccfg, st, tb)
    assert gp["lm_head"].shape == st["params"]["lm_head"].shape
    assert not gp["lm_head"].any() and gp["embed"]["table"].any()
    jnew, jloss = jax.jit(lambda s_, b_: JC.local_step(jcfg, jccfg, s_, b_, 0.5))(
        _jx(jst), _jx(batch))
    new, loss = C.local_step(cfg, ccfg, st, tb, 0.5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-5)
    got, want = P.state_to_jax(cfg, new), _np(jnew)
    for field in ("params", "duals", "ref_params", "ref_duals"):
        for g, w in zip(jax.tree_util.tree_leaves(got[field]),
                        jax.tree_util.tree_leaves(want[field]), strict=True):
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=field)
    # the lm_head moved only by the proximal pull towards ref_params (= itself)
    np.testing.assert_array_equal(got["params"]["lm_head"], jst["params"]["lm_head"])


def test_fit_matches_reference_on_replayed_windows():
    """The whole training path on stablelm-1.6b --smoke: the reference's ``fit``
    (K=4, 2 stages, T0=4, I=2, tokens of length 16) with samplers that
    record their windows; the port's ``fit`` replays them from the same
    initial state."""
    jcfg, cfg = _cfgs("stablelm-1.6b")
    K_, I, Bsz = 4, 2, 8
    key = jax.random.PRNGKey(11)
    ds = JShardedDataset(key, JDataConfig(kind="tokens", vocab_size=cfg.vocab_size,
                                          seq_len=16, signal=2.0), 512, K_, target_p=0.71)
    jccfg = JC.CoDAConfig(n_workers=K_, p_pos=ds.p_pos)
    ccfg = C.CoDAConfig(n_workers=K_, p_pos=ds.p_pos)
    kw = dict(n_workers=K_, eta0=0.5, T0=4, I0=I)
    windows, alphas = [], []

    def record(store, batch):
        store.append(_np(batch))
        return batch

    jres = JC.fit(key, jcfg, jccfg, JS.ScheduleConfig(**kw), 2,
                  sample_window=lambda k, i: record(windows, ds.sample_window(k, i, Bsz)),
                  sample_alpha_batch=lambda k, m: record(alphas, ds.sample_alpha_batch(k, m)))
    st0 = P.state_from_jax(cfg, ccfg, _np(JC.init_state(key, jcfg, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    tt = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    res = C.fit(st0, cfg, ccfg, S.ScheduleConfig(**kw), 2,
                sample_window=lambda i: tt(next(wit)),
                sample_alpha_batch=lambda m: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds) == (16, 10)
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(cfg, res.state)
    for g, w in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(_np(jres.state["params"])), strict=True):
        np.testing.assert_allclose(g, w, atol=1e-4)


def test_tree_unflatten_leaves_no_reference_cycle():
    """Rebuilding a tree must not park its leaves in a reference cycle: on
    the card that held every local step's parameter tree until Python's
    cyclic collector ran, and a full-width stablelm-1.6b step ran out of
    memory.  With the collector off, the leaves die with their last
    reference."""
    import gc
    import weakref

    from repro_torch.tree import tree_map, tree_unflatten
    gc.collect()
    gc.disable()
    try:
        t = torch.zeros(3)
        r = weakref.ref(t)
        out = tree_map(lambda x: x, tree_unflatten({"a": [0], "b": {"c": 0}}, [t, t.clone()]))
        del t, out
        assert r() is None
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_tokens_dataset():
    """The ``tokens`` kind: int64 tokens in [0, vocab), positives carry the
    motif tokens (the first 10 % of the vocabulary) far more often."""
    dcfg = DataConfig(kind="tokens", vocab_size=512, seq_len=64, signal=1.0)
    ds = ShardedDataset(dcfg, 2048, 4, seed=3, target_p=0.71)
    w = ds.sample_window(2, 8)
    assert w["tokens"].shape == (2, 4, 8, 64) and w["tokens"].dtype == torch.int64
    tok, y = ds.inputs["tokens"], ds.labels
    assert int(tok.min()) >= 0 and int(tok.max()) < 512
    motif = (tok < 51).float().mean(dim=1)
    # motif share: 0.1 for negatives, 0.25 + 0.75·0.1 for positives
    assert abs(float(motif[y == 0].mean()) - 0.1) < 0.01
    assert abs(float(motif[y == 1].mean()) - 0.325) < 0.01


def test_unported_families_and_kinds_raise():
    cfg = get_smoke_config("stablelm-1.6b")
    init = E.ParamInit(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        B.init_layer(dataclasses.replace(cfg, family="ssm"), "decoder", init)
    with pytest.raises(ValueError, match="unknown layer kind"):
        B.init_layer(cfg, "xlstm", init)
    with pytest.raises(NotImplementedError, match="model zoo"):
        M.init_params(dataclasses.replace(cfg, family="ssm"))
    with pytest.raises(NotImplementedError, match="model zoo"):
        get_smoke_config("xlstm-350m")


@pytest.mark.parametrize("n_layers", [0, 1])
def test_launcher_runs_stablelm_smoke_on_cpu(n_layers):
    """``--arch stablelm-1.6b --smoke --device cpu`` (and with its depth cut
    by ``--n-layers``): the reference's output lines, with the parameter
    count and bytes per round of the reference's smoke config at that depth
    (params + the three fp32 duals)."""
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--arch", "stablelm-1.6b", "--smoke", "--stages", "1", "--t0", "4",
                          "--interval", "2", "--batch", "8", "--n-data", "256",
                          "--n-layers", str(n_layers)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    jcfg = jax_smoke_config("stablelm-1.6b")
    n = JM.count_params(dataclasses.replace(jcfg, n_layers=n_layers or jcfg.n_layers))
    assert re.search(r"^dataset: n=\d+ p_pos=0\.\d+ workers=4$", out.stdout, re.M)
    assert f"model: stablelm-1.6b params/worker={n:,} leaves=17 device=cpu" in out.stdout
    assert re.search(r"^done: 4 iters, 3 comm rounds, [\d.]+s, test AUC=\d\.\d{4}$",
                     out.stdout, re.M), out.stdout
    assert f"bytes/round/worker={(n + 3) * 4:,} " in out.stdout
