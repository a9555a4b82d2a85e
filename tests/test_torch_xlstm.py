"""The port's ssm family (xlstm-350m: mLSTM and sLSTM blocks) vs ``repro``
on the smoke config, part 1 (the CoDA side is tests/test_torch_xlstm_coda.py):
``models/xlstm.py`` (``log_sigmoid``, the chunkwise mLSTM and its gradient,
the recurrent steps, the sequential sLSTM), the layer list, ``score``,
``prefill_step``, ``count_params`` and ``ref_order``, params round trips,
the decode states, ``serve_step``, ``masked_chunk_step``, decode against
the parallel forward, the engine and ``serve_load_report``.

Tolerances: those of tests/_torch_zoo.py (fp32 atol = rtol = 1e-5), and
  * the mLSTM layer (a chunk's products summed in another order than
    XLA's, over outputs up to ~13): atol 1e-4, rtol 1e-5;
  * the port's own chunkwise mLSTM against its recurrent decode and across
    chunk sizes: the reference's atol 2e-4, rtol 2e-3
    (tests/test_decode_consistency.py:86-110);
  * ``log_sigmoid``: within 2 fp32 ulps of ``jax.nn.log_sigmoid``.
Each test states its own where it differs.  About 50 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (DECODE_TOL, K, cfgs, check_cache_shapes, check_configs,
                        check_count_params, check_engine_equals_reference, check_round_trip,
                        check_serve_step_one_token, close, inputs, jx_tree, model_pair,
                        np_tree, tt, vmapped)
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.serving import decode as JD
from repro.serving import loadgen as JLG
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models import xlstm as X
from repro_torch.serving import decode as D
from repro_torch.serving import loadgen as LG
from repro_torch.tree import tree_leaves

ARCH = "xlstm-350m"
MLSTM_TOL = {"atol": 1e-4, "rtol": 1e-5}
SELF_TOL = {"atol": 2e-4, "rtol": 2e-3}
# mLSTM, sLSTM, mLSTM: the sLSTM's fp32 output reaches a later layer
THREE = {"n_layers": 3, "slstm_every": 2}


def _core_pair(kind, seed, n=K):
    """One xLSTM core's reference weights [n, ...] and the port's."""
    jcfg, cfg = cfgs(ARCH)
    init = JX.init_slstm if kind == "slstm" else JX.init_mlstm
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    tree = np_tree(jax.vmap(lambda k: init(k, jcfg))(keys))
    rng = np.random.default_rng(seed)      # non-zero gate biases
    for b in ("bi", "bf", "b_in"):
        if b in tree:
            tree[b] = tree[b] + rng.normal(0, 0.5, tree[b].shape).astype(np.float32)
    return jcfg, cfg, tree, P.from_jax_params(cfg, tree)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _replica(seed, **replace):
    """One replica's reference weights and the port's (K = 1)."""
    jcfg, cfg = cfgs(ARCH, **replace)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, P.from_jax_params(cfg, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jp))


def test_configs_are_the_references():
    check_configs(ARCH)


def test_log_sigmoid_is_jax_log_sigmoid():
    """``jax.nn.log_sigmoid`` is −softplus(−x) with jax's logaddexp
    softplus.  The port's ``log_sigmoid`` (``F.logsigmoid``) is within 2
    fp32 ulps of it on [−40, 40] and at 0, ±1e4, and bitwise on at least
    98 % of the grid; jax's formula written in torch ops
    (``models/ssm.softplus``) is also within 2 ulps but bitwise on fewer
    points (at least 94 %), which is why the port does not use it."""
    from repro_torch.models.ssm import softplus
    x = np.concatenate([np.linspace(-40, 40, 8001), [-1e4, 1e4, 0.0]]).astype(np.float32)
    want = np.asarray(jax.nn.log_sigmoid(jnp.asarray(x)))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    port = X.log_sigmoid(torch.from_numpy(x)).numpy()
    spelled = (-softplus(-torch.from_numpy(x))).numpy()
    for got, share in ((port, 0.98), (spelled, 0.94)):
        assert np.all(np.abs(got - want) <= 2 * ulp)
        assert np.mean(got == want) >= share
    assert np.mean(port == want) > np.mean(spelled == want)


@pytest.mark.parametrize("chunk", [8, 256])
def test_apply_mlstm_matches_reference(chunk):
    """[K=2, B=3, S=32] through chunks of 8 (four carried chunks) and of 256
    (C = S: one chunk), within ``MLSTM_TOL``."""
    jcfg, cfg, tree, p = _core_pair("mlstm", 1)
    x = _x(1, (K, 3, 32, cfg.d_model))
    want = jax.jit(jax.vmap(lambda p_, x_: JX.apply_mlstm(jcfg, p_, x_, chunk=chunk)))(
        jx_tree(tree), x)
    close(X.apply_mlstm(cfg, p, torch.from_numpy(x), chunk=chunk), want, **MLSTM_TOL)
    with pytest.raises(ValueError, match="must divide"):
        X.apply_mlstm(cfg, p, torch.from_numpy(x[:, :, :12]), chunk=8)


def test_mlstm_gradient_matches_jax_grad():
    """The chunkwise mLSTM's gradient (the −inf mask, the stabilisers'
    maxima, the discarded last carry) against ``jax.grad`` of the same sum,
    for the input and every weight: atol 1e-4, rtol 1e-4."""
    jcfg, cfg, tree, p = _core_pair("mlstm", 2)
    x = _x(2, (K, 2, 16, cfg.d_model))
    w = _x(3, (K, 2, 16, cfg.d_model))
    f = lambda p_, x_, w_: jnp.sum(JX.apply_mlstm(jcfg, p_, x_, chunk=4) * w_)
    jg = jax.jit(jax.vmap(jax.grad(f, argnums=(0, 1))))(jx_tree(tree), x, w)
    pt = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (X.apply_mlstm(cfg, pt, xt, chunk=4) * torch.from_numpy(w)).sum().backward()
    close(xt.grad, jg[1], atol=1e-4, rtol=1e-4)
    for k in sorted(pt):
        close(pt[k].grad, jg[0][k], atol=1e-4, rtol=1e-4)


def test_mlstm_chunkwise_equals_recurrent():
    """tests/test_decode_consistency.py:86 on the port: 32 ``decode_mlstm``
    steps against the chunkwise form at chunk 8 (the reference's atol 2e-4,
    rtol 2e-3)."""
    jcfg, cfg, tree, p = _core_pair("mlstm", 2, n=1)
    x = torch.from_numpy(_x(2, (1, 2, 32, cfg.d_model), 0.5))
    par = X.apply_mlstm(cfg, p, x, chunk=8)
    state = X.init_mlstm_state(cfg, 2)
    outs = []
    for t in range(32):
        o, state = X.decode_mlstm(cfg, p, state, x[:, :, t:t + 1])
        outs.append(o)
    close(torch.cat(outs, dim=2), par, **SELF_TOL)


def test_mlstm_chunk_size_invariance():
    """tests/test_decode_consistency.py:102 on the port: chunk 64 against
    chunk 8 over 64 positions (atol 2e-4, rtol 2e-3)."""
    jcfg, cfg, tree, p = _core_pair("mlstm", 3, n=1)
    x = torch.from_numpy(_x(3, (1, 1, 64, cfg.d_model), 0.5))
    close(X.apply_mlstm(cfg, p, x, chunk=64), X.apply_mlstm(cfg, p, x, chunk=8), **SELF_TOL)


def test_decode_mlstm_matches_reference():
    """Three recurrent steps from the zero state, the outputs and the state
    (C, n, m) against the reference's at the fp32 tolerance."""
    jcfg, cfg, tree, p = _core_pair("mlstm", 4, n=1)
    jp = jax.tree_util.tree_map(lambda a: a[0], tree)
    x = _x(4, (3, 2, 1, cfg.d_model))
    js, st = JX.init_mlstm_state(jcfg, 2), X.init_mlstm_state(cfg, 2)
    step = jax.jit(lambda s_, x_: JX.decode_mlstm(jcfg, jp, s_, x_))
    for t in range(3):
        jo, js = step(js, x[t])
        o, st = X.decode_mlstm(cfg, p, st, torch.from_numpy(x[t])[None])
        close(o[0], jo)
    for k in ("C", "n", "m"):
        close(st[k], js[k])


def test_apply_slstm_matches_reference():
    """The sequential sLSTM over [K=2, B=3, S=24] at the fp32 tolerance."""
    jcfg, cfg, tree, p = _core_pair("slstm", 5)
    x = _x(5, (K, 3, 24, cfg.d_model))
    want = jax.jit(jax.vmap(lambda p_, x_: JX.apply_slstm(jcfg, p_, x_)))(jx_tree(tree), x)
    got = X.apply_slstm(cfg, p, torch.from_numpy(x))
    assert got.dtype == torch.float32
    close(got, want)


def test_decode_slstm_matches_reference():
    """Three one-token steps: outputs and the (c, n, h, m) tuple state."""
    jcfg, cfg, tree, p = _core_pair("slstm", 6, n=1)
    jp = jax.tree_util.tree_map(lambda a: a[0], tree)
    x = _x(6, (3, 2, 1, cfg.d_model))
    js, st = JX.init_slstm_state(jcfg, 2), X.init_slstm_state(cfg, 2)
    step = jax.jit(lambda s_, x_: JX.decode_slstm(jcfg, jp, s_, x_))
    for t in range(3):
        jo, js = step(js, x[t])
        o, st = X.decode_slstm(cfg, p, st, torch.from_numpy(x[t])[None])
        close(o[0], jo)
    assert isinstance(st, tuple) and len(st) == 4
    for g, w in zip(st, js, strict=True):
        close(g, w)


def test_xlstm_layers_score_and_prefill_match_reference():
    """Three layers (mLSTM, sLSTM, mLSTM): the kinds, ``apply_xlstm_layers``,
    ``score``, and ``prefill_step``'s scores and last logits with
    ``kv=None``, within ``MLSTM_TOL``; ``lm_logits`` at the fp32 one."""
    jcfg, cfg, tree, p = model_pair(ARCH, 7, **THREE)
    assert B.xlstm_layer_kinds(cfg) == JB.xlstm_layer_kinds(jcfg) == ("mlstm", "slstm", "mlstm")
    assert isinstance(p["layers"], list) and len(p["layers"]) == 3
    b = inputs(cfg, (K, 3), 7, S=16)
    x = _x(7, (K, 3, 16, cfg.d_model))
    want, _ = vmapped(lambda p_, x_: JB.apply_xlstm_layers(jcfg, p_["layers"], x_), tree, x)
    got, aux = B.apply_xlstm_layers(cfg, p["layers"], torch.from_numpy(x))
    close(got, want, **MLSTM_TOL)
    assert aux.shape == (K,) and not aux.any()
    want, _ = vmapped(lambda p_, b_: JM.score(jcfg, p_, b_), tree, b)
    close(M.score(cfg, p, tt(b))[0], want)
    s, logits, kv = vmapped(lambda p_, b_: JM.prefill_step(jcfg, p_, b_), tree, b)
    gs, glog, gkv = M.prefill_step(cfg, p, tt(b))
    assert kv is None and gkv is None and glog.shape == (K, 3, cfg.vocab_size)
    close(gs, s)
    close(glog, logits, **MLSTM_TOL)
    h = _x(8, (K, 5, cfg.d_model))
    close(M.lm_logits(cfg, p, torch.from_numpy(h)),
          vmapped(lambda p_, x_: JM.lm_logits(jcfg, p_, x_), tree, h))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_params_round_trip(dtype):
    check_round_trip(ARCH, dtype)


def test_count_params_and_ref_order():
    """``count_params`` as the reference counts it: 342,334,633 at full
    width.  No xLSTM leaf is read as a convolution: the sLSTM's 5-D ``r``
    ``[K, 4, H, hd, hd]`` keeps the reference's axis order."""
    check_count_params(ARCH, 342_334_633, 411_525)
    jcfg, cfg, tree, p = model_pair(ARCH, 8)
    r = p["layers"][1]["core"]["r"]
    assert r.dim() == 5 and tuple(r.shape) == tree["layers"][1]["core"]["r"].shape
    assert not any(P.conv_flags(p))
    assert P.ref_orders(p) == [tuple(range(t.dim())) for t in tree_leaves(p)]
    assert M.count_params(get_config(ARCH)) == 342_334_633


def test_serve_step_one_token():
    """tests/test_arch_smoke.py::test_serve_step_one_token[xlstm-350m]."""
    check_serve_step_one_token(ARCH)


def test_init_cache_shapes_match_cache_specs():
    """One fp32 state a layer whatever the cache dtype, the sLSTM's a tuple."""
    check_cache_shapes(ARCH)
    cache = D.init_cache(cfgs(ARCH)[1], 2, 16, dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in tree_leaves(cache))
    assert isinstance(cache["layers"][1]["slstm"], tuple)


def test_masked_chunk_step_keeps_dead_rows_bitwise():
    """Rows with 3, 0 and 4 live steps over three layers: the live rows'
    states and tokens match the reference's, the idle row keeps its fresh
    state bitwise (C = n = 0, m = −1e30; the sLSTM's n = 1e-6)."""
    jcfg, cfg, jp, p = _replica(13, **THREE)
    rng = np.random.default_rng(13)
    tok = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    pos = np.array([0, 0, 2], np.int32)
    nst = np.array([3, 0, 4], np.int32)
    jc = JD.init_cache(jcfg, 3, 12, dtype=jnp.float32)
    c = D.init_cache(cfg, 3, 12, dtype=torch.float32)
    jc, jt, js = jax.jit(lambda c_, *a: JD.masked_chunk_step(jcfg, jp, c_, *a))(
        jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(nst))
    c, t, s = D.masked_chunk_step(cfg, p, c, *map(torch.from_numpy, (tok, pos, nst)))
    for g, w in zip(tree_leaves(c), jax.tree_util.tree_leaves(jc), strict=True):
        close(g, w)
    live = np.arange(4)[None, :] < nst[:, None]
    np.testing.assert_array_equal(t.numpy()[live], np.asarray(jt)[live])
    close(s.numpy()[live], np.asarray(js)[live])
    fresh = D.init_cache(cfg, 1, 12, dtype=torch.float32)
    for g, f in zip(tree_leaves(c), tree_leaves(fresh), strict=True):
        assert torch.equal(g[1], f[0])


def test_decode_matches_parallel():
    """tests/test_decode_consistency.py::test_decode_matches_parallel
    [xlstm-350m-False] on the port: 24 tokens through ``serve_step``
    against the parallel forward at the reference's atol = rtol = 2e-3, and
    the same logits against the reference's ``prefill`` at ``MLSTM_TOL``."""
    jcfg, cfg, jp, p = _replica(0)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 24), 0, cfg.vocab_size))
    cache = D.init_cache(cfg, 2, 24, dtype=torch.float32)
    for t in range(24):
        logits, _, cache = D.serve_step(cfg, p, cache, torch.from_numpy(tokens[:, t:t + 1]),
                                        torch.full((2,), t, dtype=torch.int32))
    h, _ = M.backbone(cfg, p, {"tokens": torch.from_numpy(tokens)[None]})
    np.testing.assert_allclose(logits.numpy(), M.lm_logits(cfg, p, h[:, :, -1])[0].numpy(),
                               **DECODE_TOL)
    jc = JD.init_cache(jcfg, 2, 24, dtype=jnp.float32)
    jc, jlog = jax.jit(lambda c_, t_: JD.prefill(jcfg, jp, c_, t_))(jc, jnp.asarray(tokens))
    close(logits, jlog, **MLSTM_TOL)


def test_engine_tokens_equal_the_reference_engines():
    """One batch trace through both engines on the smoke weights, with the
    prefix cache on (its LRU snapshots the sLSTM's tuple state): tokens,
    statuses and counters equal, scores at the fp32 tolerance."""
    check_engine_equals_reference(
        ARCH, 14, dict(slots=3, max_len=32, prefill_chunk=4, prefix_cache_size=4),
        dict(n_requests=6, prompt_len=(4, 20), max_new=(3, 7), prefix_pool=2,
             prefix_len=6))


def test_serve_load_report_has_the_references_record():
    """``serve_load_report`` on the CPU: the reference's record keys (with
    the sketch metric on a labeled trace), every request served, and the
    knobs and trace echoed as the reference echoes them."""
    kw = dict(engine_kw={"slots": 2, "max_len": 32},
              trace_kw={"kind": "batch", "n_requests": 3, "prompt_len": (4, 12),
                        "max_new": (2, 4), "labeled": True}, metric_backend="sketch")
    got = LG.serve_load_report(ARCH, device="cpu", **kw)
    want = JLG.serve_load_report(ARCH, **kw)
    assert got.keys() == want.keys()
    assert got["metrics"].keys() == want["metrics"].keys()
    assert got["knobs"] == want["knobs"] and got["trace"] == want["trace"]
    assert got["metrics"]["completed"] == 3 and got["metrics"]["streaming_scored"] == 3
    assert np.isfinite(got["metrics"]["ttft_p50_ms"])
    if not torch.cuda.is_available():       # the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            LG.serve_load_report(ARCH, **kw)
