"""The port's hybrid family (hymba-1.5b: attention and a Mamba-style SSM
branch in every layer) vs ``repro`` on the smoke config: ``models/ssm.py``
(``softplus``, ``_causal_conv``, ``apply_ssm`` with its chunked scan,
``decode_ssm``), the hybrid layer and stack, ``score``, ``prefill_step``,
``lm_logits``, ``count_params``, params and state round trips, a local step
(sgd and sm3), ``fit`` on replayed windows, bf16 as the reference runs it,
the serving caches, ``serve_step``, ``masked_chunk_step``, decode against
the parallel forward, one engine run and the launcher's accounting
against the reference launcher's.

Tolerances: those of tests/_torch_zoo.py, and for the SSM layer (the
reference's ``associative_scan`` and the port's chunked scan multiply the
decays in another order) atol 1e-5, rtol 1e-4 on the layer's output; the
scan's gradient against autograd through the step-by-step recurrence at
atol 1e-5, rtol 1e-4; decode against the parallel SSM at the reference's
own atol 1e-4, rtol 1e-3 (tests/test_decode_consistency.py:113).  About
30 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (DECODE_TOL, K, cfgs,
                        check_arch_smoke_forward_and_coda_step, check_bf16_as_the_reference,
                        check_cache_shapes, check_configs, check_depth_cut,
                        check_launcher_accounting, check_count_params,
                        check_engine_equals_reference, check_fit_replayed, check_local_step,
                        check_sm3_axis_rules, check_round_trip, check_score_prefill,
                        check_serve_step_one_token, close, jx_tree, model_pair, np_tree,
                        vmapped)
from repro.models import blocks as JB
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving import decode as JD
from repro_torch import params as P
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.serving import decode as D
from repro_torch.tree import tree_leaves

ARCH = "hymba-1.5b"

SSM_TOL = {"atol": 1e-5, "rtol": 1e-4}


def _ssm_pair(seed, n=K):
    jcfg, cfg = cfgs(ARCH)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    tree = np_tree(jax.vmap(lambda k: JSSM.init_ssm(k, jcfg))(keys))
    rng = np.random.default_rng(seed)      # non-zero conv and dt biases
    tree["conv_b"] = tree["conv_b"] + rng.normal(0, 0.1, tree["conv_b"].shape).astype(np.float32)
    return jcfg, cfg, tree, P.from_jax_params(cfg, tree)


def test_configs_are_the_references():
    check_configs(ARCH)


def test_softplus_is_jax_softplus_where_torch_thresholds():
    """``jax.nn.softplus`` is logaddexp(x, 0); torch's ``F.softplus``
    returns x itself past its threshold of 20.  The port's ``softplus``
    equals jax's to an ulp everywhere, ``F.softplus`` away from that edge."""
    x = np.concatenate([np.linspace(-40, 40, 4001), [-1e4, 19.99, 20.0, 20.01, 1e4]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = SSM.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    np.testing.assert_allclose(F.softplus(torch.from_numpy(x)).numpy(), want, rtol=2e-7,
                               atol=1e-37)


def test_init_ssm_leaves():
    """The reference's leaves and dtypes: ``dt_bias = log(expm1(0.01))`` in
    the parameter dtype, ``A_log = log(1..N)`` and ``D = 1`` in fp32 under
    bf16 parameters too.  Within one fp32 ulp (2⁻²³ relative): XLA's ``log``
    rounds log(7) one ulp away from torch's correctly rounded value."""
    from repro_torch.models.embeddings import ParamInit
    jcfg, cfg = cfgs(ARCH)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg, dtype=jdt)
        got = SSM.init_ssm(cfg, ParamInit(torch.Generator().manual_seed(0), dt))
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        for k in ("dt_bias", "A_log", "D", "conv_b"):
            np.testing.assert_allclose(got[k].float().numpy(), np.asarray(want[k], np.float32),
                                       rtol=2 ** -23, atol=0, err_msg=k)


def test_causal_conv_matches_reference():
    jcfg, cfg, tree, p = _ssm_pair(1)
    xi = np.random.default_rng(1).standard_normal((K, 3, 11, 2 * cfg.d_model)).astype(np.float32)
    want = jax.vmap(JSSM._causal_conv)(jx_tree(tree), jnp.asarray(xi))
    close(SSM._causal_conv(p, torch.from_numpy(xi)), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("S", [16, 37])
def test_apply_ssm_matches_reference(S):
    """The chunked scan at a length that fills its chunks (16: 4 × 4) and a
    ragged one (37: 7 chunks of 6, the last padded)."""
    jcfg, cfg, tree, p = _ssm_pair(2)
    x = (np.random.default_rng(S).standard_normal((K, 2, S, cfg.d_model)) * 0.5).astype(
        np.float32)
    want = jax.vmap(lambda p_, x_: JSSM.apply_ssm(jcfg, p_, x_))(jx_tree(tree), jnp.asarray(x))
    close(SSM.apply_ssm(cfg, p, torch.from_numpy(x)), want, **SSM_TOL)


def test_linear_scan_and_its_gradient_against_the_recurrence():
    """``linear_scan`` (forward and backward) against autograd through the
    step-by-step recurrence h_t = a_t·h_{t-1} + b_t, along a middle axis."""
    g = torch.Generator().manual_seed(3)
    a = torch.rand((2, 3, 29, 5), generator=g, dtype=torch.float64).requires_grad_()
    b = torch.randn((2, 3, 29, 5), generator=g, dtype=torch.float64).requires_grad_()
    w = torch.randn((2, 3, 29, 5), generator=g, dtype=torch.float64)
    h = SSM.linear_scan(a, b, dim=2)
    hs, prev = [], torch.zeros_like(b[:, :, 0])
    for t in range(29):
        prev = a[:, :, t] * prev + b[:, :, t]
        hs.append(prev)
    want = torch.stack(hs, dim=2)
    torch.testing.assert_close(h, want, atol=1e-12, rtol=1e-12)
    got = torch.autograd.grad((h * w).sum(), (a, b))
    exp = torch.autograd.grad((want * w).sum(), (a, b))
    for x, y in zip(got, exp):
        torch.testing.assert_close(x, y, atol=1e-12, rtol=1e-12)
    # fp32, the dtype the layer runs it in
    a32, b32 = a.detach().float(), b.detach().float()
    torch.testing.assert_close(SSM.linear_scan(a32, b32, 2), want.detach().float(),
                               atol=1e-5, rtol=1e-4)


def test_ssm_gradient_matches_reference():
    """The layer's input and parameter gradients against ``jax.grad`` of the
    reference's ``apply_ssm`` (the scan's backward inside)."""
    jcfg, cfg, tree, p = _ssm_pair(4, n=1)
    x = (np.random.default_rng(4).standard_normal((1, 2, 12, cfg.d_model)) * 0.5).astype(
        np.float32)
    w = np.random.default_rng(5).standard_normal((1, 2, 12, cfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p_, x_: jnp.sum(JSSM.apply_ssm(jcfg, p_, x_) * w[0]),
                          argnums=(0, 1)))(jx_tree({k: v[0] for k, v in tree.items()}),
                                           jnp.asarray(x[0]))
    leaves = [l.requires_grad_() for l in tree_leaves(p)]
    xt = torch.from_numpy(x).requires_grad_()
    from repro_torch.tree import tree_unflatten
    out = SSM.apply_ssm(cfg, tree_unflatten(p, leaves), xt)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves + [xt])
    close(grads[-1][0], jg[1], atol=1e-5, rtol=1e-4)
    for g, want in zip(grads[:-1], jax.tree_util.tree_leaves(jg[0]), strict=True):
        close(g[0], want, atol=1e-5, rtol=1e-4)


def test_ssm_decode_matches_parallel():
    """``tests/test_decode_consistency.py::test_ssm_decode_matches_parallel``
    on the port (16 steps of ``decode_ssm`` against ``apply_ssm``, atol 1e-4,
    rtol 1e-3), and each step against the reference's ``decode_ssm``."""
    jcfg, cfg, tree, p = _ssm_pair(5, n=1)
    x = (np.random.default_rng(5).standard_normal((1, 2, 16, cfg.d_model)) * 0.5).astype(
        np.float32)
    par = SSM.apply_ssm(cfg, p, torch.from_numpy(x))
    jp = jx_tree({k: v[0] for k, v in tree.items()})
    state, jstate = SSM.init_ssm_state(cfg, 2), JSSM.init_ssm_state(jcfg, 2)
    outs = []
    for t in range(16):
        o, state = SSM.decode_ssm(cfg, p, state, torch.from_numpy(x[:, :, t:t + 1]))
        jo, jstate = JSSM.decode_ssm(jcfg, jp, jstate, jnp.asarray(x[0, :, t:t + 1]))
        close(o[0], jo)
        for k in ("conv", "h"):
            close(state[k], jstate[k])
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), par.numpy(), atol=1e-4,
                               rtol=1e-3)


def test_hybrid_stack_matches_reference():
    """The hybrid layers (attention and the SSM branch averaged, windowed and
    global layers) over a sequence longer than the smoke window."""
    jcfg, cfg = cfgs(ARCH, window=6)
    keys = jax.random.split(jax.random.PRNGKey(6), K)
    tree = np_tree(jax.vmap(lambda k: JB.init_stack(k, jcfg, jcfg.n_layers, "decoder"))(keys))
    assert "ssm" in tree and "norm_h" in tree
    S = 14
    x = np.random.default_rng(6).standard_normal((K, 2, S, cfg.d_model)).astype(np.float32)
    pos = jnp.arange(S)[None, :]
    wins = JB.layer_windows(jcfg, S, True)
    assert np.asarray(wins).tolist() == [-1, -1]       # layer 0 and the last are global
    jcfg3, cfg3 = cfgs(ARCH, window=6, n_layers=3)
    assert B.layer_windows_static(cfg3, True) == [None, 6, None]
    want, _ = vmapped(lambda p_, x_: JB.apply_stack(jcfg, p_, x_, pos, wins), tree, x)
    got, aux = B.apply_stack(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x),
                             torch.arange(S), B.layer_windows_static(cfg, True))
    close(got, want)
    assert not aux.any()


def test_score_prefill_and_lm_logits_match_reference():
    check_score_prefill(ARCH, 7, S=20, window=8, n_layers=3)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_params_round_trip(dtype):
    check_round_trip(ARCH, dtype)


def test_count_params_and_ref_order():
    """``count_params`` as the reference counts it; the stacked SSM leaves
    are 4-D with K (``[K, L, a, b]``), never read as convolutions by
    ``params.ref_order``."""
    check_count_params(ARCH, 1_662_214_401, 745_985)
    jcfg, cfg, tree, p = model_pair(ARCH, 8)
    for leaf in tree_leaves(p["layers"]["ssm"]):
        assert leaf.dim() in (3, 4)
        assert P.ref_order(leaf) == tuple(range(leaf.dim()))


def test_local_step_matches_reference():
    check_local_step(ARCH, 9)


def test_sm3_axis_rules_take_the_ssm_leaves():
    check_sm3_axis_rules(ARCH)


def test_fit_matches_reference_on_replayed_windows():
    check_fit_replayed(ARCH, 10)


def test_bf16_as_the_reference_runs_it():
    check_bf16_as_the_reference(ARCH, 11)


def test_forward_and_coda_step():
    """tests/test_arch_smoke.py::test_forward_and_coda_step[hymba-1.5b]."""
    check_arch_smoke_forward_and_coda_step(ARCH)


def test_serve_step_one_token():
    """tests/test_arch_smoke.py::test_serve_step_one_token[hymba-1.5b]."""
    check_serve_step_one_token(ARCH)


def test_init_cache_shapes_match_cache_specs():
    check_cache_shapes(ARCH)


def test_masked_chunk_step_keeps_dead_rows_bitwise():
    """Rows with 3, 0 and 4 live steps: the SSM state and the attention
    caches of dead steps are kept bitwise, live ones match the reference."""
    jcfg, cfg = cfgs(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(12), jcfg)
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    rng = np.random.default_rng(12)
    tok = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    pos = np.array([0, 0, 2], np.int32)
    nst = np.array([3, 0, 4], np.int32)
    jc = JD.init_cache(jcfg, 3, 12, dtype=jnp.float32)
    c = D.init_cache(cfg, 3, 12, dtype=torch.float32)
    jc, jt, _ = jax.jit(lambda c_, *a: JD.masked_chunk_step(jcfg, jp, c_, *a))(
        jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(nst))
    c, t, _ = D.masked_chunk_step(cfg, p, c, *map(torch.from_numpy, (tok, pos, nst)))
    for g, w in zip(tree_leaves(c), jax.tree_util.tree_leaves(jc), strict=True):
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w)
    live = np.arange(4)[None, :] < nst[:, None]
    np.testing.assert_array_equal(t.numpy()[live], np.asarray(jt)[live])
    for lc in c["layers"]:                    # the idle row never moved
        assert not lc["ssm"]["h"][1].any() and not lc["ssm"]["conv"][1].any()


def test_decode_matches_parallel():
    """tests/test_decode_consistency.py::test_decode_matches_parallel
    [hymba-1.5b-True] on the port: 24 tokens through ``serve_step`` (window
    rings, the SSM state, global layers) against the parallel forward, the
    reference's atol = rtol = 2e-3; and the same logits against the
    reference's decode at the fp32 tolerance."""
    jcfg, cfg = cfgs(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 24), 0, cfg.vocab_size))
    cache = D.init_cache(cfg, 2, 24, use_window=True, dtype=torch.float32)
    for t in range(24):
        logits, _, cache = D.serve_step(cfg, p, cache, torch.from_numpy(tokens[:, t:t + 1]),
                                        torch.full((2,), t, dtype=torch.int32))
    h, _ = M.backbone(cfg, p, {"tokens": torch.from_numpy(tokens)[None]}, use_window=True)
    np.testing.assert_allclose(logits.numpy(), M.lm_logits(cfg, p, h[:, :, -1])[0].numpy(),
                               **DECODE_TOL)
    jc = JD.init_cache(jcfg, 2, 24, use_window=True, dtype=jnp.float32)
    jc, jlog = jax.jit(lambda c_, t_: JD.prefill(jcfg, jp, c_, t_))(jc, jnp.asarray(tokens))
    close(logits, jlog)


def test_engine_tokens_equal_the_reference_engines():
    """One batch trace through both engines on hymba's smoke weights (ring
    caches on the windowed layer beside the SSM state)."""
    check_engine_equals_reference(
        ARCH, 13, dict(slots=3, max_len=32, prefill_chunk=4),
        dict(n_requests=5, prompt_len=(4, 20), max_new=(3, 7)))


def test_launcher_schedule_and_bytes_per_round(capsys):
    """``--arch hymba-1.5b --smoke``: the reference launcher's schedule and
    bytes per round (the 745,985 parameters and 3 duals)."""
    out = check_launcher_accounting(ARCH, capsys)
    assert f"bytes/round/worker={(745_985 + 3) * 4:,} " in out
    assert "model: hymba-1.5b params/worker=745,985 leaves=24 device=cpu" in out


def test_launcher_cuts_the_depth(capsys):
    check_depth_cut(ARCH, capsys)

