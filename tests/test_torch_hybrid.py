"""The port's hybrid family (hymba-1.5b: attention and a Mamba-style SSM
branch in every layer) vs ``repro`` on the smoke config, its layers and
model: ``models/ssm.py`` (``softplus``, ``_causal_conv``, ``apply_ssm`` with
its chunked scan, ``decode_ssm``), the hybrid layer and stack, ``score``,
``prefill_step``, ``lm_logits``, ``count_params``, params and state round
trips, and bf16 as the reference runs it.  Training and serving (a local
step, sm3, ``fit``, the caches, ``serve_step``, ``masked_chunk_step``,
decode, the engine, the launcher) are in tests/test_torch_hybrid_coda.py.

Tolerances: those of tests/_torch_zoo.py, and for the SSM layer (the
reference's ``associative_scan`` and the port's chunked scan multiply the
decays in another order) atol 1e-5, rtol 1e-4 on the layer's output; the
scan's gradient against autograd through the step-by-step recurrence at
atol 1e-5, rtol 1e-4; decode against the parallel SSM at the reference's
own atol 1e-4, rtol 1e-3 (tests/test_decode_consistency.py:113).  About
15 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (K, cfgs, check_bf16_as_the_reference, check_configs,
                        check_count_params, check_round_trip, check_score_prefill, close,
                        jx_tree, model_pair, np_tree, vmapped)
from repro.models import blocks as JB
from repro.models import ssm as JSSM
from repro_torch import params as P
from repro_torch.models import blocks as B
from repro_torch.models import ssm as SSM
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


def test_bf16_as_the_reference_runs_it():
    check_bf16_as_the_reference(ARCH, 11)
