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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16 import (ARCHS, K, _cfgs, _f32, _inputs, _jx, _rule, _settled, _stacked, _widen,
                         _widen_inputs)
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from repro.kernels import ref as jax_kref
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import mlp_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as kref
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves


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
