"""K4 at rows with no valid key (a window that closes before the keys
begin, or every row of a causal mask with window 0): the port's forward and
backward against the reference function on the CPU.

The reference (``repro.kernels.ref.attention_full``) masks every score of
such a row to −1e30, and its softmax then weighs all Skv keys equally: o is
the mean of the KV head's V, and ``jnp.where`` cuts the gradient of every
masked score.  ``FlashAttention`` on CPU tensors runs the plain forward and
``attention_bwd``; both are held to ``jax.vjp`` of the reference.  On the
card the same rows come from ``flash_fill_no_key`` after the variant
(``tests/test_torch_attention.py``'s card cases and ``chip_smoke.py``).

Tolerances: fp32 atol 1e-5 (rtol 0) on o, dq, dk and dv — sums of at most
Skv products in another order, values up to ~10; bf16 the repo's bf16 rule
(``tests/_torch_bf16.py``): the port within twice the reference's own bf16
distance from its fp32 result plus one bf16 ulp of that result's largest
value.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

F32_TOL = {"atol": 1e-5, "rtol": 0.0}
NEG_INF_F32 = np.float32(-1e30)

# B, S, H, KV, Skv, hd, causal, window; the first keyless row in the id
CASES = [
    pytest.param(1, 200, 2, 2, 64, 64, False, 16, id="noncausal_window16_rows79on"),
    pytest.param(1, 300, 2, 2, 64, 128, True, 16, id="causal_window16_hd128_rows79on"),
    pytest.param(2, 64, 4, 1, 16, 64, True, 4, id="packed_mqa_window4_rows19on"),
    pytest.param(1, 130, 4, 2, 130, 32, True, 0, id="causal_window0_every_row"),
]


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jax_ref
    return jax, jax.numpy, jax_ref


def _inputs(B, S, H, KV, Skv, hd):
    rng = np.random.default_rng(1000 * S + 10 * Skv + hd)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


def _jax_vjp(jref, q, k, v, do, causal, window, dtype):
    """The reference's output and (dq, dk, dv) at ``dtype`` (jnp), as fp32."""
    jax, jnp, jax_ref = jref

    @jax.jit
    def fwd_bwd(a, b, c, d):
        o, vjp = jax.vjp(lambda x, y, z: jax_ref.attention_full(x, y, z, causal=causal,
                                                                window=window), a, b, c)
        return (o, *vjp(d))

    out = fwd_bwd(*(jnp.asarray(x, dtype) for x in (q, k, v, do)))
    return [np.asarray(t, np.float32) for t in out]


def _port(q, k, v, do, causal, window, dtype):
    """``FlashAttention.apply`` on CPU tensors: output and (dq, dk, dv)."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = fa.FlashAttention.apply(tq, tk, tv, causal, window)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do).to(dtype))
    assert o.dtype == dtype and all(g.dtype == dtype for g in grads)
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", CASES)
def test_forward_and_backward_match_jax_vjp(jref, B, S, H, KV, Skv, hd, causal, window):
    """fp32: o, dq, dk and dv of ``FlashAttention`` within atol 1e-5 of
    ``jax.vjp`` of the reference, at every row.  Every key's dk and dv is a
    sum over rows, so a keyless row's P or dS, if wrong, shows in all of
    them."""
    q, k, v, do = _inputs(B, S, H, KV, Skv, hd)
    assert fa.no_key_rows(S, Skv, causal, window) is not None
    want = _jax_vjp(jref, q, k, v, do, causal, window, np.float32)
    got = _port(q, k, v, do, causal, window, torch.float32)
    for g, w, name in zip(got, want, ("o", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", CASES)
def test_bf16_forward_and_backward_under_the_bf16_rule(jref, B, S, H, KV, Skv, hd, causal,
                                                      window):
    """bf16 inputs: the port's o, dq, dk and dv against the reference's bf16
    ``jax.vjp`` under the bf16 rule, its fp32 ``jax.vjp`` on the same
    bf16-valued inputs as the yardstick."""
    import jax.numpy as jnp
    from _torch_bf16 import _rule
    q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in _inputs(B, S, H, KV, Skv, hd))
    ref16 = _jax_vjp(jref, q, k, v, do, causal, window, jnp.bfloat16)
    ref32 = _jax_vjp(jref, q, k, v, do, causal, window, np.float32)
    got = _port(q, k, v, do, causal, window, torch.bfloat16)
    for g, r16, r32, name in zip(got, ref16, ref32, ("o", "dq", "dk", "dv")):
        _rule(g, r16, r32, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", CASES)
def test_every_row_matches_the_plain_version(jref, B, S, H, KV, Skv, hd, causal, window,
                                             dtype):
    """The wrapper's o and lse on CPU tensors are the plain version's at every
    row; the keyless rows' lse is fp32(−1e30) bitwise and their o the fp32
    mean of V (the reference's, at atol 1e-5 in fp32), which is also what
    ``fill_no_key_ref`` and ``_fill`` (its CPU form) write into rows they are
    given, leaving the others as they were."""
    _, jnp, jax_ref = jref
    q, k, v, _ = (torch.from_numpy(x).to(dtype) for x in _inputs(B, S, H, KV, Skv, hd))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
    first = fa.no_key_rows(S, Skv, causal, window)
    keyless = lse[:, :, first:].numpy()
    assert keyless.dtype == np.float32 and (keyless == NEG_INF_F32).all()
    assert float(NEG_INF_F32) == -1.0000000150474662e30
    if dtype == torch.float32:
        ref_o = np.asarray(jax_ref.attention_full(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                                  causal=causal, window=window))
        np.testing.assert_allclose(o.numpy(), ref_o, **F32_TOL)
        mean = v.double().mean(dim=1).repeat_interleave(H // KV, dim=1)    # [B, H, hd]
        np.testing.assert_allclose(o[:, first:].numpy(),
                                   mean[:, None].expand(B, S - first, H, hd).numpy(),
                                   **F32_TOL)
    for fill in (fa.fill_no_key_ref, fa._fill):
        got_o, got_lse = torch.full_like(o, 7.0), torch.full_like(lse, 7.0)
        fill(got_o, got_lse, v, first)
        # a sum times 1/Skv against the softmax's weights 1/Skv times each
        # value: fp32 rounding apart, then at most one ulp of q's dtype
        torch.testing.assert_close(got_o[:, first:], o[:, first:], atol=1e-6,
                                   rtol=1e-6 if dtype == torch.float32 else 2 ** -7)
        assert torch.equal(got_lse[:, :, first:], lse[:, :, first:])
        assert bool((got_o[:, :first] == 7.0).all() and (got_lse[:, :, :first] == 7.0).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, -1, 0, 1, 16, 300])
def test_no_key_rows_is_the_masks_first_keyless_row(jref, causal, window):
    """``no_key_rows`` against the reference's ``_mask(...).any(-1)``: the
    first row with no valid key, every row after it keyless too, and None
    when every row has a key."""
    _, jnp, jax_ref = jref
    # row q's and key kv's entry depends on q and kv alone: each [S, Skv]
    # mask is the top-left corner of the largest one
    full = np.asarray(jax_ref._mask(jnp.arange(320), jnp.arange(299), causal, window))
    for S in (1, 17, 64, 300, 320):
        for Skv in (1, 16, 64, 299):
            keyed = full[:S, :Skv].any(-1)
            first = fa.no_key_rows(S, Skv, causal, window)
            if keyed.all():
                assert first is None, (S, Skv)
            else:
                assert first == int(np.argmin(keyed)) and not keyed[first:].any(), (S, Skv)


def test_no_key_fill_is_counted_apart():
    """The fill has its own counter, out of ``variant_launches`` (the
    per-variant counts stay four), reset by ``zero_launches``; CPU tensors
    count nothing."""
    assert "flash_fill_no_key" not in fa.variant_launches and len(fa.variant_launches) == 4
    fa.no_key_fills = 5
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 200, 2, 2, 64, 64))
    fa.flash_attention_fwd(q, k, v, causal=False, window=16)
    assert fa.no_key_fills == 5
    fa.zero_launches()
    assert fa.no_key_fills == 0 and fa.launches == 0


@pytest.mark.parametrize("dtype,off,copied", [
    (torch.float32, 4, True), (torch.float32, 8, True), (torch.float32, 16, False),
    (torch.bfloat16, 2, True), (torch.bfloat16, 8, False), (torch.bfloat16, 16, False),
])
def test_a_base_flash_fwd_cannot_read_is_copied(dtype, off, copied):
    """The wrapper's ``_readable``: a base off the 16-byte (fp32) or 8-byte
    (bf16) alignment of ``flash_fwd``'s four-value loads becomes a copy in a
    fresh allocation with the same values; any other base stays."""
    n = off // torch.empty((), dtype=dtype).element_size()
    buf = torch.arange(64 + n, dtype=dtype)
    assert buf.data_ptr() % 64 == 0
    t = buf[n:]
    got = fa._readable(t)
    assert (got.data_ptr() != t.data_ptr()) == copied and torch.equal(got, t)
    assert got.data_ptr() % (4 * t.element_size()) == 0
