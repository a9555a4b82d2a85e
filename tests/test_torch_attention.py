"""repro_torch attention (K4 flash_attention's plain version, its backward,
and the dispatch) vs the reference's oracles and its Pallas kernel in
interpret mode; and — on a card — the CUDA kernel vs its plain version.

Tolerances:
  * forward vs ``repro.kernels.ref.attention_full`` and vs the Pallas
    kernel (interpret mode): atol 2e-5, rtol 2e-5, the reference's own
    (tests/test_kernels_attention.py:39) — fp32 sums in another order;
    bf16 (here, and on the card through flash_fwd at head_dim 16/32): one
    bf16 ulp of the output (rtol 2^-7) plus atol 1e-4 — both sides compute
    in fp32 and round once;
  * on the card, fp32 through flash_fwd_tf32x3 (head_dim 64 and 128): the
    same atol 2e-5, rtol 2e-5 — split TF32 drops ~2^-21 of each product,
    which the CPU emulation below (the kernel's tiles, product order and
    online softmax) holds to that tolerance before the card does;
  * on the card, bf16 through flash_fwd_wgmma (head_dim 64/128): rtol 2^-7
    plus atol 2^-9·max|v| + 1e-4 — the kernel rounds each probability to
    bf16 (relative error ≤ 2^-9) before P·V, as every tensor-core attention
    does, and the weights sum to 1, so that rounding moves an output by at
    most 2^-9·max|v|; the final rounding is the one ulp;
  * the log-sum-exp vs ``jax.nn.logsumexp`` of the reference's masked
    scores: atol 2e-5;
  * ``attention_bwd`` vs ``jax.vjp`` of ``ref.attention_full``: atol 5e-5,
    rtol 5e-5 (dq, dk, dv are sums of S·Skv products, summed in another
    order; dk and dv also over the G query heads of a KV head).

The card cases need no jax: ``PYTHONPATH=src python -m pytest --noconftest
-q -m cuda tests/test_torch_attention.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as fa
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

TOL = {"atol": 2e-5, "rtol": 2e-5}
BWD_TOL = {"atol": 5e-5, "rtol": 5e-5}
# bf16 output: both sides compute in fp32 and round once to bf16, so they
# may differ by one bf16 ulp (≤ 2^-7 of the value) plus fp32 noise near zero
BF16_TOL = {"atol": 1e-4, "rtol": 2 ** -7}


def wgmma_tol(v) -> dict:
    """flash_fwd_wgmma's bf16 tolerance (see the module docstring): one ulp
    of the output plus P's rounding, 2^-9 of the largest |v|."""
    return {"atol": 2 ** -9 * float(v.float().abs().max()) + 1e-4, "rtol": 2 ** -7}

# the reference's shape table (tests/test_kernels_attention.py:22-28):
# B, S, H, KV, hd and the Pallas kernel's block_q, block_k
SHAPES = [
    (1, 128, 4, 4, 32, 64, 64),
    (2, 256, 4, 2, 16, 64, 128),   # GQA 2:1
    (1, 128, 8, 1, 64, 32, 32),    # MQA
    (2, 64, 2, 2, 128, 64, 64),    # single q block
    (1, 192, 3, 1, 8, 64, 64),     # odd head count, 3 kv blocks
]


@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jax_ref
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    return jax, jax.numpy, jax_ref, pallas_flash


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _qkv(seed, B, S, H, KV, hd, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_and_pallas(jref, B, S, H, KV, hd, bq, bk, causal):
    _, jnp, jax_ref, pallas_flash = jref
    q, k, v = _qkv(B * S + H, B, S, H, KV, hd)
    got = ref.attention_full(*_t(q, k, v), causal=causal).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_ref.attention_full(jq, jk, jv, causal=causal)),
                               **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_flash(
        jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)), **TOL)


@pytest.mark.parametrize("window", [16, 64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_window_matches_reference_and_pallas(jref, window, causal):
    _, jnp, jax_ref, pallas_flash = jref
    q, k, v = _qkv(7, 1, 256, 4, 2, 32)
    got = ref.attention_full(*_t(q, k, v), causal=causal, window=window).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_ref.attention_full(
        jq, jk, jv, causal=causal, window=window)), **TOL)
    np.testing.assert_allclose(got, np.asarray(pallas_flash(
        jq, jk, jv, causal=causal, window=window, block_q=64, block_k=64,
        interpret=True)), **TOL)


def test_plain_bf16_matches_reference(jref):
    _, jnp, jax_ref, _ = jref
    q, k, v = _qkv(3, 2, 128, 4, 4, 32)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    # both sides start from the same bf16 values
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (jq, jk, jv))
    got = ref.attention_full(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jax_ref.attention_full(jq, jk, jv), np.float32),
                               **BF16_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48), (False, None)])
def test_lse_matches_reference_scores(jref, causal, window):
    """The plain version's second output: logsumexp over the masked fp32
    scores, laid out [B, H, S]."""
    jax, jnp, jax_ref, _ = jref
    B, S, H, KV, hd = 2, 96, 4, 2, 16
    q, k, v = _qkv(11, B, S, H, KV, hd)
    o, lse = ref.attention_full(*_t(q, k, v), causal=causal, window=window,
                                return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    qg = jnp.asarray(q).reshape(B, S, KV, H // KV, hd) * hd ** -0.5
    s = jnp.einsum("bskgh,bckh->bskgc", qg, jnp.asarray(k))
    valid = jax_ref._mask(jnp.arange(S), jnp.arange(S), causal, window)
    s = jnp.where(valid[None, :, None, None, :], s, -1e30)
    want = jnp.moveaxis(jax.nn.logsumexp(s, axis=-1).reshape(B, S, H), 1, 2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax_ref.attention_full(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, window=window)), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 48)])
def test_chunked_matches_reference(jref, causal, window):
    _, jnp, jax_ref, _ = jref
    q, k, v = _qkv(5, 2, 256, 4, 2, 32)
    got = ref.attention_chunked(*_t(q, k, v), causal=causal, window=window, chunk=64)
    want = jax_ref.attention_chunked(*(jnp.asarray(x) for x in (q, k, v)),
                                     causal=causal, window=window, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_takes_chunked_beyond_8192_kv_positions(jref, monkeypatch):
    """On the CPU, KV longer than 8,192 positions goes to the chunked online
    softmax, as the reference's ops.attention does (ops.py:73-75)."""
    _, jnp, jax_ref, _ = jref
    q, k, v = _qkv(13, 1, 32, 2, 1, 16, Skv=8704)     # 17 chunks of 512
    want = jax_ref.attention_chunked(*(jnp.asarray(x) for x in (q, k, v)), causal=False)

    def boom(*a, **kw):
        raise AssertionError("materialised scores beyond 8192 KV positions")

    monkeypatch.setattr(ref, "attention_full", boom)
    got = ops.attention(*_t(q, k, v), causal=False, impl="auto")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,window", [
    (2, 64, 4, 2, 16, True, None),     # GQA, causal
    (1, 96, 4, 1, 32, True, 24),       # MQA, sliding window
    (2, 48, 2, 2, 16, False, None),    # full, non-causal
])
def test_attention_bwd_matches_jax_vjp(jref, B, S, H, KV, hd, causal, window):
    jax, jnp, jax_ref, _ = jref
    q, k, v = _qkv(17 + S, B, S, H, KV, hd)
    do = np.random.default_rng(S).standard_normal((B, S, H, hd)).astype(np.float32)
    o, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_full(a, b, c, causal=causal,
                                                            window=window),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, k, v)
    to, lse = ref.attention_full(tq, tk, tv, causal=causal, window=window, return_lse=True)
    got = fa.attention_bwd(tq, tk, tv, to, lse, torch.from_numpy(do), causal, window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL, err_msg=name)


def test_autograd_function_matches_autograd_through_plain():
    """``FlashAttention`` on CPU tensors (plain forward, ``attention_bwd``
    backward) gives torch autograd's gradients through ``attention_full``."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(19, 2, 80, 6, 2, 16))
    do = torch.randn((2, 80, 6, 16), generator=torch.Generator().manual_seed(0))
    o = fa.flash_attention(q, k, v, causal=True, window=40)
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(ref.attention_full(q, k, v, causal=True, window=40),
                               (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


@pytest.mark.parametrize("kernel,Skv,want", [
    (True, 64, "kernel"), (True, 9216, "kernel"),      # the card: K4 at any length
    (False, 64, "full"), (False, 8192, "full"), (False, 8704, "chunked"),
])
def test_attention_routes_by_dispatch_and_length(monkeypatch, kernel, Skv, want):
    """``ops.attention`` sends what ``dispatch`` gives the kernel to K4
    (with the window normalised), and the rest to the materialised plain
    version up to 8,192 KV positions, to the chunked one beyond."""
    seen = []
    monkeypatch.setattr(ops, "dispatch", lambda impl, device: kernel)
    monkeypatch.setattr(ops._fa_mod, "flash_attention",
                        lambda *a, **kw: seen.append(("kernel", kw["window"])))
    monkeypatch.setattr(ref, "attention_full",
                        lambda *a, **kw: seen.append(("full", kw["window"])))
    monkeypatch.setattr(ref, "attention_chunked",
                        lambda *a, **kw: seen.append(("chunked", kw["window"])))
    q = torch.zeros((1, 4, 2, 16))
    k = torch.zeros((1, Skv, 2, 16))
    ops.attention(q, k, k, window=-1)
    ops.attention(q, k, k, window=32)
    assert seen == [(want, None), (want, 32)]


def test_attention_on_cpu_never_builds_and_rejects_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("CPU attention reached the CUDA build")

    monkeypatch.setattr(_build, "build", boom)
    monkeypatch.setattr(_build, "load", boom)
    q, k, v = _t(*_qkv(23, 1, 40, 4, 2, 16))
    n0 = fa.launches
    want = ref.attention_full(q, k, v, causal=True)
    for impl in ("auto", "ref"):
        torch.testing.assert_close(ops.attention(q, k, v, impl=impl), want, rtol=0, atol=0)
    # -1 means full attention, as in the reference
    torch.testing.assert_close(ops.attention(q, k, v, window=-1), want, rtol=0, atol=0)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)      # the wrapper itself
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    assert fa.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(q, k, v, impl="pallas")


def test_wrapper_checks_its_inputs():
    q, k, v = _t(*_qkv(29, 1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match=r"q \[B,S,H,hd\]"):
        fa.flash_attention_fwd(q[0], k, v)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_fwd(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_fwd(q[:, :, :3], k, v)          # H % KV != 0
    with pytest.raises(ValueError, match="float32 or all"):
        fa.flash_attention_fwd(q, k.double(), v.double())


@pytest.mark.parametrize("B,S,H,KV,Skv,hd,kernel,grid,smem", [
    # stablelm training: one K/V tile per head, two heads per block
    (128, 64, 32, 32, 64, 64, "flash_fwd_tf32x3", (1, 16, 128), 197_744),
    (4, 2048, 32, 32, 2048, 64, "flash_fwd_tf32x3", (16, 32, 4), 197_744),  # stablelm prefill
    (1, 2048, 40, 8, 2048, 128, "flash_fwd_tf32x3", (16, 40, 1), 230_512),  # qwen GQA
    (4, 2048, 32, 2, 2048, 128, "flash_fwd_tf32x3", (16, 32, 4), 230_512),  # chatglm prefill
    (2, 1024, 48, 8, 1024, 128, "flash_fwd_tf32x3", (8, 48, 2), 230_512),   # dbrx prefill
    (128, 64, 4, 2, 64, 128, "flash_fwd_tf32x3", (1, 2, 128), 230_512),    # dbrx smoke, packed
    (2, 64, 4, 4, 65, 128, "flash_fwd_tf32x3", (1, 4, 2), 230_512),        # Skv > 64: unpacked
    (1, 1000, 8, 8, 1000, 64, "flash_fwd_tf32x3", (8, 8, 1), 197_744),    # ragged S
    (2, 64, 5, 5, 64, 64, "flash_fwd_tf32x3", (1, 3, 2), 197_744),        # odd H, packed
    (2, 64, 4, 4, 65, 64, "flash_fwd_tf32x3", (1, 4, 2), 197_744),        # Skv > 64: unpacked
    (2, 200, 8, 2, 200, 32, "flash_fwd", (4, 8, 2), 42_752),              # smoke widths
])
def test_launch_geometry(B, S, H, KV, Skv, hd, kernel, grid, smem):
    geo = fa.launch_geometry(B, S, H, KV, Skv, hd)
    assert geo["kernel"] == kernel
    assert geo["grid"] == grid and geo["smem_bytes"] == smem
    assert geo["threads"] == (256 if kernel == "flash_fwd" else 384) and geo["G"] == H // KV
    assert geo["smem_bytes"] <= 232_448        # a block's shared memory on Hopper


@pytest.mark.parametrize("hd,dtype,aligned,kernel", [
    (64, torch.bfloat16, True, "flash_fwd_wgmma"),     # stablelm
    (128, torch.bfloat16, True, "flash_fwd_wgmma"),    # qwen, phi3, chatglm, dbrx, arctic
    (16, torch.bfloat16, True, "flash_fwd"),           # the smoke configs' widths
    (32, torch.bfloat16, True, "flash_fwd"),
    (64, torch.bfloat16, False, "flash_fwd"),          # a base TMA cannot read
    (64, torch.float32, True, "flash_fwd_tf32x3"),     # stablelm, the fp32 paths
    (128, torch.float32, True, "flash_fwd_tf32x3"),    # qwen, phi3, chatglm, dbrx
    (128, torch.float32, False, "flash_fwd"),
    (16, torch.float32, True, "flash_fwd"),
    (32, torch.float32, True, "flash_fwd"),
    (64, torch.float32, False, "flash_fwd"),
])
def test_launch_geometry_picks_the_variant(hd, dtype, aligned, kernel):
    geo = fa.launch_geometry(4, 2048, 32, 8, 2048, hd, dtype, aligned)
    assert geo["kernel"] == kernel and geo["G"] == 4
    assert geo["smem_bytes"] <= 232_448
    if kernel == "flash_fwd_wgmma":
        assert (geo["bq"], geo["bk"], geo["threads"]) == (128, 128, 384)
        assert geo["grid"] == (16, 32, 4) and geo["stages"] == fa.WG_STAGES[hd]
    elif kernel == "flash_fwd_tf32x3":
        # 16 KB fp32 K/V tiles: 64 keys at head_dim 64, 32 at 128
        assert (geo["bq"], geo["bk"], geo["threads"]) == (128, 4096 // hd, 384)
        assert geo["grid"] == (16, 32, 4) and geo["stages"] == fa.TF_STAGES
        assert not geo["packed"]
    else:
        assert geo == fa.launch_geometry(4, 2048, 32, 8, 2048, hd, aligned=False)
        assert geo["grid"] == (32, 32, 4) and geo["threads"] == 256


def test_kernel_constants_are_the_wrappers_geometry():
    """The tile, thread and stage constants of ``csrc/flash_attention.cu``
    are the ones ``launch_geometry`` computes grids and shared memory from
    (read from the source: there is no compiler here)."""
    import re
    src = (_build.CSRC / "flash_attention.cu").read_text()
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kBQ"], const["kBK"], const["kThreads"]) == (fa.BLOCK_Q, fa.BLOCK_K, fa.THREADS)
    assert (const["kWgBQ"], const["kWgBK"], const["kWgThreads"]) == (
        fa.WG_BLOCK_Q, fa.WG_BLOCK_K, fa.WG_THREADS)
    assert (const["kTfBQ"], const["kTfThreads"], const["kTfStages"], const["kTfPack"]) == (
        fa.TF_BLOCK_Q, fa.TF_THREADS, fa.TF_STAGES, fa.TF_PACK)
    assert {64: const["kTfBK64"], 128: const["kTfBK128"]} == fa.TF_BLOCK_K
    assert tuple(fa.TF_BLOCK_K) == fa.TF_HEAD_DIMS
    # the C entry point takes exactly these head_dims for variant 2
    assert re.search(r"flash_attention_tf32x3_smem_bytes\(int hd\) \{\s*switch \(hd\) \{\s*"
                     r"case 64: return tf_smem_bytes<64>\(\);\s*"
                     r"case 128: return tf_smem_bytes<128>\(\);", src)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("S,Skv", [(64, 64), (2048, 2048), (48, 40)])
def test_every_variant_fits_a_blocks_shared_memory(hd, dtype, aligned, S, Skv):
    """Each variant's shared memory, packed or not, fits the 232,448 bytes a
    Hopper block may use."""
    geo = fa.launch_geometry(2, S, 8, 2, Skv, hd, dtype, aligned)
    assert 0 < geo["smem_bytes"] <= 232_448
    if geo["kernel"] == "flash_fwd_tf32x3":
        assert geo["packed"] == (S <= fa.TF_PACK and Skv <= fa.TF_PACK)


# ---------------------------------------------------------------------------
# flash_fwd_tf32x3's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------
def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 → tf32 (10 stored mantissa bits), round to nearest with ties
    away from zero, by bit ops: ``cvt.rna.tf32.f32``.  Adding half a tf32 ulp
    to the magnitude bits and clearing the low 13 rounds |x| half away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """a @ b as the kernel's tensor cores compute it: a_small·b_big +
    a_big·b_small + a_big·b_big, each product of two tf32 values exact, the
    sums in ``dtype`` (fp32 as on the card; fp64 isolates the dropped
    terms from the accumulation's rounding)."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    ab, as_, bb, bs = (t.to(dtype) for t in (ab, as_, bb, bs))
    return as_ @ bb + ab @ bs + ab @ bb


def attention_3xtf32(q, k, v, causal, window):
    """Attention as flash_fwd_tf32x3 computes it, tile by tile
    (``fa.TF_BLOCK_K`` keys: 64 at head_dim 64, 32 at 128): q·scale split
    once, each tile's scores by split TF32 in log2 units, masked with the
    −1e30 sentinel, the online softmax's max, rescale and denominator in
    fp32, each tile's P·V into a fresh product (small products first) that
    is added to O before the next tile's rescale, O = (O + P_i·V_i)·corr,
    and o = O / l at the end."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    bk = fa.TF_BLOCK_K[hd]
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    qh = (q * hd ** -0.5).reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4)
    kh, vh = k.permute(0, 2, 1, 3)[:, :, None], v.permute(0, 2, 1, 3)[:, :, None]
    valid = ref._mask(torch.arange(S), torch.arange(Skv), causal, window)
    m = torch.full(qh.shape[:-1] + (1,), ref.NEG_INF)
    l = torch.zeros_like(m)
    o = torch.zeros(qh.shape)
    pv = None
    for k0 in range(0, Skv, bk):
        s = mm_3xtf32(qh, kh[..., k0:k0 + bk, :].transpose(-1, -2)) * log2e
        s = torch.where(valid[:, k0:k0 + bk], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        if pv is not None:
            o = (o + pv) * corr
        pv = mm_3xtf32(p, vh[..., k0:k0 + bk, :])
    o = (o + pv) / l.clamp_min(1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                                    # tf32's ulp at 1 is 2^-10
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      one + 2.0 ** -11, 3.0, -0.0, 1e-30])
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, 3.0, -0.0, 0.0])
    got = tf32_rna(x)
    assert torch.equal(got[:6], want[:6])
    assert (tf32_rna(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()
    # a tiny value keeps its exponent: tf32 has fp32's range
    assert abs(float(got[6]) - 1e-30) <= 2.0 ** -11 * 1e-30


def test_3xtf32_dropped_term_is_the_error_model():
    """x = big + small + e with |small| ≤ 2^-11·|x| and |e| ≤ 2^-22·|x|, so
    the three products drop big·e_y + e_x·big + small·small (+ smaller):
    at most 3·2^-22 (+2^-32) of Σ|x·y| in a dot product.  Plain TF32 (one
    product) drops ~2^-11 — far outside fp32's tolerance."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32) * 3)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    dropped = (mm_3xtf32(a, b, torch.float64) - exact).abs() / scale
    assert float(dropped.max()) <= 3 * 2.0 ** -22 + 2.0 ** -32
    assert float(dropped.mean()) >= 2.0 ** -28                # the term is there
    one_product = (tf32_rna(a).double() @ tf32_rna(b).double() - exact).abs() / scale
    assert float(one_product.max()) >= 2.0 ** -14
    # in fp32 the sums' rounding joins it: still well inside (2e-5, 2e-5)
    torch.testing.assert_close(mm_3xtf32(a, b), exact.float(), atol=1e-5, rtol=1e-5)


# the fp32 cases of chip_smoke.py's ATTN_CASES, cut to a few heads
# (B, S, H, KV, Skv, hd, causal, window)
TF32X3_CASES = [
    (4, 64, 2, 2, 64, 64, True, None),         # stablelm training
    (1, 2048, 2, 2, 2048, 64, True, None),     # stablelm prefill
    (1, 2048, 2, 2, 2048, 64, True, 256),      # window 256
    (1, 1024, 4, 1, 1024, 64, True, None),     # MQA
    (1, 512, 2, 2, 2048, 64, False, None),     # non-causal, Skv > S
    (1, 1000, 2, 2, 1000, 64, True, None),     # ragged S
    (1, 2048, 4, 1, 2048, 128, True, None),    # chatglm prefill (G = 4 of its 16)
    (1, 1024, 6, 1, 1024, 128, True, None),    # dbrx prefill
    (1, 2048, 5, 1, 2048, 128, True, 256),     # qwen GQA with window 256
    (8, 64, 4, 2, 64, 128, True, None),        # dbrx smoke training (two tiles a head)
    (1, 512, 2, 2, 2048, 128, False, None),    # non-causal, Skv > S
    (1, 1000, 2, 2, 1000, 128, True, None),    # ragged S
]


@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", TF32X3_CASES)
def test_3xtf32_attention_meets_the_fp32_tolerance(jref, B, S, H, KV, Skv, hd, causal,
                                                   window):
    """Split TF32 attention in the kernel's tiles and order holds
    ``ref.attention_full`` and the reference's ``attention_full`` at fp32's
    own tolerance (atol 2e-5, rtol 2e-5) at the shapes the card checks."""
    _, jnp, jax_ref, _ = jref
    qn, kn, vn = _qkv(S + Skv + H + hd, B, S, H, KV, hd, Skv)
    got = attention_3xtf32(*_t(qn, kn, vn), causal, window)
    torch.testing.assert_close(got, ref.attention_full(*_t(qn, kn, vn), causal=causal,
                                                       window=window), **TOL)
    want = jax_ref.attention_full(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_variant_counters_and_the_cpu_never_counts():
    assert set(fa.variant_launches) == {"flash_fwd", "flash_fwd_wgmma", "flash_fwd_tf32x3"}
    q, k, v = (t.bfloat16() for t in _t(*_qkv(5, 1, 16, 2, 2, 64)))
    fa.launches, fa.variant_launches["flash_fwd_wgmma"] = 3, 1
    fa.flash_attention_fwd(q, k, v)
    assert fa.launches == 3 and fa.variant_launches["flash_fwd_wgmma"] == 1
    fa.zero_launches()
    assert fa.launches == 0 and set(fa.variant_launches.values()) == {0}


def test_build_knows_both_libraries(tmp_path, monkeypatch):
    """K4's source and the CoDA kernels' source build one library whose
    hash-keyed name changes when either source changes."""
    src, attn = tmp_path / "k.cu", tmp_path / "fa.cu"
    src.write_text("// one")
    attn.write_text("// one")
    monkeypatch.setattr(_build, "SOURCE", src)
    monkeypatch.setattr(_build, "ATTN_SOURCE", attn)
    first = _build.library_path()
    attn.write_text("// two")
    second = _build.library_path()
    src.write_text("// two")
    assert len({first, second, _build.library_path()}) == 3
    assert first.name.startswith("libcoda_") and first.suffix == ".so"
    assert {"coda_error_string", "flash_attention_forward", "flash_attention_smem_bytes",
            "flash_attention_tf32x3_smem_bytes"} <= set(_build._SIGNATURES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
CARD_SHAPES = [
    # B, S, H, KV, Skv, hd, causal, window (fp32 at head_dim 64 and 128 runs
    # flash_fwd_tf32x3, packed two heads a block where S, Skv <= 64)
    (3, 64, 4, 4, 64, 64, True, None),
    (2, 200, 8, 2, 200, 32, True, None),       # GQA, ragged
    (1, 1000, 8, 1, 1000, 64, True, 256),      # MQA, window, ragged
    (2, 96, 4, 4, 300, 128, False, None),      # Skv != S
    (2, 130, 2, 2, 130, 16, False, 50),        # window without causal
    (2, 256, 8, 2, 256, 64, True, None),       # GQA, causal
    (1, 200, 4, 4, 333, 64, False, None),      # non-causal, Skv > S, both ragged
    (2, 1000, 4, 4, 1000, 64, True, None),     # ragged S = 1000
    (2, 64, 5, 5, 64, 64, True, None),         # two heads a block, odd H
    (2, 48, 6, 1, 40, 64, False, 16),          # packed MQA, window, S > Skv
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, B, S, H, KV, Skv, hd, causal,
                                      window, dtype):
    q, k, v = (t.to(cuda_device, dtype) for t in _t(*_qkv(S + hd, B, S, H, KV, hd, Skv)))
    kernel = fa.launch_geometry(B, S, H, KV, Skv, hd, dtype)["kernel"]
    n0, v0 = fa.launches, fa.variant_launches[kernel]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    assert fa.launches == n0 + 1 and fa.variant_launches[kernel] == v0 + 1
    assert o.dtype == dtype
    tol = (TOL if dtype == torch.float32 else
           wgmma_tol(v) if kernel == "flash_fwd_wgmma" else BF16_TOL)
    torch.testing.assert_close(o.float(), want.float(), **tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


# flash_fwd_tf32x3 at head_dim 128 (32-key tiles, P·V in two n64 halves):
# B, S, H, KV, Skv, causal, window
TF32_HD128_SHAPES = [
    pytest.param(4, 2048, 32, 2, 2048, True, None, id="chatglm_prefill"),
    pytest.param(1, 2048, 40, 8, 2048, True, None, id="qwen_gqa"),
    pytest.param(2, 1024, 48, 8, 1024, True, None, id="dbrx_prefill"),
    pytest.param(128, 64, 4, 2, 64, True, None, id="dbrx_smoke_packed"),
    pytest.param(2, 64, 5, 5, 64, True, 16, id="packed_odd_h_window"),
    pytest.param(2, 20, 4, 2, 32, False, None, id="packed_one_tile"),
    pytest.param(2, 1000, 8, 8, 1000, True, None, id="ragged_s1000"),
    pytest.param(1, 1000, 8, 1, 1000, True, 256, id="mqa_window_ragged"),
    pytest.param(2, 512, 8, 8, 2048, False, None, id="noncausal_skv2048"),
    pytest.param(1, 200, 4, 4, 333, False, None, id="noncausal_both_ragged"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,Skv,causal,window", TF32_HD128_SHAPES)
def test_tf32x3_hd128_matches_plain_on_card(cuda_device, B, S, H, KV, Skv, causal, window):
    q, k, v = (t.to(cuda_device) for t in _t(*_qkv(S + Skv + H, B, S, H, KV, 128, Skv)))
    geo = fa.launch_geometry(B, S, H, KV, Skv, 128)
    assert geo["kernel"] == "flash_fwd_tf32x3" and geo["bk"] == 32
    n0 = fa.variant_launches["flash_fwd_tf32x3"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    assert fa.variant_launches["flash_fwd_tf32x3"] == n0 + 1
    torch.testing.assert_close(o, want, **TOL)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


# flash_fwd_wgmma's edges: B, S, H, KV, Skv, hd, causal, window
WGMMA_SHAPES = [
    (2, 1000, 4, 4, 1000, 128, True, 256),     # ragged S, window, head_dim 128
    (2, 1000, 8, 1, 1000, 128, True, None),    # MQA, ragged
    (3, 64, 4, 2, 64, 64, True, None),         # one warpgroup's rows only (S < 65)
    (1, 200, 4, 4, 333, 64, False, None),      # Skv != S, both ragged
    (2, 130, 2, 2, 130, 64, False, 50),        # window without causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,Skv,hd,causal,window", WGMMA_SHAPES)
def test_wgmma_variant_matches_plain_on_card(cuda_device, B, S, H, KV, Skv, hd, causal,
                                             window):
    q, k, v = (t.to(cuda_device, torch.bfloat16)
               for t in _t(*_qkv(S + hd + 1, B, S, H, KV, hd, Skv)))
    n0 = fa.variant_launches["flash_fwd_wgmma"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    assert fa.variant_launches["flash_fwd_wgmma"] == n0 + 1
    torch.testing.assert_close(o.float(), want.float(), **wgmma_tol(v))
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_launch_geometry_matches_the_kernel_on_card(cuda_device, hd):
    """The shared memory ``launch_geometry`` reports is what the built
    kernel asks for."""
    lib = _build.load()
    geo = fa.launch_geometry(1, 64, 1, 1, 64, hd, aligned=False)
    assert lib.flash_attention_smem_bytes(hd) == geo["smem_bytes"]
    if hd in fa.WG_HEAD_DIMS:
        geo = fa.launch_geometry(1, 64, 1, 1, 64, hd, torch.bfloat16)
        assert lib.flash_attention_wgmma_smem_bytes(hd) == geo["smem_bytes"]
    if hd in fa.TF_HEAD_DIMS:
        geo = fa.launch_geometry(1, 64, 1, 1, 64, hd, torch.float32)
        assert lib.flash_attention_tf32x3_smem_bytes(hd) == geo["smem_bytes"]
    else:
        assert lib.flash_attention_tf32x3_smem_bytes(hd) == -1


@pytest.mark.cuda
def test_kernel_backward_matches_autograd_on_card(cuda_device):
    q, k, v = (t.to(cuda_device).requires_grad_() for t in _t(*_qkv(31, 4, 64, 8, 2, 64)))
    do = torch.randn_like(q)
    got = torch.autograd.grad(ops.attention(q, k, v, causal=True), (q, k, v), do)
    want = torch.autograd.grad(ref.attention_full(q, k, v, causal=True), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)
