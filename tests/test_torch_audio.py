"""The port's audio family (seamless-m4t-medium: a non-causal encoder over
frame embeddings, then a causal decoder whose layers cross-attend to it) vs
``repro`` on the smoke config: cross attention (``attend`` with ``x_kv``,
S ≠ Skv, no RoPE, non-causal) through K4's plain version, with bf16 q
against fp32 k/v as the reference's bf16 audio meets them; the xdecoder
stack; ``cross_decode``; ``encode_for_decode``; the caches against the
reference's ``cache_specs``; ``score``, ``prefill_step``, ``lm_logits``,
``count_params``, params and state round trips, a local step, ``fit`` on
replayed windows, bf16 as the reference runs it, the launcher's stubs and
its accounting against the reference launcher's; decode against the parallel forward; and the engine
refusing the encoder-decoder, as the reference's does.

Tolerances: those of tests/_torch_zoo.py.  About 50 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (DECODE_TOL, K, cfgs,
                        check_arch_smoke_forward_and_coda_step, check_bf16_as_the_reference,
                        check_cache_shapes, check_configs, check_depth_cut,
                        check_launcher_accounting, check_count_params,
                        check_fit_replayed, check_local_step, check_round_trip,
                        check_score_prefill, check_serve_step_one_token, close, jx_tree,
                        np_tree, rule, vmapped, widen)
from repro.launch.train import make_batch_adapters as jax_adapters
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.serving import decode as JD
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import params as P
from repro_torch.launch import train
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine
from repro_torch.serving import decode as D

ARCH = "seamless-m4t-medium"



def _attn_pair(seed, dtype=jnp.float32):
    jcfg, cfg = cfgs(ARCH)
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    tree = np_tree(jax.vmap(lambda k: JA.init_attention(k, jcfg, cross=True, dtype=dtype))(keys))
    return jcfg, cfg, tree, P.from_jax_params(cfg, tree)


def _one(arch, seed):
    """One replica's reference params and the port's (K = 1)."""
    jcfg, cfg = cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, P.from_jax_params(cfg, jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jp))


def test_configs_are_the_references():
    check_configs(ARCH)


@pytest.mark.parametrize("Sq,Skv", [(5, 16), (16, 16), (12, 7)])
def test_cross_attend_matches_reference(Sq, Skv):
    """``attend`` with ``x_kv``: S ≠ Skv, no RoPE, every encoder position
    visible — through ``kernels.ops.attention`` (K4 on the card, its plain
    version here)."""
    jcfg, cfg, tree, p = _attn_pair(1)
    rng = np.random.default_rng(Sq)
    x = rng.standard_normal((K, 3, Sq, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((K, 3, Skv, cfg.d_model)).astype(np.float32)
    want = vmapped(lambda p_, b: JA.attend(jcfg, p_, b["x"], jnp.arange(Sq)[None], window=None,
                                           causal=False, x_kv=b["enc"]),
                   tree, {"x": x, "enc": enc})
    got = A.attend(cfg, p, torch.from_numpy(x), torch.arange(Sq), window=None, causal=False,
                   x_kv=torch.from_numpy(enc))
    close(got, want)


def test_bf16_cross_attention_meets_fp32_encoder_output():
    """Under bf16 weights the reference's encoder output stays fp32 (fp32
    frames promote against bf16 weights), so cross attention gets bf16 q and
    fp32 k/v; its plain attention computes in fp32 and returns q's dtype.
    The port promotes the same way, K4 on fp32 inputs."""
    jcfg, cfg, tree, p = _attn_pair(2, dtype=jnp.bfloat16)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((K, 3, 4, cfg.d_model)), jnp.bfloat16)
    enc = rng.standard_normal((K, 3, 16, cfg.d_model)).astype(np.float32)
    fn = lambda p_, b: JA.attend(jcfg, p_, b["x"], jnp.arange(4)[None], window=None,
                                 causal=False, x_kv=b["enc"])
    want = vmapped(fn, tree, {"x": x, "enc": enc})
    want32 = vmapped(fn, widen(tree), {"x": np.asarray(x, np.float32), "enc": enc})
    assert want.dtype == jnp.bfloat16
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = A.attend(cfg, p, xt, torch.arange(4), window=None, causal=False,
                   x_kv=torch.from_numpy(enc))
    assert got.dtype == torch.bfloat16
    rule(got, want, want32, "bf16 cross attention")


def test_xdecoder_stack_matches_reference():
    """The decoder layers: causal self attention, then cross attention over
    ``enc_out``, then the GELU mlp, each behind a layernorm."""
    jcfg, cfg = cfgs(ARCH)
    keys = jax.random.split(jax.random.PRNGKey(3), K)
    tree = np_tree(jax.vmap(lambda k: JB.init_stack(k, jcfg, jcfg.n_layers, "xdecoder"))(keys))
    assert "cross" in tree and "norm_x" in tree
    rng = np.random.default_rng(3)
    x = rng.standard_normal((K, 2, 6, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((K, 2, 20, cfg.d_model)).astype(np.float32)
    wins = jnp.full((jcfg.n_layers,), -1, jnp.int32)
    want, _ = vmapped(lambda p_, b: JB.apply_stack(jcfg, p_, b["x"], jnp.arange(6)[None], wins,
                                                   kind="xdecoder", enc_out=b["enc"]),
                      tree, {"x": x, "enc": enc})
    got, _ = B.apply_stack(cfg, P.from_jax_params(cfg, tree), torch.from_numpy(x),
                           torch.arange(6), [None] * cfg.n_layers, kind="xdecoder",
                           enc_out=torch.from_numpy(enc))
    close(got, want)


def test_score_prefill_and_lm_logits_match_reference():
    check_score_prefill(ARCH, 4, S=32)


def test_params_round_trip():
    for dtype in (jnp.float32, jnp.bfloat16):
        check_round_trip(ARCH, dtype)


def test_count_params():
    check_count_params(ARCH, 878_208_001, 1_199_233)


def test_local_step_matches_reference():
    check_local_step(ARCH, 5)


def test_fit_matches_reference_on_replayed_windows():
    check_fit_replayed(ARCH, 6)


def test_bf16_as_the_reference_runs_it():
    """bf16 weights: the encoder on fp32 activations (the frames promote),
    bf16 q against fp32 k/v in cross attention, a bf16 decoder."""
    check_bf16_as_the_reference(ARCH, 7)


def test_batch_adapter_layout_is_the_references():
    """The launcher's stub: ``seq_len`` frames of width d, and the first
    ``seq_len // decoder_fraction`` tokens kept as the decoder's targets."""
    jcfg, cfg = cfgs(ARCH)
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 3, 64)).astype(np.int32)
    want = jax_adapters(jcfg, None, jax.random.PRNGKey(0))({"tokens": jnp.asarray(tok)})
    got = train.make_batch_adapters(cfg, 0, "cpu")({"tokens": torch.from_numpy(tok)})
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["frames"].dtype == torch.float32
    assert torch.equal(got["frames"][0, 0], got["frames"][1, 2])


def test_cross_decode_matches_reference():
    jcfg, cfg, tree, p = _attn_pair(9)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.standard_normal((3, 11, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    want = JA.cross_decode(jcfg, jx_tree({k: v[0] for k, v in tree.items()}),
                           jnp.asarray(ek), jnp.asarray(ev), jnp.asarray(x))
    p1 = {k: v[:1] for k, v in p.items()}
    got = A.cross_decode(cfg, p1, torch.from_numpy(ek), torch.from_numpy(ev),
                         torch.from_numpy(x)[None])
    assert tuple(got.shape) == (1, 3, 1, cfg.d_model)
    close(got[0], want)


def test_encode_for_decode_matches_reference():
    """Every decoder layer's cross-attention K/V from the encoder's output;
    the self caches carried over untouched."""
    jcfg, cfg, jp, p = _one(ARCH, 10)
    frames = np.random.default_rng(10).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jc = JD.init_cache(jcfg, 2, 24, use_window=False, dtype=jnp.float32)
    jc = jax.jit(lambda c_, f_: JD.encode_for_decode(jcfg, jp, c_, f_))(jc, jnp.asarray(frames))
    c = D.init_cache(cfg, 2, 24, use_window=False, dtype=torch.float32)
    c = D.encode_for_decode(cfg, p, c, torch.from_numpy(frames))
    for lc, jlc in zip(c["layers"], jc["layers"], strict=True):
        for k in ("enc_k", "enc_v"):
            assert tuple(lc[k].shape) == jlc[k].shape == (2, 24, cfg.n_kv_heads, cfg.head_dim)
            close(lc[k], jlc[k])
        assert not lc["attn"]["k"].any() and tuple(lc["attn"]["k"].shape) == \
            jlc["attn"]["k"].shape == (2, 24 // cfg.decoder_fraction, cfg.n_kv_heads,
                                       cfg.head_dim)


def test_encdec_decode_matches_parallel():
    """tests/test_decode_consistency.py::test_encdec_decode_matches_parallel
    on the port (``encode_for_decode``, then the S // 4 target tokens one at a
    time, against the parallel forward: atol = rtol = 2e-3), and the last
    logits against the reference's decode at the fp32 tolerance."""
    jcfg, cfg, jp, p = _one(ARCH, 5)
    key = jax.random.PRNGKey(5)
    Bsz, Se = 2, 16
    Sd = Se // cfg.decoder_fraction
    frames = np.asarray(jax.random.normal(key, (Bsz, Se, cfg.d_model)))
    tokens = np.asarray(jax.random.randint(key, (Bsz, Sd), 0, cfg.vocab_size))
    h, _ = M.backbone(cfg, p, {"frames": torch.from_numpy(frames)[None],
                               "tokens": torch.from_numpy(tokens)[None]})
    want = M.lm_logits(cfg, p, h[:, :, -1])[0]
    cache = D.init_cache(cfg, Bsz, Se, use_window=False, dtype=torch.float32)
    cache = D.encode_for_decode(cfg, p, cache, torch.from_numpy(frames))
    jc = JD.init_cache(jcfg, Bsz, Se, use_window=False, dtype=jnp.float32)
    jc = JD.encode_for_decode(jcfg, jp, jc, jnp.asarray(frames))
    step = jax.jit(lambda c_, t_, p_: JD.serve_step(jcfg, jp, c_, t_, p_))
    for t in range(Sd):
        pos = np.full((Bsz,), t, np.int32)
        logits, _, cache = D.serve_step(cfg, p, cache, torch.from_numpy(tokens[:, t:t + 1]),
                                        torch.from_numpy(pos))
        jl, _, jc = step(jc, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(pos))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **DECODE_TOL)
    close(logits, jl)


def test_forward_and_coda_step():
    """tests/test_arch_smoke.py::test_forward_and_coda_step
    [seamless-m4t-medium]."""
    check_arch_smoke_forward_and_coda_step(ARCH)


def test_serve_step_one_token():
    """tests/test_arch_smoke.py::test_serve_step_one_token
    [seamless-m4t-medium] (an empty cross cache, as there)."""
    check_serve_step_one_token(ARCH)


def test_init_cache_shapes_match_cache_specs():
    check_cache_shapes(ARCH)


def test_engine_refuses_the_encoder_decoder_as_the_reference_does():
    jcfg, cfg, jp, p = _one(ARCH, 11)
    msg = "encoder-decoder configs need encode_for_decode"
    with pytest.raises(NotImplementedError, match=msg):
        JEngine(jcfg, jp)
    with pytest.raises(NotImplementedError, match=msg):
        ServingEngine(cfg, p)


def test_launcher_schedule_and_bytes_per_round(capsys):
    out = check_launcher_accounting(ARCH, capsys)
    assert f"bytes/round/worker={(1_199_233 + 3) * 4:,} " in out
    assert "model: seamless-m4t-medium params/worker=1,199,233 leaves=35 device=cpu" in out


def test_launcher_cuts_the_depth(capsys):
    """--n-layers cuts both stacks."""
    check_depth_cut(ARCH, capsys)
