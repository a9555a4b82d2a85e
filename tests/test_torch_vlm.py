"""The port's vlm family (internvl2-2b: projected patch embeddings in front
of the tokens, then a dense stack) vs ``repro`` on the smoke config: the
patch projection (fp32 patches against bf16 weights included), attention
at the training shape's ragged length through K4's plain version,
``score``, ``prefill_step``, ``lm_logits``, ``count_params``, params and
state round trips, a local step, ``fit`` on replayed windows, bf16 as the
reference runs it, the launcher's stubs and its accounting against the
reference launcher's, the serving
caches and ``serve_step``, and one engine run (a vlm is served from tokens,
as the reference serves it); and ``count_params`` against the
reference's for every ported architecture.

Tolerances: those of tests/_torch_zoo.py; attention's plain version
against the reference's at atol = rtol = 1e-5.  About 35 s in one process
on an idle host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (K, cfgs, check_arch_smoke_forward_and_coda_step,
                        check_bf16_as_the_reference, check_cache_shapes, check_configs,
                        check_count_params, check_depth_cut, check_engine_equals_reference,
                        check_fit_replayed, check_launcher_accounting, check_local_step,
                        check_round_trip, check_score_prefill, check_serve_step_one_token,
                        close, inputs, model_pair, tt, vmapped)
from repro.configs import ALL_ARCHS as JALL_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import mlp_config as jax_mlp_config
from repro.kernels import ref as jax_kref
from repro.launch.train import make_batch_adapters as jax_adapters
from repro.models import embeddings as JE
from repro.models import model as JM
from repro_torch.configs import get_config, get_smoke_config, mlp_config
from repro_torch.kernels import ops as kops
from repro_torch.launch import train
from repro_torch.models import model as M

ARCH = "internvl2-2b"



def test_configs_are_the_references():
    check_configs(ARCH)


def test_patches_go_in_front_of_the_tokens():
    """``_embed_inputs``: the projected patches, then the token embeddings,
    as the reference's ``backbone`` builds the stack's input."""
    jcfg, cfg, tree, p = model_pair(ARCH, 1)
    b = inputs(cfg, (K, 3), 1, S=20)

    def ref_x(p_, b_):
        patches = b_["patches"] @ p_["projector"]
        tok = JE.embed(p_["embed"], b_["tokens"])
        return jnp.concatenate([patches.astype(tok.dtype), tok], axis=1)

    want = vmapped(ref_x, tree, b)
    got = M._embed_inputs(cfg, p, tt(b))
    assert tuple(got.shape) == (K, 3, 20, cfg.d_model)
    close(got, want)


def test_fp32_patches_project_in_fp32_against_bf16_weights():
    """jnp promotes fp32 patches @ a bf16 projector to fp32 (torch's matmul
    would refuse the pair); the port computes the same, then joins the
    tokens' dtype."""
    from repro_torch.models.mlp import linear
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 3, 8, 16), generator=g)
    w = torch.randn((2, 16, 16), generator=g).to(torch.bfloat16)
    want = jax.vmap(lambda a, b: a @ b)(jnp.asarray(x.numpy()),
                                        jnp.asarray(w.float().numpy()).astype(jnp.bfloat16))
    assert want.dtype == jnp.float32
    got = linear(x, w)
    assert got.dtype == torch.float32
    close(got, want, atol=1e-6, rtol=1e-6)


def test_attention_at_the_training_length_matches_reference():
    """internvl's training sequence is 257 positions (256 patches + 1
    token), a ragged last query tile for K4; its GQA 16/8 at head_dim 128.
    The port's attention (K4's plain version on the CPU) against the
    reference's plain attention, causal, on [2, 257, 16/8, 128]."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 257, 16, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, 257, 8, 128)).astype(np.float32) for _ in range(2))
    want = jax_kref.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = kops.attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    close(got, want)


def test_score_prefill_and_lm_logits_match_reference():
    check_score_prefill(ARCH, 4, S=24)


def test_params_round_trip():
    for dtype in (jnp.float32, jnp.bfloat16):
        check_round_trip(ARCH, dtype)


def test_count_params():
    check_count_params(ARCH, 1_893_343_233, 738_049)


@pytest.mark.parametrize("arch", JALL_ARCHS)
def test_count_params_every_ported_arch(arch):
    """``count_params`` (from the meta device's shapes) equals the
    reference's (``jax.eval_shape``) for every ported architecture, at full
    width and smoke size, and with ``active_only`` for the moe family."""
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert M.count_params(ours) == JM.count_params(theirs)
        if ours.moe is not None:
            assert M.count_params(ours, active_only=True) == \
                JM.count_params(theirs, active_only=True)
    assert M.count_params(mlp_config()) == JM.count_params(jax_mlp_config())


def test_local_step_matches_reference():
    check_local_step(ARCH, 5)


def test_fit_matches_reference_on_replayed_windows():
    check_fit_replayed(ARCH, 6)


def test_bf16_as_the_reference_runs_it():
    """bf16 weights with fp32 patches: the reference projects in fp32 and
    casts to the tokens' bf16; so does the port."""
    check_bf16_as_the_reference(ARCH, 7)


def test_batch_adapter_layout_is_the_references():
    """The launcher's stub: ``n_patches`` patches of width d in front of the
    first ``seq_len - n_patches`` tokens (at least one), with the
    reference's leading axes; one stub for every example and batch."""
    jcfg, cfg = cfgs(ARCH)
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 3, 64)).astype(np.int32)
    want = jax_adapters(jcfg, None, jax.random.PRNGKey(0))({"tokens": jnp.asarray(tok)})
    got = train.make_batch_adapters(cfg, 0, "cpu")({"tokens": torch.from_numpy(tok)})
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert got["patches"].dtype == torch.float32
    assert torch.equal(got["patches"][0, 0], got["patches"][1, 2])
    big = train.make_batch_adapters(cfg, 0, "cpu")({"tokens": torch.zeros((2, 300),
                                                                           dtype=torch.int64)})
    assert tuple(big["tokens"].shape) == (2, 300 - cfg.n_patches)
    # internvl2-2b's own 256 patches on the launcher's 64 tokens: 257 positions
    full = train.make_batch_adapters(cfgs(ARCH, n_patches=256)[1], 0, "cpu")(
        {"tokens": torch.zeros((2, 64), dtype=torch.int64)})
    assert tuple(full["tokens"].shape) == (2, 1)
    assert tuple(full["patches"].shape) == (2, 256, cfg.d_model)


def test_forward_and_coda_step():
    """tests/test_arch_smoke.py::test_forward_and_coda_step[internvl2-2b]."""
    check_arch_smoke_forward_and_coda_step(ARCH)


def test_serve_step_one_token():
    """tests/test_arch_smoke.py::test_serve_step_one_token[internvl2-2b]."""
    check_serve_step_one_token(ARCH)


def test_init_cache_shapes_match_cache_specs():
    check_cache_shapes(ARCH)


def test_engine_tokens_equal_the_reference_engines():
    check_engine_equals_reference(
        ARCH, 9, dict(slots=3, max_len=32, prefill_chunk=4),
        dict(n_requests=5, prompt_len=(4, 20), max_new=(3, 7)))


def test_launcher_schedule_and_bytes_per_round(capsys):
    out = check_launcher_accounting(ARCH, capsys)
    assert f"bytes/round/worker={(738_049 + 3) * 4:,} " in out
    assert "model: internvl2-2b params/worker=738,049 leaves=15 device=cpu" in out


def test_launcher_cuts_the_depth(capsys):
    check_depth_cut(ARCH, capsys)
