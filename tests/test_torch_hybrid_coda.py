"""The port's hybrid family (hymba-1.5b) vs ``repro`` on the smoke config,
through CoDA and serving: a local step (sgd and sm3's axis rules on the SSM
leaves), ``fit`` on replayed windows, the arch-smoke forward and CoDA step,
the serving caches, ``serve_step``, ``masked_chunk_step``, decode against
the parallel forward, one engine run and the launcher's accounting against
the reference launcher's.  The layers and the model are in
tests/test_torch_hybrid.py (the two halves run on their own workers under
``--dist loadfile``).

Tolerances: those of tests/_torch_zoo.py; decode against the parallel
forward at the reference's own atol = rtol = 2e-3
(tests/test_decode_consistency.py).  About 15 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (DECODE_TOL, cfgs, check_arch_smoke_forward_and_coda_step,
                        check_cache_shapes, check_depth_cut, check_engine_equals_reference,
                        check_fit_replayed, check_launcher_accounting, check_local_step,
                        check_serve_step_one_token, check_sm3_axis_rules, close)
from repro.models import model as JM
from repro.serving import decode as JD
from repro_torch import params as P
from repro_torch.models import model as M
from repro_torch.serving import decode as D
from repro_torch.tree import tree_leaves

ARCH = "hymba-1.5b"


def test_local_step_matches_reference():
    check_local_step(ARCH, 9)


def test_sm3_axis_rules_take_the_ssm_leaves():
    check_sm3_axis_rules(ARCH)


def test_fit_matches_reference_on_replayed_windows():
    check_fit_replayed(ARCH, 10)


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

