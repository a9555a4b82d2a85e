"""bf16 parameters through the port's serving vs ``repro``:
``prefill_step`` and the continuous-batching engine, under the bf16 rule
and the engine-token rule of tests/test_torch_bf16.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16 import (FACTOR, ROUTE_MARGIN, ULP, _cfgs, _engine_run, _f32, _inputs, _jx, _np,
                         _route_margin, _rule, _settled, _stacked, _widen)
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from repro.models import model as JM
from repro.serving import loadgen as JLG
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import params as P
from repro_torch.models import model as M
from repro_torch.serving import loadgen as LG
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("arch,use_window", [("stablelm-1.6b", False), ("qwen2.5-14b", True),
                                             ("chatglm3-6b", False), ("dbrx-132b", False)])
def test_prefill_step_matches_reference_in_bf16(arch, use_window):
    """Scores, last-position logits and the bf16 caches of ``prefill_step``
    on bf16 weights (the logits are the bf16 LM head's)."""
    jcfg, cfg = (dataclasses.replace(c, window=5) for c in _cfgs(arch))
    tree = _stacked(jcfg, 3)
    tok = _inputs(cfg, 3)["tokens"]
    run = lambda t: _np(jax.vmap(lambda p, x: JM.prefill_step(
        jcfg, p, {"tokens": x}, use_window=use_window))(_jx(t), jnp.asarray(tok)))
    (s16, l16, kv16), (s32, l32, kv32) = run(tree), run(_widen(tree))
    s, logits, (kc, vc) = M.prefill_step(cfg, P.from_jax_params(cfg, tree),
                                         {"tokens": torch.from_numpy(tok)},
                                         use_window=use_window)
    assert s.dtype == torch.float32 and logits.dtype == torch.bfloat16
    assert kc.dtype == vc.dtype == torch.bfloat16 and l16.dtype == jnp.bfloat16
    ok = _settled(jcfg, tree, tok)
    seq = lambda c: np.swapaxes(_f32(c), 1, 2)[ok]          # [K, L, B, ...] by sequence
    _rule(_f32(s)[ok], s16[ok], s32[ok], "scores")
    _rule(_f32(logits)[ok], l16[ok], l32[ok], "logits")
    _rule(seq(kc), seq(kv16[0]), seq(kv32[0]), "k cache")
    _rule(seq(vc), seq(kv16[1]), seq(kv32[1]), "v cache")


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_engine_serves_bf16_weights_as_the_reference_engine(arch):
    """The same trace through the reference engine on bf16 weights (and on
    their fp32 twin) and through the port's: every request done, the tokens
    equal up to a near tie of the reference, the score-head logits under
    the rule, and the engine's caches still fp32."""
    jcfg, cfg = _cfgs(arch)
    jp = jax.jit(lambda k: JM.init_params(k, jcfg, dtype=jnp.bfloat16))(jax.random.PRNGKey(7))
    jp32 = _widen(_np(jp))
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    tcfg = dict(kind="batch", n_requests=6, prompt_len=(4, 20), max_new=(3, 7), seed=7)
    kw = dict(slots=3, max_len=32, prefill_chunk=4)
    jreqs = _engine_run(JEngine(jcfg, jp, **kw), JLG, tcfg, cfg.vocab_size)
    jreqs32 = _engine_run(JEngine(jcfg, _jx(jp32), **kw), JLG, tcfg, cfg.vocab_size)
    eng = ServingEngine(cfg, p, **kw)
    reqs = _engine_run(eng, LG, tcfg, cfg.vocab_size)
    assert eng.tokens_prefilled == sum(len(r.prompt_used) for r in reqs)
    assert all(r.status == j.status == "done" for r, j in zip(reqs, jreqs, strict=True))
    # the requests whose prompt (which the score logit reads) routes clear of
    # a tie in the reference: the prompts right-padded into one batch (no
    # position sees the padding after it, and routing is per token)
    ok = [True] * len(jreqs)
    if cfg.family == "moe":
        L = max(len(j.prompt_used) for j in jreqs)
        tok = np.zeros((len(jreqs), L), np.int32)
        for i, j in enumerate(jreqs):
            tok[i, :len(j.prompt_used)] = j.prompt_used
        gap = np.asarray(_route_margin(jcfg, jp, jnp.asarray(tok)))
        ok = [float(gap[i, :len(j.prompt_used)].min()) >= ROUTE_MARGIN
              for i, j in enumerate(jreqs)]
    assert any(ok)
    pick = lambda rs: [r.score for r, o in zip(rs, ok) if o]
    _rule(pick(reqs), pick(jreqs), pick(jreqs32), "score logits")
    # the engine's caches stay fp32 whatever the weights, as the reference's
    floats = [t.dtype for t in tree_leaves(eng.cache) if t.is_floating_point()]
    want = [x.dtype for x in jax.tree_util.tree_leaves(JEngine(jcfg, jp, **kw).cache)
            if jnp.issubdtype(x.dtype, jnp.floating)]
    assert floats and set(floats) == {torch.float32} and {str(d) for d in want} == {"float32"}

    def last_logits(params, seq):
        tok = jnp.asarray(np.asarray(seq, np.int32)[None])
        return np.asarray(JM.prefill_step(jcfg, params, {"tokens": tok})[1][0], np.float32)

    for r, j, o in zip(reqs, jreqs, ok):
        if r.generated == j.generated or not o:
            continue
        i = next(n for n, (a, b) in enumerate(zip(r.generated, j.generated)) if a != b)
        seq = list(j.prompt_used) + j.generated[:i]
        l16, l32 = last_logits(jp, seq), last_logits(_jx(jp32), seq)
        top = np.sort(l16)[-2:]
        lim = FACTOR * float(np.abs(l16 - l32).max()) + ULP * float(np.abs(l32).max())
        assert top[1] - top[0] <= lim, (r.uid, i, top[1] - top[0], lim)
        assert r.generated[:i] == j.generated[:i]
