"""The port's serving path vs ``repro``: the decode half of attention
(caches, ring buffers, the int8 variant), ``serve_step``, ``prefill`` and
``masked_chunk_step`` on stablelm-1.6b, qwen2.5-14b, dbrx-132b and
arctic-480b smoke configs; decode against the parallel forward under both
MoE dispatches; the continuous-batching engine's behaviour (the cases of
tests/test_serving_engine.py, run on the port); one engine run whose tokens
equal the reference engine's; ``make_trace``; the serve launcher.

Weights come across with ``repro_torch.params`` (one replica, K = 1) and
inputs are made with numpy.  Tolerances (fp32, sums in another order):
  * caches, logits, score logits, hidden states: atol 1e-5, rtol 1e-5;
    cache positions and int8 payloads exact, int8 scales rtol 1e-6;
  * decode vs the parallel forward (the port against itself): atol 2e-3,
    rtol 2e-3, the reference's own (tests/test_decode_consistency.py:47);
  * engine tokens: equal (greedy argmax of logits that agree to 1e-5).
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import init_params as jax_init_params
from repro.serving import decode as JD
from repro.serving import loadgen as JLG
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_smoke_config
from repro_torch.metrics import streaming
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serving import decode as D
from repro_torch.serving import loadgen as LG
from repro_torch.serving.engine import Request, ServingEngine, TicksExhausted
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"atol": 1e-5, "rtol": 1e-5}
SERVE_ARCHS = ["stablelm-1.6b", "qwen2.5-14b", "dbrx-132b", "arctic-480b"]

_PAIRS = {}


def _pair(arch, seed=0, **replace):
    """(jax cfg, port cfg, reference params, the port's one-replica params)."""
    key = (arch, seed, tuple(sorted(replace.items())))
    if key not in _PAIRS:
        jcfg, cfg = (dataclasses.replace(c, **replace)
                     for c in (jax_smoke(arch), get_smoke_config(arch)))
        jp = jax.jit(lambda k: jax_init_params(k, jcfg))(jax.random.PRNGKey(seed))
        tree = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp)
        _PAIRS[key] = (jcfg, cfg, jp, P.from_jax_params(cfg, tree))
    return _PAIRS[key]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), **(tol or TOL))


def _caches_close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
        if g.dtype in (torch.int32, torch.int8):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


# --------------------------------------------------------------------------
# attention decode
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ring,dtype", [(False, torch.float32), (True, torch.float32),
                                        (False, torch.bfloat16), (True, torch.int8)])
def test_init_cache_matches_reference(ring, dtype):
    jcfg, cfg = (dataclasses.replace(c, window=5) for c in (jax_smoke("qwen2.5-14b"),
                                                            get_smoke_config("qwen2.5-14b")))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[dtype]
    want = JA.init_cache(jcfg, 3, 9, ring=ring, dtype=jdt)
    got = A.init_cache(cfg, 3, 9, ring=ring, dtype=dtype)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_quantize_kv_matches_reference():
    x = (3 * np.random.default_rng(1).standard_normal((4, 2, 128))).astype(np.float32)
    x[0, 0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]      # halves: round to even
    q, s = A._quantize_kv(torch.from_numpy(x))
    jq, js = JA._quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("ring,dtype,window", [(False, torch.float32, None),
                                               (True, torch.float32, 4),
                                               (False, torch.int8, None),
                                               (True, torch.int8, 4)])
def test_decode_step_matches_reference(ring, dtype, window):
    """Ten decode steps of one layer from an empty cache: ring slots wrap
    and stale rows drop out of the mask; int8 stores quantized K/V."""
    jcfg, cfg = (dataclasses.replace(c, window=4) for c in (jax_smoke("chatglm3-6b"),
                                                            get_smoke_config("chatglm3-6b")))
    jp = jax.jit(lambda k: JA.init_attention(k, jcfg))(jax.random.PRNGKey(2))
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    jdt = jnp.int8 if dtype == torch.int8 else jnp.float32
    jc = JA.init_cache(jcfg, 2, 8, ring=ring, dtype=jdt)
    c = A.init_cache(cfg, 2, 8, ring=ring, dtype=dtype)
    rng = np.random.default_rng(2)
    step = jax.jit(lambda c_, x_, p_: JA.decode_step(jcfg, jp, c_, x_, p_, window=window))
    for t in range(10 if ring else 8):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([t, max(t - 1, 0)], np.int32)
        jo, jc = step(jc, jnp.asarray(x), jnp.asarray(pos))
        o, c = A.decode_step(cfg, p, c, torch.from_numpy(x)[None], torch.from_numpy(pos),
                             window=window)
        _close(o[0], jo)
    for k in jc:
        if k == "pos" or (k in ("k", "v") and dtype == torch.int8):
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]))
        else:
            _close(c[k], jc[k])


# --------------------------------------------------------------------------
# serve_step, prefill, masked_chunk_step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_step_and_prefill_match_reference(arch):
    jcfg, cfg, jp, p = _pair(arch)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc = JD.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    c = D.init_cache(cfg, 2, 16, dtype=torch.float32)
    jc, jlog = jax.jit(lambda c_, t_: JD.prefill(jcfg, jp, c_, t_))(jc, jnp.asarray(tok))
    c, log = D.prefill(cfg, p, c, torch.from_numpy(tok))
    _close(log, jlog)
    _caches_close(c, jc)
    nxt = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
    pos = np.array([9, 9], np.int32)
    jl, js, jc = jax.jit(lambda c_, t_, p_: JD.serve_step(jcfg, jp, c_, t_, p_))(
        jc, jnp.asarray(nxt), jnp.asarray(pos))
    l, s, c = D.serve_step(cfg, p, c, torch.from_numpy(nxt), torch.from_numpy(pos))
    _close(l, jl)
    _close(s, js)
    assert s.dtype == torch.float32 and tuple(l.shape) == (2, cfg.vocab_size)
    _caches_close(c, jc)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_masked_chunk_step_matches_reference(arch):
    """Rows with 3, 0 and 4 live steps of a 4-step chunk: dead steps keep
    the row's cache bitwise, live ones match the reference."""
    jcfg, cfg, jp, p = _pair(arch)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (3, 4)).astype(np.int32)
    pos = np.array([0, 0, 2], np.int32)
    nst = np.array([3, 0, 4], np.int32)
    jc = JD.init_cache(jcfg, 3, 12, dtype=jnp.float32)
    c = D.init_cache(cfg, 3, 12, dtype=torch.float32)
    jc, jt, jsc = jax.jit(lambda c_, *a: JD.masked_chunk_step(jcfg, jp, c_, *a))(
        jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(nst))
    c, t, sc = D.masked_chunk_step(cfg, p, c, torch.from_numpy(tok), torch.from_numpy(pos),
                                   torch.from_numpy(nst))
    _caches_close(c, jc)
    live = np.arange(4)[None, :] < nst[:, None]
    np.testing.assert_array_equal(t.numpy()[live], np.asarray(jt)[live])
    np.testing.assert_allclose(sc.numpy()[live], np.asarray(jsc)[live], **TOL)
    assert t.dtype == torch.int32 and tuple(sc.shape) == (3, 4)
    assert not c["layers"][0]["attn"]["k"][1].any()          # the idle row


def test_serving_refuses_several_replicas():
    cfg = get_smoke_config("stablelm-1.6b")
    p2 = tree_map(lambda x: x[None].expand(2, *x.shape), M.init_params(cfg))
    with pytest.raises(ValueError, match="one replica"):
        D.serve_step(cfg, p2, D.init_cache(cfg, 1, 4), torch.zeros((1, 1), dtype=torch.int64),
                     torch.zeros((1,), dtype=torch.int32))


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
@pytest.mark.parametrize("dispatch", ["sorted", "capacity"])
def test_moe_decode_matches_parallel_both_dispatches(arch, dispatch):
    """Token-by-token decode (T = B tokens per step) reproduces the parallel
    forward's last logits (T = B·S), under both eval dispatches
    (tests/test_decode_consistency.py:54, on the port)."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    p = tree_map(lambda x: x[None], M.init_params(cfg, generator=torch.Generator().manual_seed(5)))
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)))
    _, got = D.prefill(cfg, p, D.init_cache(cfg, 2, 24, dtype=torch.float32), tok)
    h, _ = M.backbone(cfg, p, {"tokens": tok[None]})
    want = M.lm_logits(cfg, p, h[:, :, -1])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3, rtol=2e-3)


# --------------------------------------------------------------------------
# the engine (tests/test_serving_engine.py's cases, on the port)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cfg_params():
    cfg = get_smoke_config("stablelm-1.6b")
    params = tree_map(lambda x: x[None],
                      M.init_params(cfg, generator=torch.Generator().manual_seed(0)))
    return cfg, params


def _engine(cfg_params, **kw):
    cfg, params = cfg_params
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 48)
    return ServingEngine(cfg, params, **kw)


def _serve_alone(cfg_params, prompt, max_new, **kw):
    eng = _engine(cfg_params, slots=1, **kw)
    req = Request(uid=0, prompt=list(prompt), max_new_tokens=max_new)
    eng.add_request(req)
    eng.run()
    return req


def test_empty_prompt_rejected_at_admission(cfg_params):
    eng = _engine(cfg_params)
    req = Request(uid=0, prompt=[], max_new_tokens=4)
    assert eng.add_request(req) is False
    assert req.status == "rejected" and req.reject_reason == "empty_prompt" and req.done
    ok = Request(uid=1, prompt=[5, 6, 7], max_new_tokens=2)
    assert eng.add_request(ok) is True
    eng.run()
    assert ok.status == "done" and len(ok.generated) == 2


def test_non_positive_budget_rejected(cfg_params):
    eng = _engine(cfg_params)
    req = Request(uid=0, prompt=[1, 2], max_new_tokens=0)
    assert eng.add_request(req) is False
    assert req.reject_reason == "non_positive_max_new_tokens"


def test_run_raises_when_ticks_exhausted(cfg_params):
    eng = _engine(cfg_params, prefill_chunk=1)
    eng.add_request(Request(uid=0, prompt=list(range(1, 30)), max_new_tokens=8))
    with pytest.raises(TicksExhausted):
        eng.run(max_ticks=3)


def test_overlong_prompt_truncated_and_exact(cfg_params):
    cfg, _ = cfg_params
    prompt = list(np.random.RandomState(0).randint(1, cfg.vocab_size, size=40))
    req = Request(uid=0, prompt=prompt, max_new_tokens=4)
    eng = _engine(cfg_params, slots=1, max_len=16)
    assert eng.add_request(req) is True
    eng.run()
    assert req.truncated and req.status == "done"
    assert req.prompt_used == prompt[:15]
    assert req.generated == _serve_alone(cfg_params, prompt[:15], 4, max_len=16).generated


def test_overlong_prompt_rejected_under_reject_policy(cfg_params):
    eng = _engine(cfg_params, max_len=16, on_overflow="reject")
    req = Request(uid=0, prompt=list(range(1, 41)), max_new_tokens=4)
    assert eng.add_request(req) is False
    assert req.reject_reason == "prompt_too_long"


def test_reset_slot_resets_host_leaves(cfg_params):
    """A cache restored to the host (numpy leaves) still resets, and comes
    back as tensors."""
    cfg, _ = cfg_params
    eng = _engine(cfg_params, slots=2, max_len=32)
    eng.add_request(Request(uid=0, prompt=list(range(1, 20)), max_new_tokens=4))
    eng.run()
    eng.cache = tree_map(lambda t: t.numpy(), eng.cache)
    eng.cache = eng._reset_slot(0)
    fresh = D.init_cache(cfg, 1, 32, dtype=torch.float32)
    for got, want in zip(tree_leaves(eng.cache), tree_leaves(fresh), strict=True):
        assert isinstance(got, torch.Tensor)
        assert torch.equal(got[0:1], want)


def test_reset_slot_raises_on_slotless_leaf(cfg_params):
    eng = _engine(cfg_params, slots=2)
    eng.cache["layers"][0]["attn"]["k"] = eng.cache["layers"][0]["attn"]["k"][0]
    with pytest.raises(ValueError, match="slot axis"):
        eng._reset_slot(0)


def test_slot_recycling_is_exact(cfg_params):
    eng = _engine(cfg_params, slots=1, max_len=48)
    long = Request(uid=0, prompt=list(range(1, 41)), max_new_tokens=6)
    short = Request(uid=1, prompt=[7, 11, 13], max_new_tokens=4)
    eng.add_request(long)
    eng.add_request(short)
    eng.run()
    assert long.status == "done" and short.status == "done"
    assert short.generated == _serve_alone(cfg_params, [7, 11, 13], 4).generated


def test_tick_accounting(cfg_params):
    """Prompt of 20 at chunk 8: three prefill ticks of 8 steps, then three
    decode ticks of one step each."""
    eng = _engine(cfg_params, slots=1, max_len=48, prefill_chunk=8)
    req = Request(uid=0, prompt=list(range(1, 21)), max_new_tokens=4)
    eng.add_request(req)
    eng.run()
    assert req.status == "done" and len(req.generated) == 4
    assert eng.ticks == 6 and eng.steps == 3 * 8 + 3
    assert eng.tokens_prefilled == 20 and eng.tokens_decoded == 3


def test_chunked_prefill_matches_token_per_tick(cfg_params):
    prompts = [list(range(1, 25)), [3, 1, 4, 1, 5], list(range(40, 9, -1))]
    outs = {}
    for chunk in (1, 8):
        eng = _engine(cfg_params, slots=2, max_len=48, prefill_chunk=chunk)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.add_request(r)
        eng.run()
        outs[chunk] = [r.generated for r in reqs]
    assert outs[1] == outs[8]


def test_fifo_admission_order_and_queue_bound(cfg_params):
    eng = _engine(cfg_params, slots=1, queue_limit=2, prefill_chunk=4)
    reqs = [Request(uid=i, prompt=[i + 1, i + 2], max_new_tokens=1) for i in range(3)]
    assert eng.add_request(reqs[0]) is True
    assert eng.add_request(reqs[1]) is True
    assert eng.add_request(reqs[2]) is False
    assert reqs[2].reject_reason == "queue_full"
    eng.run()
    assert reqs[0].t_admitted <= reqs[1].t_admitted
    assert [r.status for r in reqs[:2]] == ["done", "done"]


def test_sjf_admits_short_job_first(cfg_params):
    eng = _engine(cfg_params, slots=1, admission="sjf")
    long = Request(uid=0, prompt=list(range(1, 30)), max_new_tokens=1)
    short = Request(uid=1, prompt=[5, 6], max_new_tokens=1)
    eng.add_request(long)
    eng.add_request(short)
    eng.run()
    assert short.t_admitted < long.t_admitted


def test_eos_terminates_decode(cfg_params):
    g0 = _serve_alone(cfg_params, [2, 3, 5, 8], 1).generated[0]
    req = Request(uid=0, prompt=[2, 3, 5, 8], max_new_tokens=8, eos_id=g0)
    eng = _engine(cfg_params, slots=1)
    eng.add_request(req)
    eng.run()
    assert req.generated == [g0] and req.status == "done"


def test_deadline_expires_queued_and_active(cfg_params):
    clk = {"t": 0.0}
    eng = _engine(cfg_params, slots=1, prefill_chunk=2, clock=lambda: clk["t"])
    slow = Request(uid=0, prompt=list(range(1, 30)), max_new_tokens=8, deadline=5.0)
    queued = Request(uid=1, prompt=[4, 5], max_new_tokens=2, deadline=1.0)
    eng.add_request(slow)
    eng.add_request(queued)
    eng.step()
    clk["t"] = 2.0
    eng.step()
    assert queued.status == "expired" and queued.done
    clk["t"] = 6.0
    eng.step()
    assert slow.status == "expired" and eng.n_expired == 2
    assert all(r is None for r in eng.active) and not eng.queue


def test_latency_accounting_fields(cfg_params):
    clk = {"t": 0.0}
    eng = _engine(cfg_params, slots=1, prefill_chunk=8, clock=lambda: clk["t"])
    req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)
    eng.add_request(req)
    clk["t"] = 1.0
    eng.run()
    assert req.t_arrival == 0.0 and req.t_admitted == 1.0
    assert req.ttft == 1.0 and req.latency == 1.0
    assert req.score is not None and np.isfinite(req.score)


def test_prefix_cache_hit_is_exact(cfg_params):
    base = list(range(1, 13))
    ext = base + [17, 19, 23]
    eng = _engine(cfg_params, slots=1, prefix_cache_size=4)
    a = Request(uid=0, prompt=base, max_new_tokens=2)
    eng.add_request(a)
    eng.run()
    b = Request(uid=1, prompt=ext, max_new_tokens=4)
    eng.add_request(b)
    eng.run()
    assert b.prefix_hit_tokens == len(base) and eng.prefix_hits == 1
    assert b.generated == _serve_alone(cfg_params, ext, 4).generated


def test_prefix_cache_miss_on_disjoint_prompt(cfg_params):
    eng = _engine(cfg_params, slots=1, prefix_cache_size=4)
    eng.add_request(Request(uid=0, prompt=list(range(1, 13)), max_new_tokens=1))
    eng.run()
    b = Request(uid=1, prompt=[40, 41, 42, 43], max_new_tokens=1)
    eng.add_request(b)
    eng.run()
    assert b.prefix_hit_tokens == 0 and eng.prefix_misses >= 1


def test_streaming_metric_accumulates_labeled_requests(cfg_params):
    met = streaming.make_metric("auc", "sketch", bins=256)
    eng = _engine(cfg_params, slots=2, metric=met)
    cfg, _ = cfg_params
    tcfg = LG.TraceConfig(kind="batch", n_requests=12, prompt_len=(6, 20), max_new=(1, 3),
                          labeled=True, seed=5)
    reqs, wall = LG.run_trace(eng, LG.make_trace(tcfg, cfg.vocab_size))
    assert eng.n_scored == 12 and all(r.label in (0.0, 1.0) for r in reqs)
    sm = eng.streaming_metrics()
    assert sm["metric"] == "auc" and sm["backend"] == "sketch"
    assert sm["scored"] == 12 and sm["state_bytes"] == 2 * 256 * 4
    exact = streaming.make_metric("auc", "exact").compute(
        np.asarray([r.score for r in reqs], np.float32),
        np.asarray([r.label for r in reqs], np.float32))
    assert abs(sm["value"] - exact) <= sm["resolution"] + 1e-6
    m = LG.summarize(reqs, wall, eng)
    assert m["streaming_auc"] == sm["value"] and m["streaming_scored"] == 12


def test_streaming_metric_ignores_unlabeled_requests(cfg_params):
    eng = _engine(cfg_params, slots=2, metric=streaming.make_metric("auc", "exact"))
    cfg, _ = cfg_params
    tcfg = LG.TraceConfig(kind="batch", n_requests=4, prompt_len=(6, 20), max_new=(1, 3), seed=1)
    reqs, wall = LG.run_trace(eng, LG.make_trace(tcfg, cfg.vocab_size))
    assert eng.n_scored == 0 and eng.streaming_metrics()["value"] == 0.0
    eng2 = _engine(cfg_params, slots=2)
    assert eng2.streaming_metrics() is None
    assert "streaming_auc" not in LG.summarize(reqs, wall, eng2)


class _ExplodingList(list):
    def append(self, tok):
        raise RuntimeError("scorer exploded")


def test_scoring_failure_finalizes_request_not_engine(cfg_params):
    eng = _engine(cfg_params, slots=2)
    bad = Request(uid=0, prompt=[3, 4, 5], max_new_tokens=4)
    bad.generated = _ExplodingList()
    ok = Request(uid=1, prompt=[6, 7, 8, 9], max_new_tokens=3)
    assert eng.add_request(bad) and eng.add_request(ok)
    eng.run()
    assert bad.status == "failed" and bad.done and bad.latency is not None
    assert "RuntimeError" in bad.failure_reason and "scorer exploded" in bad.failure_reason
    assert eng.n_failed == 1 and ok.status == "done" and len(ok.generated) == 3
    late = Request(uid=2, prompt=[11, 12], max_new_tokens=2)
    assert eng.add_request(late) is True
    eng.run()
    assert late.status == "done"
    rec = LG.summarize([bad, ok, late], wall=1.0)
    assert rec["failed"] == 1 and rec["completed"] == 2


def test_ticks_exhausted_carries_partial_records(cfg_params):
    eng = _engine(cfg_params, slots=1, prefill_chunk=1, queue_limit=8)
    eng.add_request(Request(uid=0, prompt=list(range(1, 20)), max_new_tokens=8))
    eng.add_request(Request(uid=1, prompt=[2, 3], max_new_tokens=2))
    with pytest.raises(TicksExhausted) as ei:
        eng.run(max_ticks=3)
    by_uid = {r["uid"]: r for r in ei.value.records}
    assert list(by_uid) == [0, 1]
    assert by_uid[0]["status"] == "active" and by_uid[0]["prompt_consumed"] == 3
    assert by_uid[0]["generated"] == [] and by_uid[0]["t_admitted"] is not None
    assert by_uid[1]["status"] == "queued" and by_uid[1]["prompt_consumed"] == 0
    assert by_uid[1]["t_admitted"] is None
    assert TicksExhausted("plain").records == []


def test_metric_fold_failure_keeps_served_outcome(cfg_params):
    class _BrokenMetric:
        name, backend = "auc", "broken"

        def init(self):
            return {}

        def update(self, state, scores, labels):
            raise ValueError("sketch overflow")

    eng = _engine(cfg_params, slots=1, metric=_BrokenMetric())
    req = Request(uid=0, prompt=[4, 5, 6], max_new_tokens=2, label=1.0)
    eng.add_request(req)
    eng.run()
    assert req.status == "done" and len(req.generated) == 2
    assert req.failure_reason.startswith("metric: ValueError")
    assert eng.n_scored == 0 and eng.n_failed == 0


def test_engine_rejects_bad_knobs(cfg_params):
    for kw in ({"admission": "lifo"}, {"on_overflow": "wrap"}, {"prefill_chunk": 0}):
        with pytest.raises(ValueError):
            _engine(cfg_params, **kw)


# --------------------------------------------------------------------------
# against the reference engine, traces, the launcher
# --------------------------------------------------------------------------
def test_engine_tokens_equal_the_reference_engines_on_dbrx():
    """The same trace through the reference engine and the port's, on the
    same dbrx-132b smoke weights: every generated token is equal, the
    counters are equal, the scores agree."""
    jcfg, cfg, jp, p = _pair("dbrx-132b", seed=6)
    tcfg = dict(kind="batch", n_requests=6, prompt_len=(4, 20), max_new=(3, 7), seed=6)
    kw = dict(slots=3, max_len=32, prefill_chunk=4)
    jeng = JEngine(jcfg, jp, **kw)
    jreqs, _ = JLG.run_trace(jeng, JLG.make_trace(JLG.TraceConfig(**tcfg), cfg.vocab_size))
    eng = ServingEngine(cfg, p, **kw)
    reqs, _ = LG.run_trace(eng, LG.make_trace(LG.TraceConfig(**tcfg), cfg.vocab_size))
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.status == "done" for r in reqs)
    np.testing.assert_allclose([r.score for r in reqs], [r.score for r in jreqs], **TOL)
    for name in ("ticks", "tokens_prefilled", "tokens_decoded", "n_completed"):
        assert getattr(eng, name) == getattr(jeng, name), name


@pytest.mark.parametrize("tkw", [dict(kind="batch"), dict(kind="poisson", rate=32.0),
                                 dict(kind="bursty", burst_size=3),
                                 dict(kind="poisson", prefix_pool=3, prefix_len=5),
                                 dict(kind="batch", deadline=2.0, eos_id=7)])
def test_make_trace_equals_the_references(tkw):
    tcfg = dict(n_requests=9, seed=3, **tkw)
    got = LG.make_trace(LG.TraceConfig(**tcfg), 512)
    want = JLG.make_trace(JLG.TraceConfig(**tcfg), 512)
    assert len(got) == len(want) == 9
    for (ta, a), (tb, b) in zip(got, want):
        assert ta == tb
        assert (a.uid, a.prompt, a.max_new_tokens, a.eos_id, a.deadline, a.label) == \
            (b.uid, b.prompt, b.max_new_tokens, b.eos_id, b.deadline, b.label)


def test_labeled_trace_labels_and_lengths_equal_the_references():
    """Labeled prompts come from the ported tokens kind (the reference
    draws them with jax.random); the labels, prompt lengths, budgets and
    arrivals are the reference's, and the trace is seed-deterministic."""
    tcfg = dict(kind="poisson", n_requests=12, labeled=True, seed=9)
    got = LG.make_trace(LG.TraceConfig(**tcfg), 512)
    want = JLG.make_trace(JLG.TraceConfig(**tcfg), 512)
    assert [(t, r.label, len(r.prompt), r.max_new_tokens) for t, r in got] == \
        [(t, r.label, len(r.prompt), r.max_new_tokens) for t, r in want]
    again = LG.make_trace(LG.TraceConfig(**tcfg), 512)
    assert [r.prompt for _, r in got] == [r.prompt for _, r in again]
    other = LG.make_trace(LG.TraceConfig(**dict(tcfg, seed=10)), 512)
    assert [(r.prompt, r.label) for _, r in got] != [(r.prompt, r.label) for _, r in other]
    assert all(0 <= t < 512 for _, r in got for t in r.prompt)
    with pytest.raises(ValueError, match="p_pos"):
        LG.TraceConfig(labeled=True, p_pos=1.5)
    with pytest.raises(ValueError, match="trace kind"):
        LG.TraceConfig(kind="steady")


def test_serve_launcher_prints_the_references_lines():
    """``launch/serve.py --arch dbrx-132b --device cpu --labeled --metrics
    sketch``: the reference's request, throughput, latency and streaming
    lines."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "dbrx-132b", "--device", "cpu", "--requests", "5", "--max-new", "3",
                          "--labeled", "--metrics", "sketch"],
                         cwd=ROOT, env=one_thread_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == [f"req {i}" for i in range(4)]
    assert all(re.fullmatch(r"req \d: prompt\[\d+\] done -> \[(\d+, ){2}\d+\]", ln)
               for ln in lines[:4]), lines[:4]
    assert re.fullmatch(r"served 5/5 requests \(0 rejected, 0 expired\), 15 tokens in "
                        r"[\d.]+s \([\d.]+ tok/s, slots=4, chunk=8\)", lines[4]), lines[4]
    assert re.fullmatch(r"ttft p50/p99: [\d.]+/[\d.]+ ms; latency p50/p99: [\d.]+/[\d.]+ ms; "
                        r"ticks=\d+", lines[5]), lines[5]
    assert re.fullmatch(r"\[serve\] final \(5 scored\): streaming auc=\d\.\d{4}.* \(sketch\) "
                        r"n=5 state=16384B", lines[6]), lines[6]


# the engine's options in combination, each run through the reference
# engine and the port's on the same smoke weights: (arch, config fields,
# engine options, batch trace)
ENGINE_COMBOS = [
    ("stablelm-1.6b", {},                                          # prefix pool, SJF, short max_len
     dict(slots=2, max_len=24, prefill_chunk=4, prefix_cache_size=4, admission="sjf"),
     dict(n_requests=6, prompt_len=(4, 14), max_new=(2, 6), prefix_pool=2, prefix_len=5)),
    ("stablelm-1.6b", dict(window=8, window_mode="all_but_global", global_attn_every=2),
     dict(slots=3, max_len=32, prefill_chunk=4),
     dict(n_requests=5, prompt_len=(6, 20), max_new=(3, 8))),
    ("qwen2.5-14b", {},                                            # a bounded queue rejects
     dict(slots=2, max_len=32, prefill_chunk=4, queue_limit=3, prefix_cache_size=8),
     dict(n_requests=7, prompt_len=(6, 12), max_new=(2, 5), prefix_pool=1, prefix_len=4)),
    ("arctic-480b", {},                                            # prompts truncated to max_len
     dict(slots=2, max_len=16, prefill_chunk=4),
     dict(n_requests=4, prompt_len=(10, 24), max_new=(3, 6))),
]
ENGINE_COUNTERS = ("ticks", "tokens_prefilled", "tokens_decoded", "prefix_hits",
                   "prefix_misses", "n_completed", "n_rejected", "n_expired", "n_failed")


@pytest.mark.parametrize("arch,replace,ekw,tkw", ENGINE_COMBOS,
                         ids=["stablelm_prefix_sjf", "stablelm_window_all_but_global",
                              "qwen_queue_limit_prefix", "arctic_truncate"])
def test_engine_combinations_equal_the_reference_engines(arch, replace, ekw, tkw):
    """Tokens, statuses, truncation, prefix hits and every engine counter
    equal the reference engine's; the AUC-head scores agree at the logits'
    fp32 tolerance (atol 1e-5, rtol 1e-5)."""
    jcfg, cfg, jp, p = _pair(arch, seed=11, **replace)
    tcfg = dict(kind="batch", seed=11) | tkw
    jeng = JEngine(jcfg, jp, **ekw)
    jreqs, _ = JLG.run_trace(jeng, JLG.make_trace(JLG.TraceConfig(**tcfg), cfg.vocab_size))
    eng = ServingEngine(cfg, p, **ekw)
    reqs, _ = LG.run_trace(eng, LG.make_trace(LG.TraceConfig(**tcfg), cfg.vocab_size))
    for field in ("generated", "status", "truncated", "prompt_used", "prefix_hit_tokens"):
        assert [getattr(r, field) for r in reqs] == [getattr(r, field) for r in jreqs], field
    assert {r.status for r in reqs} == ({"done", "rejected"} if "queue_limit" in ekw
                                        else {"done"})
    served = [(r.score, j.score) for r, j in zip(reqs, jreqs) if r.score is not None]
    assert served and len(served) == sum(j.score is not None for j in jreqs)
    np.testing.assert_allclose(*zip(*served), **TOL)
    for name in ENGINE_COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    if "prefix_cache_size" in ekw:
        assert eng.prefix_hits > 0
    if ekw["max_len"] == 16:
        assert any(r.truncated for r in reqs)
