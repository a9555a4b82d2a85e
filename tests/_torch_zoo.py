"""Shared helpers of tests/test_torch_{vlm,hybrid,audio}.py: the port's
vlm, hybrid and audio families held against ``repro`` on the same numpy
inputs and on weights carried across with ``repro_torch.params``.

Tolerances (fp32, sums in another order), unless a test states its own:
  * hidden states, scores, logits, one local step: atol 1e-5, rtol 1e-5
    (``TOL``);
  * ``fit`` on replayed windows: losses rtol 1e-4 (atol 1e-6), final
    parameters atol 1e-4, as tests/test_torch_transformer.py holds the
    dense family;
  * bf16 KV caches: one bf16 ulp (rtol 2⁻⁷) over the fp32 atol;
  * bf16 parameters: the bf16 rule of tests/test_torch_bf16.py (the port's
    distance from the reference's bf16 result at most 2× the reference's own
    bf16-vs-fp32 distance, plus one bf16 ulp);
  * decode against the parallel forward: the reference's own 2e-3
    (tests/test_decode_consistency.py).
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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import coda as JC
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.launch.train import make_batch_adapters as jax_adapters
from repro.models import model as JM
from repro.serving import decode as JD
from repro.serving import loadgen as JLG
from repro.serving.engine import ServingEngine as JEngine
from _torch_threads import one_torch_thread  # noqa: F401  (re-exported for the family modules)
from repro_torch import params as P
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import coda as C
from repro_torch.core import schedules as S
from repro_torch.models import model as M
from repro_torch.serving import decode as D
from repro_torch.serving import loadgen as LG
from repro_torch.serving.engine import ServingEngine
from repro_torch.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


TOL = {"atol": 1e-5, "rtol": 1e-5}
DECODE_TOL = {"atol": 2e-3, "rtol": 2e-3}
FACTOR, ULP = 2.0, 2 ** -7
K = 2


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jx_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def tt(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(f32(got), f32(want), **(tol or TOL))


def bf16_close(got, want):
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -7, atol=1e-5)


def rule(port, ref16, ref32, what=""):
    """The bf16 rule: |port − ref16| ≤ FACTOR·|ref16 − ref32| + one bf16 ulp
    of max|ref32|."""
    p, r, f = f32(port), f32(ref16), f32(ref32)
    lim = FACTOR * float(np.abs(r - f).max()) + ULP * float(np.abs(f).max())
    err = float(np.abs(p - r).max())
    assert err <= lim, f"{what}: port vs reference bf16 {err:.3g} > limit {lim:.3g}"


def widen(tree):
    """Every bf16 leaf widened to fp32 (exact)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else x, tree)


def cfgs(arch, **replace):
    return tuple(dataclasses.replace(c, **replace)
                 for c in (jax_smoke(arch), get_smoke_config(arch)))


def stacked(jcfg, n, seed, dtype=jnp.float32):
    """n replicas of the reference's init, stacked on a leading axis (numpy)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np_tree(jax.vmap(lambda k: JM.init_params(k, jcfg, dtype=dtype))(keys))


def perturb(tree, seed, scale=0.02):
    """Non-zero biases and norm parameters, so their broadcasts are tested."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + rng.normal(0, scale, x.shape).astype(x.dtype)
        if x.ndim <= 3 and x.shape[-1] > 1 and x.dtype == np.float32 else x, tree)


def model_pair(arch, seed, n=K, **replace):
    """(jax cfg, port cfg, reference params [n, ...] as numpy, the port's)."""
    jcfg, cfg = cfgs(arch, **replace)
    tree = perturb(stacked(jcfg, n, seed), seed)
    return jcfg, cfg, tree, P.from_jax_params(cfg, tree)


def inputs(cfg, lead, seed, S=16, labels=False):
    """Numpy model inputs with leading ``lead``: the test_arch_smoke layout —
    vlm: n_patches patches + S - n_patches tokens; audio: S frames and
    S // decoder_fraction tokens; else S tokens."""
    rng = np.random.default_rng(seed)
    n_tok = {"vlm": S - cfg.n_patches, "audio": S // cfg.decoder_fraction}.get(cfg.family, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (n_tok,)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(lead + (cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(lead + (S, cfg.d_model)).astype(np.float32)
    if labels:
        out["labels"] = (rng.random(lead) < 0.7).astype(np.float32)
    return out


def init_state_np(jcfg, jccfg, seed):
    """The reference's ``init_state`` from ``PRNGKey(seed)``, compiled (op by
    op it takes seconds), as numpy."""
    return np_tree(jax.jit(lambda k: JC.init_state(k, jcfg, jccfg))(jax.random.PRNGKey(seed)))


def vmapped(fn, tree, batch):
    """The reference's ``fn(params, batch)`` over the leading worker axis,
    compiled (op-by-op dispatch of a scanned stack is slower)."""
    return jax.jit(jax.vmap(fn))(jx_tree(tree), jx_tree(batch))


# --------------------------------------------------------------------------
# the shared checks, one call a family
# --------------------------------------------------------------------------
def check_configs(arch):
    for ours, theirs in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (arch, f.name)


def check_score_prefill(arch, seed, S=16, **replace):
    jcfg, cfg, tree, p = model_pair(arch, seed, **replace)
    b = inputs(cfg, (K, 3), seed, S)
    want, _ = vmapped(lambda p_, b_: JM.score(jcfg, p_, b_), tree, b)
    got, aux = M.score(cfg, p, tt(b))
    assert got.shape == (K, 3) and aux.shape == (K,)
    close(got, want)
    s, logits, (kc, vc) = vmapped(lambda p_, b_: JM.prefill_step(jcfg, p_, b_), tree, b)
    gs, glog, (gk, gv) = M.prefill_step(cfg, p, tt(b))
    close(gs, s)
    assert glog.shape == (K, 3, cfg.vocab_size)
    close(glog, logits)
    assert tuple(gk.shape) == kc.shape and gk.dtype == torch.bfloat16
    bf16_close(gk, kc)
    bf16_close(gv, vc)
    h = np.random.default_rng(seed).standard_normal((K, 5, cfg.d_model)).astype(np.float32)
    want = vmapped(lambda p_, x: JM.lm_logits(jcfg, p_, x), tree, h)
    close(M.lm_logits(cfg, p, torch.from_numpy(h)), want)


def check_round_trip(arch, dtype):
    """Reference weights → the port → back, bitwise, in jax's leaf order; the
    port's own init has the same shapes and dtypes (fp32 norms, score bias,
    A_log and D under bf16)."""
    jcfg, cfg = cfgs(arch)
    tree = stacked(jcfg, K, 9, dtype=dtype)
    port = P.from_jax_params(cfg, tree)
    jl = jax.tree_util.tree_leaves(tree)
    assert [tuple(t.shape) for t in tree_leaves(port)] == [x.shape for x in jl]
    for a, b in zip(jl, jax.tree_util.tree_leaves(P.to_jax_params(cfg, port)), strict=True):
        assert a.dtype == b.dtype or a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    own = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    assert [tuple(t.shape) for t in tree_leaves(own)] == [x.shape[1:] for x in jl]
    assert [str(t.dtype).removeprefix("torch.") for t in tree_leaves(own)] == \
        [str(x.dtype) for x in jl]
    # the state crosses too, with every new leaf
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7)
    jst = init_state_np(jcfg, JC.CoDAConfig(n_workers=K, p_pos=0.7), 1)
    back = P.state_to_jax(cfg, P.state_from_jax(cfg, ccfg, jst))
    for a, b in zip(jax.tree_util.tree_leaves(jst), jax.tree_util.tree_leaves(back),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def check_count_params(arch, full: int, smoke: int):
    """``count_params`` from the shapes on the meta device equals the
    reference's ``jax.eval_shape`` count, at full width and smoke size."""
    assert M.count_params(get_config(arch)) == JM.count_params(jax_get_config(arch)) == full
    assert M.count_params(get_smoke_config(arch)) == JM.count_params(jax_smoke(arch)) == smoke
    shapes = jax.eval_shape(lambda k: JM.init_params(k, jax_get_config(arch)),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    leaves = tree_leaves(M.init_params(get_config(arch), device="meta"))
    assert [tuple(t.shape) for t in leaves] == \
        [x.shape for x in jax.tree_util.tree_leaves(shapes)]


def coda_pair(arch, n, seed, **ccfg_kw):
    jcfg, cfg = cfgs(arch)
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in ccfg_kw.items()}
    jccfg = JC.CoDAConfig(n_workers=n, p_pos=0.7, **jkw)
    ccfg = C.CoDAConfig(n_workers=n, p_pos=0.7, **ccfg_kw)
    jst = init_state_np(jcfg, jccfg, seed)
    return jcfg, cfg, jccfg, ccfg, jst, P.state_from_jax(cfg, ccfg, jst)


def check_local_step(arch, seed, **ccfg_kw):
    jcfg, cfg, jccfg, ccfg, jst, st = coda_pair(arch, 3, seed, **ccfg_kw)
    batch = inputs(cfg, (3, 4), seed, labels=True)
    jnew, jloss = jax.jit(lambda s_, b_: JC.local_step(jcfg, jccfg, s_, b_, 0.5))(
        jx_tree(jst), jx_tree(batch))
    new, loss = C.local_step(cfg, ccfg, st, tt(batch), 0.5)
    close(loss, jloss)
    got = P.state_to_jax(cfg, new, ccfg)
    for field in ("params", "duals", "ref_params", "ref_duals", "opt"):
        if field not in got:
            continue
        for g, w in zip(jax.tree_util.tree_leaves(got[field]),
                        jax.tree_util.tree_leaves(np_tree(jnew[field])), strict=True):
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=field)


def check_fit_replayed(arch, seed):
    """The reference's ``fit`` (K=4, 2 stages, T0=4, I=2, 8 examples a
    worker, tokens of length 16 under the launcher's modality stubs) with
    samplers that record their windows; the port's ``fit`` replays them
    from the same initial state."""
    jcfg, cfg = cfgs(arch)
    K_, I, Bsz = 4, 2, 8
    key = jax.random.PRNGKey(seed)
    ds = JShardedDataset(key, JDataConfig(kind="tokens", vocab_size=cfg.vocab_size,
                                          seq_len=16, signal=2.0, d_model=cfg.d_model),
                         512, K_, target_p=0.71)
    adapt = jax_adapters(jcfg, ds, key)
    jccfg = JC.CoDAConfig(n_workers=K_, p_pos=ds.p_pos)
    ccfg = C.CoDAConfig(n_workers=K_, p_pos=ds.p_pos)
    kw = dict(n_workers=K_, eta0=0.5, T0=4, I0=I)
    windows, alphas = [], []

    def record(store, batch):
        store.append(np_tree(batch))
        return batch

    jres = JC.fit(key, jcfg, jccfg, JS.ScheduleConfig(**kw), 2,
                  sample_window=lambda k, i: record(windows, adapt(ds.sample_window(k, i, Bsz))),
                  sample_alpha_batch=lambda k, m: record(alphas,
                                                         adapt(ds.sample_alpha_batch(k, m))))
    st0 = P.state_from_jax(cfg, ccfg, np_tree(JC.init_state(key, jcfg, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    res = C.fit(st0, cfg, ccfg, S.ScheduleConfig(**kw), 2,
                sample_window=lambda i: tt(next(wit)), sample_alpha_batch=lambda m: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds)
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(cfg, res.state)
    for g, w in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(np_tree(jres.state["params"])), strict=True):
        np.testing.assert_allclose(g, w, atol=1e-4)


def check_bf16_as_the_reference(arch, seed):
    """bf16 parameters as the reference runs them: one local step's losses
    (the scores' AUC loss) and new parameters under the bf16 rule against
    the reference's bf16 and fp32 results on the same weights."""
    jcfg, cfg, jccfg, ccfg, jst, st = coda_pair(arch, K, seed, param_dtype=torch.bfloat16)
    jcc32 = dataclasses.replace(jccfg, param_dtype=jnp.float32)
    batch = inputs(cfg, (K, 4), seed, labels=True)
    step = lambda c_, s_: jax.jit(lambda s, b_: JC.local_step(jcfg, c_, s, b_, 0.5))(
        jx_tree(s_), jx_tree(batch))
    j16, l16 = step(jccfg, jst)
    j32, l32 = step(jcc32, widen(jst))
    new, loss = C.local_step(cfg, ccfg, st, tt(batch), 0.5)
    rule(loss, l16, l32, f"{arch} losses")
    got = P.to_jax_params(cfg, new["params"])
    for i, (g, r, f) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                      jax.tree_util.tree_leaves(np_tree(j16["params"])),
                                      jax.tree_util.tree_leaves(np_tree(j32["params"])),
                                      strict=True)):
        rule(g, r, f, f"{arch} params leaf {i}")


def check_arch_smoke_forward_and_coda_step(arch):
    """``tests/test_arch_smoke.py::test_forward_and_coda_step`` on the port:
    one forward (scores in [0, 1], finite) and one window of one local step
    on K=2 workers, every state leaf finite."""
    cfg = get_smoke_config(arch)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    b = tt(inputs(cfg, (1, 2), 0, S=64))
    h, aux = M.score(cfg, _with_k(params), b)
    assert h.shape == (1, 2) and bool(torch.isfinite(h).all())
    assert bool(((h >= 0) & (h <= 1)).all())
    ccfg = C.CoDAConfig(n_workers=2, p_pos=0.7)
    state = C.init_state(cfg, ccfg, generator=torch.Generator().manual_seed(0))
    wb = tt(inputs(cfg, (1, 2, 2), 1, S=64, labels=True))
    state, losses = C.make_executor(cfg, ccfg).window_step(state, wb, 0.05)
    assert all(bool(torch.isfinite(l.float()).all()) for l in tree_leaves(state))
    assert bool(torch.isfinite(losses).all())


def _with_k(params):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x[None], params)


def check_serve_step_one_token(arch):
    """``tests/test_arch_smoke.py::test_serve_step_one_token`` on the port,
    and the step against the reference's on the same weights."""
    jcfg, cfg = cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    B = 2
    jc = JD.init_cache(jcfg, B, 32, use_window=True, dtype=jnp.float32)
    c = D.init_cache(cfg, B, 32, use_window=True, dtype=torch.float32)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.zeros((B,), np.int32)
    jl, js, jc2 = jax.jit(lambda c_, t_, p_: JD.serve_step(jcfg, jp, c_, t_, p_))(
        jc, jnp.asarray(tok), jnp.asarray(pos))
    logits, score_logit, c2 = D.serve_step(cfg, p, c, torch.from_numpy(tok),
                                           torch.from_numpy(pos))
    assert logits.shape == (B, cfg.vocab_size) and score_logit.shape == (B,)
    assert bool(torch.isfinite(logits).all())
    close(logits, jl)
    close(score_logit, js)
    for g, w in zip(tree_leaves(c2), jax.tree_util.tree_leaves(jc2), strict=True):
        close(g, w)
    l2, _, _ = D.serve_step(cfg, p, c2, torch.from_numpy(tok), torch.from_numpy(pos + 1))
    assert bool(torch.isfinite(l2).all())


def check_cache_shapes(arch, B=3, S=40):
    """``init_cache`` (and ``cache_specs`` on the meta device) has the
    reference's ``cache_specs`` leaves: shapes in jax's leaf order, the slot
    axis at dim 0."""
    jcfg, cfg = cfgs(arch)
    for use_window in (False, True):
        want = jax.tree_util.tree_leaves(JD.cache_specs(jcfg, B, S, use_window=use_window,
                                                        dtype=jnp.float32))
        for tree in (D.init_cache(cfg, B, S, use_window=use_window, dtype=torch.float32),
                     D.cache_specs(cfg, B, S, use_window=use_window, dtype=torch.float32)):
            got = tree_leaves(tree)
            assert [tuple(t.shape) for t in got] == [w.shape for w in want]
            assert [str(t.dtype).removeprefix("torch.") for t in got] == \
                [str(w.dtype) for w in want]
            assert all(t.shape[0] == B for t in got)
        assert all(t.device.type == "meta" for t in tree_leaves(
            D.cache_specs(cfg, B, S, use_window=use_window)))


LAUNCH_ARGS = ["--smoke", "--stages", "1", "--t0", "4", "--interval", "2", "--batch", "8",
               "--n-data", "256", "--device", "cpu"]


def check_launcher_accounting(arch, capsys):
    """``launch/train.py --arch ARCH --smoke`` (tiny, on the CPU, in this
    process): its iterations, communication rounds, bytes per round per
    worker and schedule total are the reference launcher's for the same
    flags — what ``repro.launch.train`` prints from ``coda.comm_rounds``,
    ``window_payload_bytes`` and ``comm_bytes`` over ``schedules.stages``,
    here evaluated on the reference's state shapes (``jax.eval_shape``, no
    compile) with the port's shard positive rate."""
    from repro_torch.launch import train
    out = train.main(["--arch", arch, *LAUNCH_ARGS])
    text = capsys.readouterr().out
    p_pos = float(re.search(r"^dataset: n=\d+ p_pos=(0\.\d+) workers=4$", text, re.M)[1])
    jccfg = JC.CoDAConfig(n_workers=4, p_pos=p_pos)
    jst = jax.eval_shape(lambda k: JC.init_state(k, jax_smoke(arch), jccfg),
                         jax.random.PRNGKey(0))
    stage_list = JS.stages(JS.ScheduleConfig(n_workers=4, eta0=0.5, T0=4, I0=2, p_pos=p_pos), 1)
    want = (sum(st.T for st in stage_list), JC.comm_rounds(stage_list),
            JC.window_payload_bytes(jst),
            JC.comm_bytes(stage_list, jst, None, stage_bytes=JC.stage_payload_bytes(jccfg)))
    got = re.search(r"^done: (\d+) iters, (\d+) comm rounds, .*\n"
                    r"bytes/round/worker=([\d,]+) \(schedule total ([\d,]+)\)$", text, re.M)
    assert got, text
    assert tuple(int(g.replace(",", "")) for g in got.groups()) == want
    assert (out["iterations"], out["comm_rounds"], out["bytes_per_round"]) == want[:3]
    return text


def check_depth_cut(arch, capsys):
    """``--n-layers 1`` (the port's own flag) cuts the smoke config's depth,
    an encoder-decoder's encoder too, and prints the cut; bytes per round are
    the reference's count of the cut config (params + 3 duals)."""
    from repro_torch.launch import train
    out = train.main(["--arch", arch, *LAUNCH_ARGS, "--n-layers", "1"])
    text = capsys.readouterr().out
    jcfg = jax_smoke(arch)
    cut = {"n_layers": 1} | ({"encoder_layers": 1} if jcfg.is_encoder_decoder else {})
    want = "reduced: " + ", ".join(f"{k} {getattr(jcfg, k)} -> 1" for k in cut)
    assert want + " (widths as published)" in text, text
    assert out["bytes_per_round"] == (JM.count_params(dataclasses.replace(jcfg, **cut)) + 3) * 4


def check_sm3_axis_rules(arch):
    """The same gradients through both packages' ``apply_grads`` with sm3
    (its per-axis accumulators follow each leaf's axes, ``params.ref_order``)
    over every leaf of the family: the accumulators bitwise, the parameters
    within atol 1e-6 (the port's 1/√x against XLA's rsqrt), as
    tests/test_torch_optimizer.py holds them."""
    jcfg, cfg, jccfg, ccfg, jst, st = coda_pair(arch, K, 15, optimizer="sm3")
    rng = np.random.default_rng(15)
    jgp = jax.tree_util.tree_map(
        lambda l: (0.1 * rng.standard_normal(l.shape)).astype(np.float32), jst["params"])
    jgd = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in jst["duals"].items()}
    want = np_tree(jax.jit(lambda s_, g_: JC.apply_grads(jccfg, s_, g_, jnp.float32(0.05)))(
        jx_tree(jst), (jx_tree(jgp), jx_tree(jgd))))
    gd = {k: torch.from_numpy(v) for k, v in jgd.items()}
    got = P.state_to_jax(cfg, C.apply_grads(ccfg, st, (P.from_jax_params(cfg, jgp), gd), 0.05),
                         ccfg)
    for field, atol in (("opt", 0), ("params", 1e-6)):
        for x, y in zip(jax.tree_util.tree_leaves(got[field]),
                        jax.tree_util.tree_leaves(want[field]), strict=True):
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=field)


def check_engine_equals_reference(arch, seed, ekw, tkw):
    """One trace through the reference engine and the port's on the same
    smoke weights: tokens, statuses and every counter equal; the AUC-head
    scores within the fp32 tolerance."""
    jcfg, cfg = cfgs(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    p = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    tcfg = dict(kind="batch", seed=seed) | tkw
    jeng = JEngine(jcfg, jp, **ekw)
    jreqs, _ = JLG.run_trace(jeng, JLG.make_trace(JLG.TraceConfig(**tcfg), cfg.vocab_size))
    eng = ServingEngine(cfg, p, **ekw)
    reqs, _ = LG.run_trace(eng, LG.make_trace(LG.TraceConfig(**tcfg), cfg.vocab_size))
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert all(r.status == "done" for r in reqs)
    np.testing.assert_allclose([r.score for r in reqs], [r.score for r in jreqs], **TOL)
    for name in ("ticks", "tokens_prefilled", "tokens_decoded", "n_completed"):
        assert getattr(eng, name) == getattr(jeng, name), name
