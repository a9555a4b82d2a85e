"""Shared helpers of tests/test_torch_bf16{,_coda,_serving}.py: bf16 parameters
through the port against ``repro``, and the bf16 rule those files state."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.models import attention as JA
from repro.models import blocks as JBL
from repro.models import embeddings as JE
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch import params as P
from repro_torch.configs import get_smoke_config, mlp_config
from repro_torch.core import coda as C
from repro_torch.core import schedules as S

FACTOR, ULP = 2.0, 2 ** -7
ROUTE_MARGIN = 2 ** -5
K = 2
ARCHS = ["mlp", "resnet50", "stablelm-1.6b", "qwen2.5-14b", "chatglm3-6b",
         "phi3-medium-14b", "dbrx-132b", "arctic-480b"]


def _cfgs(arch):
    if arch == "mlp":
        return jax_mlp_config(n_features=16, d=32), mlp_config(n_features=16, d=32)
    return jax_smoke(arch), get_smoke_config(arch)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _widen(tree):
    """Every bf16 leaf widened to fp32 (exact)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 else x, tree)


def _f32(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _rule(port, ref16, ref32, what=""):
    """|port − ref16| ≤ FACTOR·|ref16 − ref32| + one bf16 ulp of max|ref32|."""
    p, r, f = _f32(port), _f32(ref16), _f32(ref32)
    lim = FACTOR * float(np.abs(r - f).max()) + ULP * float(np.abs(f).max())
    err = float(np.abs(p - r).max())
    assert err <= lim, f"{what}: port vs reference bf16 {err:.3g} > limit {lim:.3g}"


def _rule_trees(port, ref16, ref32, what=""):
    for i, (p, r, f) in enumerate(zip(jax.tree_util.tree_leaves(port),
                                      jax.tree_util.tree_leaves(ref16),
                                      jax.tree_util.tree_leaves(ref32), strict=True)):
        _rule(p, r, f, f"{what} leaf {i}")


def _route_margin(jcfg, p, tok):
    """The reference's bf16 forward of one replica ``p`` over ``tok [B, S]``:
    each token's smallest gap, over the layers, between its k-th and
    (k+1)-th router logits (as log-gates from ``moe.route``): [B, S]."""
    x = JE.embed(p["embed"], tok)
    B, S, d = x.shape
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    k = jcfg.moe.top_k
    gap = jnp.full((B, S), jnp.inf)
    for i in range(jcfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], p["layers"])
        h = JE.apply_norm(jcfg, lp["norm1"], x)
        h2 = JE.apply_norm(jcfg, lp["norm2"],
                           x + JA.attend(jcfg, lp["attn"], h, pos, window=None))
        _, _, gates = JMoE.route(jcfg, lp["moe"], h2.reshape(B * S, d))
        lg = jnp.log(jnp.sort(gates, axis=-1)[:, ::-1])
        gap = jnp.minimum(gap, (lg[:, k - 1] - lg[:, k]).reshape(B, S))
        x = JBL.apply_layer(jcfg, lp, x, pos, -1, kind="decoder", causal=True)[0]
    return gap


def _settled(jcfg, tree, tok):
    """[K, B]: the sequences whose every token routes with a margin of at
    least ROUTE_MARGIN in every layer of the reference (every sequence of a
    dense model); at least one must be."""
    if jcfg.family != "moe":
        return np.ones(tok.shape[:2], bool)
    ok = np.stack([np.asarray(_route_margin(
        jcfg, jax.tree_util.tree_map(lambda a: jnp.asarray(a[w]), tree),
        jnp.asarray(tok[w]))).min(-1) >= ROUTE_MARGIN for w in range(tok.shape[0])])
    assert ok.any(), "every sequence routes near a tie"
    return ok


def _stacked(jcfg, seed, dtype=jnp.bfloat16):
    keys = jax.random.split(jax.random.PRNGKey(seed), K)
    return _np(jax.vmap(lambda k: JM.init_params(k, jcfg, dtype=dtype))(keys))


def _inputs(cfg, seed, lead=(K, 3)):
    rng = np.random.default_rng(seed)
    if cfg.family == "mlp":
        return {"features": rng.standard_normal(lead + (cfg.n_features,)).astype(np.float32)}
    if cfg.family == "cnn":
        # the reference's convolution takes bf16 weights only with bf16 images
        x = rng.standard_normal(lead + (16 * 16, 3)).astype(np.float32)
        return {"images": np.asarray(jnp.asarray(x, jnp.bfloat16))}
    return {"tokens": rng.integers(0, cfg.vocab_size, lead + (12,)).astype(np.int32)}


def _widen_inputs(batch):
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16 else v
            for k, v in batch.items()}


def _coda_pair(arch, seed, **kw):
    """(jax cfg, port cfg, reference bf16 state, its fp32 twin, port state,
    reference CoDA configs (bf16, fp32), port config)."""
    jcfg, cfg = _cfgs(arch)
    j16 = JC.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=jnp.bfloat16, **kw)
    j32 = dataclasses.replace(j16, param_dtype=jnp.float32)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, param_dtype=torch.bfloat16,
                        **{k: (torch.bfloat16 if v is jnp.bfloat16 else v)
                           for k, v in kw.items()})
    st16 = _np(JC.init_state(jax.random.PRNGKey(seed), jcfg, j16))
    st32 = dict(st16, params=_widen(st16["params"]), ref_params=_widen(st16["ref_params"]))
    return jcfg, cfg, st16, st32, P.state_from_jax(cfg, ccfg, st16), (j16, j32), ccfg


def _train_batch(cfg, seed, lead):
    rng = np.random.default_rng(seed)
    b = _inputs(cfg, seed, lead)
    b["labels"] = (rng.random(lead) < 0.7).astype(np.float32)
    return b


def _engine_run(eng, run, tcfg, vocab):
    reqs, _ = run.run_trace(eng, run.make_trace(run.TraceConfig(**tcfg), vocab))
    return reqs
