"""Where the port's bf16 arithmetic first departs from the reference's: the
forward of one bf16 local step of the stablelm-1.6b smoke config (2
layers: layernorm, q/k/v, partial RoPE, attention, wo, the residual, the
SwiGLU mlp), op by op in both packages on the same weights and tokens.

Each op of the port is fed the reference's own inputs to it and its output
is held against the reference's output of that op, in bf16 ulps (the
distance between the two values' bit patterns):

  * against the reference's ops dispatched one at a time (jnp eager, each
    op its own XLA program): every elementwise op bitwise; the matmuls and
    attention (fp32 sums in another order, then one rounding) within 2
    ulps on at most 0.1 % of the elements.  ``silu`` is among the bitwise
    ops since the port computes it as XLA's bf16 ``logistic`` does, one
    rounding a step (``models/mlp.silu``); ``F.silu`` rounds once and
    departed here first, by 2-3 ulps on a third of the elements (and
    ``gelu``, seamless-m4t-medium's, likewise: XLA's steps and bf16
    constants, where ``F.gelu`` rounds once);
  * against the reference's jitted forward (what ``jax.jit(local_step)``
    runs): the first op that departs beyond those bounds is layer 0's
    second layernorm, ``L0.norm2``.  XLA elides the bf16 rounding of the
    residual sum ``x + attn`` where the norm converts it back to fp32, so
    the jitted norm reads the unrounded sum; the port rounds every op's
    output.  Fed that unrounded sum the port's norm equals the jitted
    reference's bitwise, which names the cause (ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import ref as JR
from repro.models import embeddings as JE
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref as R
from repro_torch.models import embeddings as E
from repro_torch.models.mlp import gelu, linear, silu
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ARCH = "stablelm-1.6b"
B, S = 4, 16
GEMMS = ("q", "k", "v", "attention", "wo", "gate", "up", "down")
GEMM_ULPS, GEMM_SHARE = 2, 1e-3


def ulps(a, b) -> np.ndarray:
    """Elementwise distance in bf16 ulps between two bf16-valued arrays."""
    bits = lambda x: np.asarray(x, np.float32).view(np.int32).astype(np.int64) >> 16
    return np.abs(bits(a) - bits(b))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = P.from_jax_params(cfg, jax.tree_util.tree_map(lambda x: np.asarray(x)[None], jp))
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, tok


def _ref_ops(jcfg, jp, L):
    """Layer L's forward as (name, op on the dict of earlier outputs), in
    the reference's functions."""
    lp = jax.tree_util.tree_map(lambda a: a[L], jp["layers"])
    H, KV, hd = jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    pos = jnp.arange(S)[None]
    n = lambda op: f"L{L}.{op}"
    return [
        (n("norm1"), lambda c: JE.apply_norm(jcfg, lp["norm1"], c["x"])),
        (n("q"), lambda c: (c[n("norm1")] @ lp["attn"]["wq"]).reshape(B, S, H, hd)),
        (n("k"), lambda c: (c[n("norm1")] @ lp["attn"]["wk"]).reshape(B, S, KV, hd)),
        (n("v"), lambda c: (c[n("norm1")] @ lp["attn"]["wv"]).reshape(B, S, KV, hd)),
        (n("rope_q"), lambda c: JE.apply_rope(jcfg, c[n("q")], pos)),
        (n("rope_k"), lambda c: JE.apply_rope(jcfg, c[n("k")], pos)),
        (n("attention"), lambda c: JR.attention_full(c[n("rope_q")], c[n("rope_k")], c[n("v")],
                                                     causal=True)),
        (n("wo"), lambda c: c[n("attention")].reshape(B, S, H * hd) @ lp["attn"]["wo"]),
        (n("res1"), lambda c: c["x"] + c[n("wo")]),
        (n("norm2"), lambda c: JE.apply_norm(jcfg, lp["norm2"], c[n("res1")])),
        (n("gate"), lambda c: c[n("norm2")] @ lp["mlp"]["w_gate"]),
        (n("up"), lambda c: c[n("norm2")] @ lp["mlp"]["w_up"]),
        (n("silu_mul"), lambda c: jax.nn.silu(c[n("gate")]) * c[n("up")]),
        (n("down"), lambda c: c[n("silu_mul")] @ lp["mlp"]["w_down"]),
        (n("res2"), lambda c: c[n("res1")] + c[n("down")]),
    ]


def _port_ops(cfg, tp, L):
    """The same ops in the port's functions (one replica, K = 1)."""
    lp = {k: {f: v[:, L] for f, v in sub.items()} for k, sub in tp["layers"].items()}
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(S)
    n = lambda op: f"L{L}.{op}"
    return {
        n("norm1"): lambda c: E.apply_norm(cfg, lp["norm1"], c["x"]),
        n("q"): lambda c: linear(c[n("norm1")], lp["attn"]["wq"]).reshape(1, B, S, H, hd),
        n("k"): lambda c: linear(c[n("norm1")], lp["attn"]["wk"]).reshape(1, B, S, KV, hd),
        n("v"): lambda c: linear(c[n("norm1")], lp["attn"]["wv"]).reshape(1, B, S, KV, hd),
        n("rope_q"): lambda c: E.apply_rope(cfg, c[n("q")], pos),
        n("rope_k"): lambda c: E.apply_rope(cfg, c[n("k")], pos),
        n("attention"): lambda c: R.attention_full(c[n("rope_q")][0], c[n("rope_k")][0],
                                                   c[n("v")][0], causal=True)[None],
        n("wo"): lambda c: linear(c[n("attention")].reshape(1, B, S, H * hd), lp["attn"]["wo"]),
        n("res1"): lambda c: c["x"] + c[n("wo")],
        n("norm2"): lambda c: E.apply_norm(cfg, lp["norm2"], c[n("res1")]),
        n("gate"): lambda c: linear(c[n("norm2")], lp["mlp"]["w_gate"]),
        n("up"): lambda c: linear(c[n("norm2")], lp["mlp"]["w_up"]),
        n("silu_mul"): lambda c: silu(c[n("gate")]) * c[n("up")],
        n("down"): lambda c: linear(c[n("silu_mul")], lp["mlp"]["w_down"]),
        n("res2"): lambda c: c[n("res1")] + c[n("down")],
    }


def _reference_outputs(jcfg, jp, tok, jit: bool) -> tuple[list, dict]:
    """Every op's output in the reference: each op dispatched alone
    (``jit=False``) or the whole forward as one XLA program (``jit=True``,
    every intermediate an output of it)."""
    ops = [op for L in range(jcfg.n_layers) for op in _ref_ops(jcfg, jp, L)]

    def forward(tokens):
        c = {"x": JE.embed(jp["embed"], tokens)}
        for name, f in ops:
            c[name] = f(c)
            if name.endswith("res2"):
                c["x"] = c[name]
        return {k: v for k, v in c.items() if k != "x"}

    out = (jax.jit(forward) if jit else forward)(jnp.asarray(tok))
    return [name for name, _ in ops], out


def _departures(setup, jit: bool):
    """Per op: (max ulps, share of elements that differ) of the port's op fed
    the reference's inputs, against the reference's output."""
    jcfg, cfg, jp, tp, tok = setup
    names, ref = _reference_outputs(jcfg, jp, tok, jit)
    port = {}
    for L in range(cfg.n_layers):
        port.update(_port_ops(cfg, tp, L))
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)[None]
    x0 = bf(JE.embed(jp["embed"], jnp.asarray(tok)))
    out = {}
    for name in names:
        L = int(name[1])
        c = {k: bf(v) for k, v in ref.items()}
        c["x"] = c[f"L{L - 1}.res2"] if L else x0
        got = port[name](c)[0].float().numpy()
        d = ulps(got, ref[name])
        out[name] = (int(d.max()), float((d > 0).mean()))
    return names, out, ref


def _within(name, d) -> bool:
    op = name.split(".")[1]
    return d[0] == 0 or (op in GEMMS and d[0] <= GEMM_ULPS and d[1] <= GEMM_SHARE)


def test_every_op_equals_the_references_dispatched_alone(setup):
    names, dep, _ = _departures(setup, jit=False)
    bad = {n: dep[n] for n in names if not _within(n, dep[n])}
    assert not bad, f"ops departing from the reference's own op: {bad}"
    assert dep["L0.silu_mul"] == (0, 0.0) and dep["L1.silu_mul"] == (0, 0.0)


def test_first_departure_from_the_jitted_forward_is_the_residual_into_layernorm(setup):
    jcfg, cfg, jp, tp, tok = setup
    names, dep, ref = _departures(setup, jit=True)
    first = next(n for n in names if not _within(n, dep[n]))
    print(f"first op departing from the jitted reference: {first} {dep[first]}")
    assert first == "L0.norm2", (first, dep)
    # the cause: the jitted reference's norm reads x + attn before its bf16
    # rounding; fed that fp32 sum the port's norm is bitwise the reference's
    lp = {f: v[:, 0] for f, v in tp["layers"]["norm2"].items()}
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))[None]
    unrounded = f32(JE.embed(jp["embed"], jnp.asarray(tok))) + f32(ref["L0.wo"])
    got = E.apply_norm(cfg, lp, unrounded).to(torch.bfloat16)[0].float().numpy()
    assert not ulps(got, ref["L0.norm2"]).any()


@pytest.mark.parametrize("fn", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "fp32"])
def test_activations_are_xlas(fn, dtype):
    """``mlp.silu`` and ``mlp.gelu`` against ``jax.nn.silu`` and
    ``jax.nn.gelu``: bitwise in bf16 (XLA rounds each step, the logistic's
    included, and jnp's Python constants take bf16), within 1e-6 in fp32
    (where the two libraries' exp and tanh differ by an ulp)."""
    x = np.random.default_rng(1).standard_normal(20000).astype(np.float32) * 6
    want = np.asarray(jax.jit(getattr(jax.nn, fn))(jnp.asarray(x, dtype)), np.float32)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = {"silu": silu, "gelu": gelu}[fn](torch.from_numpy(x).to(tdt)).float().numpy()
    if dtype == jnp.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
