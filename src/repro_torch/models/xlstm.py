"""xLSTM blocks (counterpart of ``repro.models.xlstm``): the mLSTM (matrix
memory; chunkwise-parallel for train and prefill, an O(1) recurrent step
for decode) and the sLSTM (scalar memory, strictly sequential).
[arXiv:2405.04517]

Activations are ``[K, B, S, d]`` with the worker axis in front and every
parameter leaf ``[K, ...]``; after the projections K folds into the batch,
as ``attend`` folds it.  The reference's ``lax.scan`` over chunks (mLSTM)
and over positions (sLSTM) are Python loops.  The intra-chunk products are
plain einsums, as the reference computes them outside any Pallas kernel.
Where the reference writes the matrix memory at the end of every chunk,
the last chunk's write is left out here: the reference discards that carry,
so no output or gradient depends on it (at full width it would be a
``[K·B, H, hd, hd]`` fp32 tensor, 4 MiB a row).

dtypes follow jnp's promotion, with no casts the reference does not make:
the gates, stabilisers and memories are fp32; the sLSTM's carry ``h`` is
fp32, so ``h @ r`` promotes bf16 ``r`` and the sLSTM returns fp32, which
turns the residual stream fp32 for every later layer under bf16 weights
(``models/mlp.linear`` promotes as jnp does).  ``log_sigmoid`` is
``F.logsigmoid``: against ``jax.nn.log_sigmoid`` (−softplus(−x), jax's
logaddexp form) it is bitwise on 98.6 % of a grid over [−40, 40] and
within 2 fp32 ulps everywhere, closer than that formula written out in
torch ops (bitwise on 94.5 %, also 2 ulps), and one kernel where the
sLSTM's loop would launch six (tests/test_torch_xlstm.py).

Decode states have the slot axis at dim 0 and no worker axis, as the
serving caches: ``{"C": [B, H, hd, hd], "n": [B, H, hd], "m": [B, H]}`` for
an mLSTM layer and the tuple ``(c, n, h, m)`` of ``[B, d]`` for an sLSTM
layer, fp32 whatever the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.embeddings import ParamInit, bcast
from repro_torch.models.mlp import linear, silu


def _mdims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    H = cfg.n_heads
    return di, H, di // H


def log_sigmoid(x):
    """``jax.nn.log_sigmoid`` to 2 fp32 ulps (module doc)."""
    return F.logsigmoid(x)


def _scaled(t, c: float):
    """t · c with the Python constant rounded to t's dtype first (jnp's weak
    typing), rounded on the host: no copy to the device."""
    return t * float(torch.tensor(c, dtype=t.dtype))


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def init_mlstm(cfg: ModelConfig, init: ParamInit):
    """The reference's ``init_mlstm`` leaves (``xlstm.py:24-39``): the gate
    biases fp32 (``bf`` = 3, forget gate open), the rest in the parameter
    dtype."""
    d = cfg.d_model
    di, H, _ = _mdims(cfg)
    s = d ** -0.5
    return {"wq": init.normal((d, di), s), "wk": init.normal((d, di), s),
            "wv": init.normal((d, di), s), "wz": init.normal((d, di), s),
            "wi": init.normal((d, H), s), "wf": init.normal((d, H), s),
            "bi": init.zeros((H,), torch.float32),
            "bf": init.ones((H,), torch.float32).mul_(3.0),
            "w_down": init.normal((di, d), di ** -0.5)}


def _mlstm_qkv(cfg: ModelConfig, p, x):
    """x [K, B, S, d] → q, k, v [K, B, S, H, hd] (k scaled by hd^-½) in
    the projections' dtype, and the fp32 gate pre-activations ig, fg
    [K, B, S, H] (``xlstm.py:42-50``)."""
    di, H, hd = _mdims(cfg)
    lead = x.shape[:-1]
    q = linear(x, p["wq"]).reshape(*lead, H, hd)
    k = _scaled(linear(x, p["wk"]).reshape(*lead, H, hd), hd ** -0.5)
    v = linear(x, p["wv"]).reshape(*lead, H, hd)
    ig = linear(x, p["wi"]).to(torch.float32)
    fg = linear(x, p["wf"]).to(torch.float32)
    return q, k, v, ig + bcast(p["bi"], ig), fg + bcast(p["bf"], fg)


def apply_mlstm(cfg: ModelConfig, p, x, chunk: int = 256):
    """Chunkwise-parallel mLSTM (``xlstm.py:53-115``): chunks of C =
    min(chunk, S) positions in turn, carrying the matrix memory C, the
    normaliser n and the stabiliser m; quadratic only inside a chunk.
    x [K, B, S, d] → [K, B, S, d]."""
    K, B, S = x.shape[:3]
    di, H, hd = _mdims(cfg)
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"the mLSTM chunk {C} must divide the sequence length {S}")
    q, k, v, ig, fg = _mlstm_qkv(cfg, p, x)
    logf = log_sigmoid(fg)
    fold = lambda a: a.reshape(K * B, S, *a.shape[3:])
    q, k, v = (fold(a).to(torch.float32) for a in (q, k, v))   # [KB, S, H, hd]
    ig, logf = fold(ig), fold(logf)                            # [KB, S, H]
    f32 = dict(dtype=torch.float32, device=x.device)
    Cm = torch.zeros((K * B, H, hd, hd), **f32)
    n = torch.zeros((K * B, H, hd), **f32)
    m = torch.full((K * B, H), -1e30, **f32)
    tri = torch.ones((C, C), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    hs = []
    for c0 in range(0, S, C):
        qt, kt, vt = (a[:, c0:c0 + C] for a in (q, k, v))      # [KB, C, H, hd]
        igt, lft = ig[:, c0:c0 + C], logf[:, c0:c0 + C]        # [KB, C, H]
        F = torch.cumsum(lft, dim=1)                           # inclusive decay
        # intra-chunk log gates D[t, j] = F_t − F_j + ig_j (j ≤ t), −inf above
        D = F[:, :, None, :] - F[:, None, :, :] + igt[:, None, :, :]
        D = torch.where(tri, D, float("-inf"))
        m_intra = torch.amax(D, dim=2)                         # [KB, C, H]
        b = F + m[:, None, :]                                  # inter-chunk decay
        m_t = torch.maximum(m_intra, b)
        Dh = torch.exp(D - m_t[:, :, None, :])                 # [KB, C, C, H]
        Sm = torch.einsum("bihd,bjhd->bijh", qt, kt) * Dh
        inter_s = torch.exp(b - m_t)
        num = (torch.einsum("bijh,bjhd->bihd", Sm, vt)
               + inter_s[..., None] * torch.einsum("bihd,bhde->bihe", qt, Cm))
        den = Sm.sum(dim=2) + inter_s * torch.einsum("bihd,bhd->bih", qt, n)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])
        if c0 + C == S:     # the last chunk's carry is discarded (module doc)
            break
        Ftot = F[:, -1]                                        # [KB, H]
        g = Ftot[:, None] - F + igt                            # decay to chunk end
        m_new = torch.maximum(m + Ftot, torch.amax(g, dim=1))
        wr = torch.exp(g - m_new[:, None])                     # [KB, C, H]
        carry = torch.exp(m + Ftot - m_new)
        Cm = (carry[..., None, None] * Cm
              + torch.einsum("bjhd,bjhe->bhde", wr[..., None] * kt, vt))
        n = carry[..., None] * n + torch.einsum("bjh,bjhd->bhd", wr, kt)
        m = m_new
    h = torch.cat(hs, dim=1).reshape(K, B, S, di).to(x.dtype)
    h = h * silu(linear(x, p["wz"]))
    return linear(h, p["w_down"])


def init_mlstm_state(cfg: ModelConfig, B: int, dtype=torch.float32, device="cpu"):
    """One mLSTM layer's decode state for B slots (``xlstm.py:118-124``)."""
    _, H, hd = _mdims(cfg)
    return {"C": torch.zeros((B, H, hd, hd), dtype=dtype, device=device),
            "n": torch.zeros((B, H, hd), dtype=dtype, device=device),
            "m": torch.full((B, H), -1e30, dtype=dtype, device=device)}


def decode_mlstm(cfg: ModelConfig, p, state, x):
    """One-token recurrent mLSTM (``xlstm.py:127-147``) of one replica:
    x [1, B, 1, d] → (out [1, B, 1, d], new state)."""
    B = x.shape[1]
    di, _, _ = _mdims(cfg)
    q, k, v, ig, fg = (a[0, :, 0] for a in _mlstm_qkv(cfg, p, x))   # [B, H, (hd)]
    logf = log_sigmoid(fg)
    m_new = torch.maximum(logf + state["m"], ig)
    fs = torch.exp(logf + state["m"] - m_new)[..., None]
    is_ = torch.exp(ig - m_new)[..., None]
    Cs, ns = state["C"], state["n"]
    C = Cs * fs[..., None] + is_[..., None] * torch.einsum(
        "bhk,bhv->bhkv", k.to(Cs.dtype), v.to(Cs.dtype))
    n = ns * fs + is_ * k.to(ns.dtype)
    num = torch.einsum("bhkv,bhk->bhv", C, q.to(C.dtype))
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q.to(n.dtype))),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(1, B, 1, di).to(x.dtype)
    h = h * silu(linear(x, p["wz"]))
    return linear(h, p["w_down"]), {"C": C, "n": n, "m": m_new}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def init_slstm(cfg: ModelConfig, init: ParamInit):
    """The reference's ``init_slstm`` leaves (``xlstm.py:153-166``): the
    fused (z, i, f, o) input projection with its fp32 bias, the per-head
    recurrent matrices ``r [4, H, hd, hd]`` and the output projection."""
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    s = d ** -0.5
    return {"w_in": init.normal((d, 4 * d), s),
            "b_in": init.zeros((4 * d,), torch.float32),
            "r": init.normal((4, H, hd, hd), hd ** -0.5),
            "w_out": init.normal((d, d), s)}


def _slstm_cell(carry, u4, r):
    """One sLSTM step (``xlstm.py:169-188``) for K workers: carry (c, n, h,
    m) each [K, B, d] fp32, u4 the input pre-activations [K, B, 4d], ``r``
    the recurrent matrices [K, 4, H, hd, hd] already in the carry's
    promoted dtype.  Returns (new carry, h).  Every gate is fp32 here
    (``h @ r`` promotes), so ``torch.sigmoid`` stands for ``jax.nn.sigmoid``
    (they differ by fp32 rounding only)."""
    c, n, h, m = carry
    K, B, d = c.shape
    H = r.shape[2]
    rec = torch.einsum("kbhi,kghij->gkbhj", h.reshape(K, B, H, d // H).to(r.dtype),
                       r).reshape(4, K, B, d)
    z_, i_, f_, o_ = torch.chunk(u4, 4, dim=-1)
    z = torch.tanh(z_ + rec[0])
    logi = (i_ + rec[1]).to(torch.float32)
    logf = log_sigmoid((f_ + rec[2]).to(torch.float32))
    o = torch.sigmoid(o_ + rec[3])
    m_new = torch.maximum(logf + m, logi)
    i_s = torch.exp(logi - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * z.to(torch.float32)
    # jnp.maximum(·, 1e-6): n ≥ 1 after the first step (i_s = 1 wherever
    # m_new = logi, else f_s = 1 keeps n), so the floor never ties and
    # clamp_min's tie rule never differs from maximum's
    n_new = torch.clamp_min(f_s * n + i_s, 1e-6)
    h_new = (o.to(torch.float32) * c_new / n_new).to(h.dtype)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_inputs(p, x):
    """x @ w_in + b_in in x's dtype (``xlstm.py:194``): [K, ..., 4d]."""
    u = linear(x, p["w_in"])
    return u + bcast(p["b_in"].to(x.dtype), u)


def _recurrent(p, h):
    """``r`` in the dtype ``h @ r`` computes in (jnp's promotion), cast once."""
    return p["r"].to(torch.promote_types(h.dtype, p["r"].dtype))


def apply_slstm(cfg: ModelConfig, p, x):
    """The sequential sLSTM over x [K, B, S, d] (``xlstm.py:191-201``): one
    cell step a position, in a Python loop.  Returns fp32 (the carry's
    dtype) @ ``w_out``."""
    K, B, S, d = x.shape
    u = _slstm_inputs(p, x)                                    # [K, B, S, 4d]
    carry = tuple(t.expand(K, B, d) for t in init_slstm_state(cfg, B, d, device=x.device))
    r = _recurrent(p, carry[2])
    hs = []
    for t in range(S):
        carry, h = _slstm_cell(carry, u[:, :, t], r)
        hs.append(h)
    return linear(torch.stack(hs, dim=2), p["w_out"])


def init_slstm_state(cfg: ModelConfig, B: int, d: int = 0, device="cpu"):
    """One sLSTM layer's decode state for B slots (``xlstm.py:204-207``):
    (c, n, h, m) of [B, d] fp32, n = 1e-6 and m = −1e30."""
    d = d or cfg.d_model
    full = lambda v: torch.full((B, d), v, dtype=torch.float32, device=device)
    return (full(0.0), full(1e-6), full(0.0), full(-1e30))


def decode_slstm(cfg: ModelConfig, p, state, x):
    """One-token sLSTM (``xlstm.py:210-214``) of one replica: x [1, B, 1, d]
    → (out [1, B, 1, d], new state)."""
    u = _slstm_inputs(p, x[:, :, 0])                           # [1, B, 4d]
    carry, h = _slstm_cell(tuple(s[None] for s in state), u, _recurrent(p, state[2]))
    return linear(h, p["w_out"])[:, :, None], tuple(s[0] for s in carry)
