"""Plain PyTorch versions of the ported kernels — the semantics the CUDA
kernels are held to (counterpart of ``repro.kernels.ref``).

The elementwise ones (auc_loss, prox_update, opt_update) repeat the
reference's arithmetic in the same order; every scalar is an fp32 0-dim
tensor so each operation rounds in fp32, as the JAX oracle and the CUDA
kernels do.  Attention (``_mask``, ``attention_full``,
``attention_chunked``) sums in another order than the kernel's online
softmax and is held to it at a stated tolerance.  The grouped GEMM
(``grouped_layout``, ``grouped_matmul_ref``) is K5's plain version: one
fp32 matmul per row segment.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF

# The attention mask's sentinel, as the reference's: a finite -1e30, not
# -inf (exp(-inf - -inf) is NaN where a row has no valid key yet).
NEG_INF = -1e30


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def rsqrt(x):
    """1/√x as two correctly rounded fp32 operations (IEEE sqrt, then IEEE
    division), the same on the CPU, in CUDA's default math and in the
    kernel (``__fsqrt_rn``, ``__fdiv_rn``).  ``torch.rsqrt`` is not used: on
    CUDA it is the approximate ``rsqrtf``.  ``jax.lax.rsqrt`` on the CPU is
    itself within 1 ulp of the correctly rounded value, not equal to it,
    so against the reference this differs by at most 2 ulp."""
    return torch.reciprocal(torch.sqrt(x))


def auc_loss_ref(h, y, a, b, alpha, p: float):
    """Per-worker mean of F(w,a,b,α;z) and its closed-form partials
    (``repro.kernels.ref.auc_loss_ref:85-105`` with the worker axis written
    out).

    h: scores [K, T]; y: labels [K, T] ∈ {0,1}; a, b, alpha: [K] duals;
    p: the positive-class prior (host float).
    Returns (loss [K], dh [K, T] fp32, da [K], db [K], dalpha [K]).
    """
    h = h.to(torch.float32)
    pos = y.to(torch.float32)
    neg = 1.0 - pos
    a, b, alpha = (d.to(torch.float32)[:, None] for d in (a, b, alpha))
    T = h.shape[1]
    f = ((1 - p) * (h - a) ** 2 * pos
         + p * (h - b) ** 2 * neg
         + 2 * (1 + alpha) * (p * h * neg - (1 - p) * h * pos)
         - p * (1 - p) * alpha ** 2)
    loss = torch.mean(f, dim=1)
    dh = (2 * (1 - p) * (h - a) * pos + 2 * p * (h - b) * neg
          + 2 * (1 + alpha) * (p * neg - (1 - p) * pos)) / T
    da = torch.sum(-2 * (1 - p) * (h - a) * pos, dim=1) / T
    db = torch.sum(-2 * p * (h - b) * neg, dim=1) / T
    dalpha = (torch.sum(2 * (p * h * neg - (1 - p) * h * pos), dim=1) / T
              - 2 * p * (1 - p) * alpha[:, 0])
    return loss, dh, da, db, dalpha


def prox_update_ref(v, g, v0, eta: float, gamma: float):
    """v ← (γ(v − ηg) + ηv₀) / (η + γ) in fp32, stored in v's dtype
    (``repro.kernels.ref.prox_update_ref:179-185``)."""
    eta, gamma = _f32(eta), _f32(gamma)
    vf = v.to(torch.float32)
    out = gamma * (vf - eta * g.to(torch.float32)) + eta * v0.to(torch.float32)
    # divide by a tensor on out's device: torch's CUDA division by a CPU
    # scalar multiplies by the reciprocal, 1 ulp off the true quotient
    denom = torch.full((), (eta + gamma).item(), dtype=torch.float32,
                       device=out.device)
    return (out / denom).to(v.dtype)


# --------------------------------------------------------------------------
# fused optimizer update: hash-based stochastic rounding + opt_update_ref
# --------------------------------------------------------------------------
def _mul_u32(x, c: int):
    """(x · c) mod 2³² for int64 tensors holding uint32 values.  x·c can
    pass 2⁶³ when c ≥ 2³¹, so c is split into 16-bit halves: x·c_lo < 2⁴⁸
    and the high half only matters mod 2¹⁶, so every step is exact."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _mix_bits(x):
    """The reference's uint32 avalanche hash (``repro.kernels.ref._mix_bits``,
    ref.py:191-200), with uint32 emulated in int64 and ``& 0xFFFFFFFF``."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def stochastic_round(x, seed, dtype):
    """fp32 → ``dtype`` with the reference's hash-based stochastic rounding
    (``repro.kernels.ref.stochastic_round``, ref.py:203-218), bitwise.

    ``seed`` is a uint32 value as a Python int or an int64 tensor (one
    element, on x's device).  float32 is the identity.  For bf16 the hash of
    the value's own bits xor the seed gives 16 random low bits; they are
    added and the result truncated to its high 16 bits.  A NaN left after
    the truncation becomes the quiet NaN with its sign (0x7FC0 / 0xFFC0),
    as the reference's fp32→bf16 conversion gives; torch's own conversion
    would not (it drops the sign)."""
    if dtype == torch.float32:
        return x.to(torch.float32)
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic_round: float32 or bfloat16, got {dtype}")
    xi = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(()).to(torch.int64)
    r = _mix_bits(xi ^ seed) & 0xFFFF
    yi = (xi + r) & 0xFFFF0000
    hi = yi >> 16
    is_nan = (yi & 0x7FFFFFFF) > 0x7F800000
    hi = torch.where(is_nan, torch.where(yi >= 1 << 31, 0xFFC0, 0x7FC0), hi)
    hi = torch.where(hi >= 1 << 15, hi - (1 << 16), hi)     # as int16 bits
    return hi.to(torch.int16).view(torch.bfloat16)


def opt_update_ref(v, g, v0, buf, eta: float, gamma: float, coef: float,
                   seed, *, mode: str):
    """The fused optimizer update in the reference's order
    (``repro.kernels.ref.opt_update_ref``, ref.py:221-248).

    mode="momentum": m = coef·m + g, d = m, the new buffer stochastically
        rounded to ``buf.dtype``; coef = 0 with an fp32 buffer is
        ``prox_update_ref`` bitwise.
    mode="precond": buf is the fp32 cover; ν = cover + g², d = g/√(ν+coef)
        (``rsqrt`` above), ν returned in fp32.
    Both end in the proximal step.  Returns (new_v, new_buf)."""
    eta, gamma, coef = _f32(eta), _f32(gamma), _f32(coef)
    vf = v.to(torch.float32)
    gf = g.to(torch.float32)
    bf = buf.to(torch.float32)
    if mode == "momentum":
        acc = coef * bf + gf
        d = acc
        new_buf = stochastic_round(acc, seed, buf.dtype)
    elif mode == "precond":
        acc = bf + gf * gf
        d = gf * rsqrt(acc + coef)
        new_buf = acc
    else:
        raise ValueError(f"unknown opt_update mode {mode!r}")
    out = gamma * (vf - eta * d) + eta * v0.to(torch.float32)
    denom = torch.full((), (eta + gamma).item(), dtype=torch.float32,
                       device=out.device)
    return (out / denom).to(v.dtype), new_buf


# --------------------------------------------------------------------------
# attention (GQA, causal / sliding window): K4 flash_attention's plain version
# --------------------------------------------------------------------------
def _mask(q_pos, kv_pos, causal: bool, window):
    """[S, Skv] validity (``repro.kernels.ref._mask``, ref.py:15-23).
    ``window`` None or negative means full attention."""
    valid = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                       device=q_pos.device)
    if causal:
        valid &= kv_pos[None, :] <= q_pos[:, None]
    if window is not None and int(window) >= 0:
        valid &= kv_pos[None, :] > (q_pos[:, None] - int(window))
    return valid


def _grouped_q(q, KV: int):
    """q [B, S, H, hd] → fp32 [B, S, KV, G, hd] scaled by hd^-0.5: query
    head h = kv·G + g reads KV head kv = h // G."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, KV, H // KV, hd).to(torch.float32) * hd ** -0.5


def attention_full(q, k, v, *, causal: bool = True, window=None,
                   return_lse: bool = False):
    """q: [B, S, H, hd]; k/v: [B, Skv, KV, hd] -> [B, S, H, hd] in q's dtype
    (``repro.kernels.ref.attention_full``, ref.py:26-38): materialised fp32
    scores, masked with -1e30, softmax, then the values.

    ``return_lse=True`` also returns the per-row log-sum-exp of the masked
    scores as fp32 ``[B, H, S]``, the second output of the K4 kernel."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qg = _grouped_q(q, KV)
    s = torch.einsum("bskgh,bckh->bskgc", qg, k.to(torch.float32))
    pos = lambda n: torch.arange(n, device=q.device)
    valid = _mask(pos(S), pos(Skv), causal, window)
    s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgc,bckh->bskgh", w, v.to(torch.float32))
    o = o.reshape(B, S, H, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).reshape(B, S, H).transpose(1, 2)
    return o, lse.contiguous()


def attention_chunked(q, k, v, *, causal: bool = True, window=None,
                      chunk: int = 512):
    """Online-softmax attention over KV chunks, O(S·chunk) scores
    (``repro.kernels.ref.attention_chunked``, ref.py:41-82): the running
    max m, denominator l and accumulator stay fp32, l is floored at 1e-30.
    Used where the KV length passes 8,192 on the CPU (``ops.attention``)."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    C = min(chunk, Skv)
    if Skv % C:
        raise ValueError(f"attention_chunked: Skv={Skv} is not a multiple of "
                         f"the chunk {C}")
    qg = _grouped_q(q, KV)
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    m = torch.full((B, S, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=dev)
    for j in range(Skv // C):
        kj = k[:, j * C:(j + 1) * C].to(torch.float32)
        vj = v[:, j * C:(j + 1) * C].to(torch.float32)
        s = torch.einsum("bskgh,bckh->bskgc", qg, kj)
        valid = _mask(q_pos, j * C + torch.arange(C, device=dev), causal, window)
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckh->bskgh", p, vj)
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(B, S, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# ragged grouped GEMM (sorted dropless MoE dispatch): K5's plain version
# --------------------------------------------------------------------------
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def grouped_layout(group_sizes, n_rows: int, block_rows: int):
    """The reference's tile-aligned row mapping (``repro.kernels.ref.
    grouped_layout``, ref.py:115-144), with the same integers: each group's
    row segment padded up to a multiple of ``block_rows`` so that every row
    tile belongs to one group.  Returns ``(dst [N], tile_gid [n_tiles],
    n_padded)``: sorted row i lands at ``dst[i]``, tile t is owned by group
    ``tile_gid[t]``, and ``n_padded = round_up(N, bm) + min(E, N)·bm`` is
    the static bound (one tile of slack per non-empty group).  The K5
    kernel's grid uses the same bound."""
    E = group_sizes.shape[0]
    gs = group_sizes.to(torch.int64)
    inc = torch.cumsum(gs, 0)
    exc = inc - gs
    pc = (gs + block_rows - 1) // block_rows * block_rows
    pinc = torch.cumsum(pc, 0)
    pexc = pinc - pc
    rows = torch.arange(n_rows, dtype=torch.int64, device=gs.device)
    g_row = torch.clamp(torch.searchsorted(inc, rows, right=True), 0, E - 1)
    dst = pexc[g_row] + (rows - exc[g_row])
    n_padded = _round_up(max(n_rows, 1), block_rows) + min(E, max(n_rows, 1)) * block_rows
    tile_starts = torch.arange(n_padded // block_rows, dtype=torch.int64,
                               device=gs.device) * block_rows
    tile_gid = torch.clamp(torch.searchsorted(pinc, tile_starts, right=True), 0, E - 1)
    return dst.to(torch.int32), tile_gid.to(torch.int32), n_padded


def expert_weight(w, g: int):
    """Group ``g``'s ``[Kd, F]`` block of a grouped weight: ``w [G, Kd, F]``,
    or ``w [R, E, Kd, F]`` with G = R·E groups, g = r·E + e (the worker axis
    folded into the groups).  A view: nothing is copied."""
    if w.dim() == 3:
        return w[g]
    return w[g // w.shape[1], g % w.shape[1]]


def n_groups(w) -> int:
    return w.shape[0] if w.dim() == 3 else w.shape[0] * w.shape[1]


def grouped_matmul_ref(x, w, group_sizes):
    """out[i] = x[i] @ w[g(i)] for rows of ``x`` sorted by group: x [N, Kd],
    w [G, Kd, F] (or [R, E, Kd, F], see ``expert_weight``), group_sizes [G]
    with ``sum == N``.  Returns [N, F] in x's dtype, summed in fp32.

    One matmul per non-empty row segment (the reference scans tile-aligned
    blocks, ``repro.kernels.ref.grouped_matmul_ref``, ref.py:147-173; the
    products are the same, summed in another order).  Differentiable with
    respect to x and w.  The segment sizes are read on the host: this is
    the plain version, not the kernel's path."""
    N, Kd = x.shape
    G = n_groups(w)
    F = w.shape[-1]
    if w.shape[-2] != Kd or group_sizes.shape != (G,):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)} do not fit")
    sizes = [int(n) for n in group_sizes.tolist()]
    if min(sizes, default=0) < 0 or sum(sizes) != N:
        raise ValueError(f"grouped_matmul: group sizes {sizes} do not tile {N} rows")
    outs, start = [], 0
    for g, n in enumerate(sizes):
        if n:
            outs.append(torch.matmul(x[start:start + n].to(torch.float32),
                                     expert_weight(w, g).to(torch.float32)))
            start += n
    if not outs:
        return x.new_zeros((0, F))
    return torch.cat(outs).to(x.dtype)
