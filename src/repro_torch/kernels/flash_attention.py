"""K4 flash attention: CUDA kernel wrapper, its autograd function, and the
plain backward.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` (lines 94-145, ``pallas_call`` at :120): GQA attention
over q ``[B, S, H, hd]`` and k/v ``[B, Skv, KV, hd]`` with causal and static
sliding-window masks, online softmax in fp32, KV tiles outside the band
skipped, query head h reading KV head ``h // G``.  Output in q's dtype
(fp32 or bf16).  The kernel also writes each row's log-sum-exp (fp32
``[B, H, S]``), which the backward reuses.

What bounds it on the card, and the design: see ``csrc/flash_attention.cu``.
Three variants, chosen on the host from static facts (``launch_geometry``):
``flash_fwd_pingpong`` for bf16 q/k/v with head_dim 64 or 128 and 16-byte
aligned bases — 128-row query tiles, TMA-fed K/V ring, q·kᵀ and P·V on the
bf16 tensor cores (wgmma) with P rounded to bf16, three consumer
warpgroups at head_dim 64 and persistent blocks at 128, one ex2 a score,
two heads a block when S and Skv are at most 64; ``flash_fwd_tf32x3`` for
fp32 q/k/v with head_dim 64 or 128 and 16-byte aligned bases — the same structure
with q·kᵀ and P·V as split TF32 (each operand x = big + small, both tf32,
and big·big + big·small + small·big on the tf32 tensor cores, fp32
accumulation: each product within 3·2^-22 of its value, held to the plain
fp32 version at fp32's tolerance); and ``flash_fwd`` for every other call (fp32
or bf16 at head_dim 16/32, or an unaligned base) — 64-row query tiles, fp32
FFMA.  At the prefill shape arithmetic bounds them (bf16 or
TF32 tensor-core, or fp32 rates), at the training shape (64-token
sequences) bytes.  ``flash_fwd_wgmma``, the first bf16 tensor-core form
(its warpgroups in phase), takes no call of the wrapper's: it stays as
``flash_fwd_pingpong``'s yardstick, launched on the same values through the
C entry point's variant id (``_launch``), uncounted.

Rows with no valid key (a window that closes before the keys begin, or
every row of a causal mask with window 0: ``no_key_rows``) get the
reference function's value, whatever the variant wrote there: the
reference (``repro.kernels.ref.attention_full``) softmaxes Skv equal −1e30
sentinels, so o is the fp32 mean of the KV head's V over all Skv keys,
rounded to q's dtype, and lse is fp32(−1e30) (−1e30 + log Skv rounds to
it).  On the card the C entry point launches ``flash_fill_no_key`` after
the variant for those rows (counted apart, ``no_key_fills``); the Pallas
kernel's own value there, a mean over the blocks its early-out visits,
depends on its block size and is not followed.

The Pallas kernel has no VJP: the reference differentiates attention by
XLA autodiff outside any kernel.  Here ``FlashAttention`` is a
``torch.autograd.Function`` whose forward is K4 and whose backward is plain
tensor code (``attention_bwd``): P recomputed from the saved log-sum-exp,
then D = rowsum(dO∘O), dS = P∘(dP − D) cut to 0 outside the mask, and dQ,
dK, dV with dK and dV summed over the G query heads of each KV head.

The wrapper computes the plain version (``ref.attention_full``) for CPU
tensors, and launches the kernel or raises for CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build, ref

# Kernel launches through this wrapper (one per call that reaches the card),
# in all and by variant.
launches = 0
variant_launches = {"flash_fwd": 0, "flash_fwd_wgmma": 0, "flash_fwd_tf32x3": 0,
                    "flash_fwd_pingpong": 0}
# launches of flash_fill_no_key through this wrapper (one per call that
# reaches the card with rows that have no valid key), apart from the variants
no_key_fills = 0
# the C entry point's variant argument
_VARIANT_ID = {"flash_fwd": 0, "flash_fwd_wgmma": 1, "flash_fwd_tf32x3": 2,
               "flash_fwd_pingpong": 3}

BLOCK_Q = BLOCK_K = 64
THREADS = 256
HEAD_DIMS = (16, 32, 64, 128)
# flash_fwd_wgmma (csrc/flash_attention.cu's kWg* constants)
WG_BLOCK_Q = WG_BLOCK_K = 128
WG_THREADS = 384                  # two consumer warpgroups + a producer warpgroup
WG_HEAD_DIMS = (64, 128)
WG_STAGES = {64: 3, 128: 2}
# flash_fwd_tf32x3 (csrc/flash_attention.cu's kTf* constants)
TF_BLOCK_Q = 128
TF_BLOCK_K = {64: 64, 128: 32}    # keys a K/V tile, by head_dim: 16 KB in fp32 at both
TF_THREADS = 384                  # two consumer warpgroups + a load-and-split warpgroup
TF_HEAD_DIMS = (64, 128)
TF_STAGES = 2                     # depth of each of the K, V and Vᵀ rings
TF_PACK = 64                      # two heads a block when S and Skv are at most this
# flash_fwd_pingpong (csrc/flash_attention.cu's kPp* constants)
PP_BLOCK_K = 128                  # keys a K/V tile
PP_PACK_BLOCK_K = 64              # keys a K/V tile when an item packs two heads
PP_CONSUMERS = {64: 3, 128: 2}    # consumer warpgroups of 64 query rows, by head_dim
PP_PACK_CONSUMERS = 2             # one per head when packed
PP_HEAD_DIMS = (64, 128)
PP_STAGES = {64: 4, 128: 2}
PP_PACK = 64                      # two heads an item when S and Skv are at most this
_DTYPES = (torch.float32, torch.bfloat16)


def launch_geometry(B: int, S: int, H: int, KV: int, Skv: int, hd: int,
                    dtype=torch.float32, aligned: bool = True) -> dict:
    """Static launch geometry of one call (the counterpart of the Pallas
    kernel's ``launch_geometry``), and the variant, from the dtype, head_dim
    and whether q, k and v are 16-byte aligned (``aligned``, which TMA
    needs): ``flash_fwd_pingpong`` for bf16 at head_dim 64/128,
    ``flash_fwd_tf32x3`` for fp32 at head_dim 64/128, ``flash_fwd`` for
    every other call.  grid = (query tiles, H, B).
    flash_fwd: 64-row tiles, 256 threads, dynamic shared memory for the
    transposed q tile, one K and one V tile and the probability tile.
    flash_fwd_pingpong: consumer warpgroups of 64 query rows (three at
    head_dim 64: 192-row items, 512 threads; two at 128: 128-row items, 384
    threads) and a producer warpgroup; the q tile and a ring of K/V stages
    of 128 keys in bf16 (4 at head_dim 64, 2 at 128), their barriers and
    1 KB of alignment slack; when S and Skv are both at most 64 an item
    packs two heads, one per consumer warpgroup of two, with 64-key tiles in
    the same shared memory.  Items are (query tile, head, batch row), or
    (head pair, batch row) when packed; grid = (items, 1, 1) at head_dim 64
    unpacked, else min(items, SMs) persistent blocks that walk them, the
    SMs of the current CUDA device as the kernel's launch reads them
    (``_sm_count``; a host without a card reports a block an item).
    flash_fwd_tf32x3: 128-row tiles, 384 threads, q_small of the
    tile and rings of fp32 stages of 64 keys at head_dim 64, 32 at 128
    (q_big lives in registers); when S and Skv are both at most 64 (one
    warpgroup's rows; one K/V tile at head_dim 64, two at 128) it packs two
    heads into a block, one per consumer warpgroup: grid = (1, ceil(H / 2),
    B).
    ``tma_box``: the K/V tensor maps' box (dims, KV heads, keys, batch) of
    the two TMA variants.
    Unlike the Pallas kernel, S and Skv need not divide by the tiles: the
    ragged edge is masked (or zero-filled by TMA), and the KV tiles are a
    loop inside the block, so Skv does not enter the grid otherwise."""
    if dtype == torch.bfloat16 and hd in PP_HEAD_DIMS and aligned:
        # q of the unpacked form's warpgroups; per stage a K and a V tile of
        # 128 keys; 4 barriers a stage, a q-full and a q-empty barrier a
        # consumer warpgroup; 1 KB of slack
        stages, most = PP_STAGES[hd], PP_CONSUMERS[hd]
        smem = 64 * most * hd * 2 + stages * 2 * PP_BLOCK_K * hd * 2 \
            + (4 * stages + 2 * most) * 8 + 1024
        packed = S <= PP_PACK and Skv <= PP_PACK
        nc = PP_PACK_CONSUMERS if packed else PP_CONSUMERS[hd]
        bq, bk = 64 * nc, PP_PACK_BLOCK_K if packed else PP_BLOCK_K
        persistent = packed or hd != 64
        items = math.ceil(H / 2) * B if packed else math.ceil(S / bq) * H * B
        return {"kernel": "flash_fwd_pingpong", "bq": bq, "bk": bk, "G": H // KV,
                "consumers": nc, "threads": 128 * (nc + 1), "stages": stages,
                "packed": packed, "persistent": persistent, "items": items,
                "grid": (min(items, _sm_count()) if persistent else items, 1, 1),
                "smem_bytes": smem,
                "tma_box": (64, 1, bk, 1)}
    if dtype == torch.float32 and hd in TF_HEAD_DIMS and aligned:
        # q_small of the 128 rows; per stage five fp32 tiles of bk keys (K
        # rounded in place, K_small, V as loaded, Vᵀ_big, Vᵀ_small) and 7
        # barriers; 1 KB of slack
        bk = TF_BLOCK_K[hd]
        smem = TF_BLOCK_Q * hd * 4 + TF_STAGES * (5 * bk * hd * 4 + 7 * 8) + 1024
        packed = S <= TF_PACK and Skv <= TF_PACK
        grid = (1, math.ceil(H / 2), B) if packed else (math.ceil(S / TF_BLOCK_Q), H, B)
        return {"kernel": "flash_fwd_tf32x3", "bq": TF_BLOCK_Q, "bk": bk,
                "G": H // KV, "threads": TF_THREADS, "stages": TF_STAGES, "packed": packed,
                "grid": grid, "smem_bytes": smem, "tma_box": (32, 1, bk, 1)}
    smem_floats = hd * (BLOCK_Q + 4) + BLOCK_K * (hd + 1) + BLOCK_K * hd \
        + BLOCK_K * (BLOCK_Q + 4)
    return {"kernel": "flash_fwd", "bq": BLOCK_Q, "bk": BLOCK_K, "G": H // KV,
            "threads": THREADS, "grid": (math.ceil(S / BLOCK_Q), H, B),
            "smem_bytes": 4 * smem_floats}


def _sm_count() -> float:
    """The current CUDA device's SMs, which bound a persistent launch's
    blocks (the kernel's launch reads the same attribute); unbounded on a
    host without a card."""
    if not torch.cuda.is_available():
        return math.inf
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def wgmma_geometry(B: int, S: int, H: int, KV: int, Skv: int, hd: int) -> dict:
    """``flash_fwd_wgmma``'s launch geometry (bf16, head_dim 64/128,
    aligned bases): 128-row tiles, 384 threads, the q tile and a ring of K/V
    stages of 128 keys in bf16, their barriers and 1 KB of alignment slack;
    grid = (query tiles, H, B).  No call of the wrapper's takes it: it is
    ``flash_fwd_pingpong``'s yardstick (``_launch``)."""
    if hd not in WG_HEAD_DIMS:
        raise ValueError(f"flash_fwd_wgmma is built for head_dim in {WG_HEAD_DIMS}, got {hd}")
    stages = WG_STAGES[hd]
    smem = WG_BLOCK_Q * hd * 2 + stages * (2 * WG_BLOCK_K * hd * 2 + 24) + 8 + 1024
    return {"kernel": "flash_fwd_wgmma", "bq": WG_BLOCK_Q, "bk": WG_BLOCK_K,
            "G": H // KV, "threads": WG_THREADS, "stages": stages,
            "grid": (math.ceil(S / WG_BLOCK_Q), H, B), "smem_bytes": smem,
            "tma_box": (64, 1, WG_BLOCK_K, 1)}


def zero_launches() -> None:
    """Set the launch counters (the total, each variant's and the fill's)
    to 0."""
    global launches, no_key_fills
    launches = no_key_fills = 0
    for name in variant_launches:
        variant_launches[name] = 0


def normalize_window(window):
    """None or a negative window means full attention (None); otherwise a
    Python int."""
    if window is None or int(window) < 0:
        return None
    return int(window)


def no_key_rows(S: int, Skv: int, causal: bool, window) -> int | None:
    """The first query row with no valid key (its row of ``ref._mask`` all
    false), or None when every row has one; the rows from it to S − 1 have
    none.  Row q keeps the keys kv > q − window (and kv ≤ q when causal);
    the last key is Skv − 1, so with a window w every row q ≥ Skv + w − 1
    has none, and causal with w = 0 leaves no row a key.  Without a window
    key 0 is valid for every row.  (The C entry point's ``no_key_first``
    is the same arithmetic.)"""
    window = normalize_window(window)
    if window is None:
        return None
    first = 0 if causal and window == 0 else Skv + window - 1
    return first if first < S else None


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q [B,S,H,hd], k/v [B,Skv,KV,hd]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and hd, H % KV == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention wants q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention inputs lie on several devices")


def _readable(t):
    """``t``, or a copy in a fresh (aligned) allocation when its base is one
    ``flash_fwd`` cannot read: that kernel loads four values at a time (16
    bytes in fp32, 8 in bf16), and a base off that alignment faults with a
    misaligned address.  A base that is 8-byte but not 16-byte aligned in
    bf16 stays, and routes to ``flash_fwd`` (TMA needs 16)."""
    return t if t.data_ptr() % (4 * t.element_size()) == 0 else t.clone()


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None):
    """Returns (o [B, S, H, hd] in q's dtype, lse [B, H, S] fp32)."""
    _check(q, k, v)
    window = normalize_window(window)
    if q.device.type == "cpu":
        return ref.attention_full(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, got {q.device}")
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention is built for head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention's grid takes B, H <= 65535; got {B}, {H}")
    global launches, no_key_fills
    q, k, v = (_readable(t.contiguous()) for t in (q, k, v))
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    kernel = launch_geometry(B, S, H, KV, Skv, hd, q.dtype, aligned)["kernel"]
    o, lse = _launch(kernel, q, k, v, causal, window)
    launches += 1
    variant_launches[kernel] += 1
    if no_key_rows(S, Skv, causal, window) is not None:
        no_key_fills += 1           # the entry point's flash_fill_no_key after the variant
    return o, lse


def _launch(kernel: str, q, k, v, causal: bool, window):
    """One launch of variant ``kernel`` through the C entry point's variant
    id on contiguous CUDA tensors (the entry point refuses a dtype or
    head_dim the variant lacks), then ``flash_fill_no_key`` where rows have
    no valid key; counts nothing.  The wrapper calls it with
    ``launch_geometry``'s pick; a check may call it with another variant on
    the same values."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _build.load().flash_attention_forward(
        int(q.dtype == torch.bfloat16), hd, _VARIANT_ID[kernel],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S,
        H, Skv, KV, int(bool(causal)), -1 if window is None else window, hd ** -0.5,
        stream)
    _build.check(err, f"flash_attention launch ({kernel})")
    return o, lse


def fill_no_key_ref(o, lse, v, first: int) -> None:
    """``flash_fill_no_key``'s plain version, in place: rows ``first`` … S − 1
    of o [B, S, H, hd] get the fp32 mean of their KV head's V [B, Skv, KV,
    hd] over all Skv keys, rounded to o's dtype, and those rows of lse
    [B, H, S] get fp32(−1e30)."""
    B, S, H, hd = o.shape
    KV = v.shape[2]
    mean = v.to(torch.float32).sum(dim=1) * (1.0 / v.shape[1])         # [B, KV, hd]
    o[:, first:] = mean.repeat_interleave(H // KV, dim=1)[:, None].to(o.dtype)
    lse[:, :, first:] = ref.NEG_INF


def _fill(o, lse, v, first: int) -> None:
    """``flash_fill_no_key`` alone on rows ``first`` … S − 1 of o and lse, in
    place, as the C entry point launches it after a variant; counts
    nothing (a check times it and holds it against ``fill_no_key_ref``).
    CPU tensors take the plain version; CUDA tensors (contiguous, o 16-byte
    aligned) launch the kernel or raise."""
    if o.device.type == "cpu":
        fill_no_key_ref(o, lse, v, first)
        return
    B, S, H, hd = o.shape
    Skv, KV = v.shape[1], v.shape[2]
    if not (o.is_contiguous() and v.is_contiguous() and lse.is_contiguous()) \
            or o.dtype != v.dtype or lse.dtype != torch.float32 or lse.shape != (B, H, S) \
            or v.shape[0] != B or v.shape[3] != hd or H % KV:
        raise ValueError(f"flash_fill_no_key wants contiguous o [B, S, H, hd], fp32 lse "
                         f"[B, H, S] and v [B, Skv, KV, hd] of o's dtype; got "
                         f"{tuple(o.shape)}, {tuple(lse.shape)}, {tuple(v.shape)}")
    stream = torch.cuda.current_stream(o.device).cuda_stream
    err = _build.load().flash_attention_fill_no_key(
        int(o.dtype == torch.bfloat16), hd, v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S,
        H, Skv, KV, first, stream)
    _build.check(err, "flash_fill_no_key launch")


def attention_bwd(q, k, v, o, lse, do, causal: bool, window):
    """Gradients (dq, dk, dv) of attention given the forward's output o and
    per-row log-sum-exp ``lse [B, H, S]``, in plain tensor code: P =
    exp(s − lse) with the forward's masked scores s, D = rowsum(dO∘O),
    dS = P∘(dP − D), 0 where the mask is false (``jnp.where``'s gradient
    in the reference: a row with a valid key has P = exp(−1e30 − lse) = 0
    exactly there, a row without one is cut), dq = dS·k·hd^-½, dk =
    dSᵀ·q·hd^-½, dv =
    Pᵀ·dO — dk and dv summed over the G query heads that share a KV head.
    At a row with no valid key P is 1/Skv on every key (the reference's
    softmax of equal sentinels; exp(s − lse) would give 1, since lse =
    −1e30 there), so such a row adds dO/Skv to every key's dv and nothing
    to dq or dk.  fp32 throughout, each result in its input's dtype."""
    window = normalize_window(window)
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    f32 = torch.float32
    qg = ref._grouped_q(q, KV)                                  # scaled
    kf, vf = k.to(f32), v.to(f32)
    dog = do.reshape(B, S, KV, G, hd).to(f32)
    og = o.reshape(B, S, KV, G, hd).to(f32)
    s = torch.einsum("bskgh,bckh->bskgc", qg, kf)
    pos = lambda n: torch.arange(n, device=q.device)
    valid = ref._mask(pos(S), pos(Skv), causal, window)
    s = torch.where(valid[None, :, None, None, :], s, ref.NEG_INF)
    lse_g = lse.transpose(1, 2).reshape(B, S, KV, G)
    p = torch.exp(s - lse_g[..., None])
    first = no_key_rows(S, Skv, causal, window)
    if first is not None:           # the softmax of Skv equal sentinels
        p[:, first:] = 1.0 / Skv
    dv = torch.einsum("bskgc,bskgh->bckh", p, dog)
    dp = torch.einsum("bskgh,bckh->bskgc", dog, vf)
    D = (dog * og).sum(dim=-1, keepdim=True)
    ds = p * (dp - D)
    if first is not None:           # every key of these rows lies outside the mask
        ds[:, first:] = 0.0
    scale = hd ** -0.5
    dq = torch.einsum("bskgc,bckh->bskgh", ds, kf) * scale
    dk = torch.einsum("bskgc,bskgh->bckh", ds, qg)
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is K4 (on CUDA tensors; the plain version on
    CPU tensors) and whose backward is ``attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: [B, S, H, hd]; k/v: [B, Skv, KV, hd] -> [B, S, H, hd] in q's
    dtype, differentiable.  ``window`` None or negative means full."""
    return FlashAttention.apply(q, k, v, causal, normalize_window(window))
