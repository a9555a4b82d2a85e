"""Bucketed cross-worker averaging on the worker-batched executor,
counterpart of the ``wa=()`` half of ``repro.core.bucketing`` (the vmap
oracle's arithmetic: every reduction is over the leading worker axis).

The reference concatenates the window payload into one buffer per dtype
and reduces each buffer with one collective.  On one device a mean or a
sum over axis 0 is elementwise across the payload, so this module reduces
leaf by leaf: the same numbers without a concatenated copy of the payload
(gigabytes at stablelm-1.6b's width).  ``bucket_layout`` keeps the wire
layout itself — each dtype bucket's rows, offsets and sizes — for an
executor that ships the buckets between devices; its byte totals are
``coda.window_payload_by_dtype``.

Two payloads, as in the reference:

  * ``average_state`` — CoDA: every ``params`` leaf and every dual leaf
    (plus the pre-scaled sketch deltas when the sketch is on);
  * ``average_and_refresh`` — CODASCA: the fresh per-worker control
    variates ride the same buckets; their mean becomes the global variate
    ``cg_*`` and each worker keeps its own as ``cv_*``.

The masked (fault-tolerant) forms take the per-window fault vectors of
``core/faults.FaultPlan``: every row is pre-scaled by its worker's weight
u_k (exact: u is 0, 1 or a power of two), the rows are SUMMED in the
bucket's dtype, and the sum is divided once, in fp32, by Σu (a weight lane
that rides the f32 bucket: +4 bytes; CODASCA adds the participant count
Σm: +8).  A bf16 bucket therefore rounds twice, as the reference's does:
the fp32-accumulated sum to bf16, then the fp32 quotient to bf16.  After
the merge, ``resync`` picks per worker whether it adopts the merged state.

Every division here is a true division by a tensor on the data's device
(``div``): CUDA divides by a host scalar as a multiply by its reciprocal,
one ulp off the reference's quotient.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

F32 = torch.float32

# torch dtype → the short dtype tag of the reference's optimized-HLO shapes
DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
             torch.float64: "f64", torch.int8: "s8", torch.int32: "s32"}


def div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true division on every device (``d`` a number or a
    tensor on ``x``'s device)."""
    if not torch.is_tensor(d):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-worker [K] vector shaped to broadcast over ``like``'s rows."""
    return v.reshape((like.shape[0],) + (1,) * (like.dim() - 1))


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the worker axis in ``x``'s dtype, accumulated in fp32 and
    rounded once (``jnp.sum`` of a bf16 array)."""
    return torch.sum(x, dim=0, dtype=F32).to(x.dtype)


def mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis in ``x``'s dtype: the fp32 sum divided by
    K in fp32, rounded once (``jnp.mean``)."""
    return div(torch.sum(x, dim=0, dtype=F32), x.shape[0]).to(x.dtype)


# --------------------------------------------------------------------------
# the payload as rows
# --------------------------------------------------------------------------
def _state_mats(state):
    """The window payload as a list of [K, n_i] row views, in the
    reference's leaf order (dict keys sorted: dual leaves before params
    leaves), with what ``_unmats`` needs to rebuild the trees."""
    like = {"params": state["params"], "duals": state["duals"]}
    flat = tree_leaves(like)
    kloc = flat[0].shape[0]
    return [l.reshape(kloc, -1) for l in flat], (flat, like), kloc


def _unmats(meta, kloc, means):
    """Per-leaf reduced rows [n_i] back into a {"params", "duals"} pair,
    each cast to its leaf's dtype and broadcast to every worker."""
    flat, like = meta
    outs = [m.reshape(l.shape[1:]).to(l.dtype).expand(l.shape).contiguous()
            for l, m in zip(flat, means)]
    tree = tree_unflatten(like, outs)
    return tree["params"], tree["duals"]


def bucket_layout(state, *, masked: bool = False) -> dict[str, dict]:
    """The per-dtype wire buckets one worker ships in a window, in the
    reference's order: the state rows, then (CODASCA) the variate rows,
    then (masked) the f32 weight lanes, then the sketch rows.  Returns
    {dtype tag: {"elements", "bytes", "rows": [(name, offset, n)]}}; the
    bytes are ``coda.window_payload_by_dtype(state, masked=masked)``."""
    like = {"params": state["params"], "duals": state["duals"]}
    rows = [(f"state{p}", l) for p, l in zip(tree_paths(like), tree_leaves(like))]
    if "cv_params" in state:
        rows += [(f"variate{p}", l) for p, l in zip(tree_paths(like), tree_leaves(like))]
    kloc = rows[0][1].shape[0]
    if masked:
        lanes = 2 if "cv_params" in state else 1
        rows.append(("lanes", torch.empty((kloc, lanes), dtype=F32, device="meta")))
    if "sk_new" in state:
        sk = state["sk_new"]
        rows += [(f"sketch{p}", l) for p, l in zip(tree_paths(sk), tree_leaves(sk))]
    out: dict[str, dict] = {}
    for name, l in rows:
        n = l.numel() // kloc
        b = out.setdefault(DTYPE_TAG[l.dtype], {"elements": 0, "bytes": 0, "rows": []})
        b["rows"].append((name, b["elements"], n))
        b["elements"] += n
        b["bytes"] += n * l.element_size()
    return out


# --------------------------------------------------------------------------
# unmasked averaging
# --------------------------------------------------------------------------
def pmean_buckets(mats):
    """Per-dtype bucketed cross-worker MEAN of [K, n_i] rows → [n_i]."""
    return [mean0(m) for m in mats]


def psum_buckets(mats):
    """Per-dtype bucketed cross-worker SUM of [K, n_i] rows → [n_i] (the
    masked window's reduction)."""
    return [sum0(m) for m in mats]


def int8_quantize(xf, red_axes):
    """Max-abs int8 quantizer: per-tensor fp32 scale over ``red_axes``,
    payload in [-127, 127].  Empty ``red_axes`` gives each element its own
    scale, as ``jnp.max(axis=())`` does; ``torch.amax`` would reduce over
    every axis instead.  ``/ 127`` is a true division (``div``), as the
    reference's is."""
    absx = torch.abs(xf)
    scale = div(torch.amax(absx, dim=red_axes, keepdim=True) if red_axes else absx,
                127.0) + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_rows(m):
    """A [K, n] row block quantized per (worker, tensor), dequantized."""
    q, scale = int8_quantize(m.to(F32), (1,))
    return q.to(F32) * scale


def int8_average(mats):
    """Compressed averaging: per-(worker, tensor) max-abs fp32 scales, int8
    payload; the mean of the dequantized rows in each row block's dtype."""
    return [mean0(_int8_rows(m)).to(m.dtype) for m in mats]


def _sketch_mats(state, n_workers):
    """The sketch deltas (``sk_new``) as fp32 rows pre-scaled by the worker
    count K, so the bucket's MEAN is the exact count SUM (integer-valued
    fp32 numerators, integer quotients).  ([], None) when the sketch is
    off."""
    if "sk_new" not in state:
        return [], None
    if not n_workers:
        raise ValueError("averaging a state with a streaming-eval sketch "
                         "needs n_workers (the pre-scale that turns the "
                         "wire mean into the exact count sum)")
    flat = tree_leaves(state["sk_new"])
    kloc = flat[0].shape[0]
    mats = [(l.to(F32) * float(n_workers)).reshape(kloc, -1) for l in flat]
    return mats, (flat, state["sk_new"])


def _apply_sketch_sums(new, smeta, sums):
    """Fold the exact delta sums into the replicated accumulator, each
    worker's own delta into its local history, and reset the deltas."""
    flat, like = smeta
    delta = tree_unflatten(like, [s.reshape(l.shape[1:]) for s, l in zip(sums, flat)])
    new["sk_acc"] = {k: new["sk_acc"][k] + delta[k] for k in new["sk_acc"]}
    if "sk_loc" in new:
        new["sk_loc"] = {k: new["sk_loc"][k] + new["sk_new"][k] for k in new["sk_loc"]}
    new["sk_new"] = {k: torch.zeros_like(v) for k, v in new["sk_new"].items()}
    return new


def average_state(state, compress: str | None, *, n_workers: int | None = None):
    """Periodic model averaging (``coda.average``, CoDA's window end): the
    mean over the workers of every params and dual leaf, broadcast back,
    each leaf in its own dtype (a bf16 leaf summed in fp32 and rounded
    once, as ``jnp.mean`` rounds); ``compress="int8"`` averages each
    worker's int8-quantized rows.  The sketch deltas (which need
    ``n_workers``) ride the f32 bucket as exact count sums."""
    mats, meta, kloc = _state_mats(state)
    smats, smeta = _sketch_mats(state, n_workers)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = int8_average(mats)
    else:
        means = pmean_buckets(mats + smats)
    new = dict(state)
    new["params"], new["duals"] = _unmats(meta, kloc, means[:len(mats)])
    if smeta is not None:
        new = _apply_sketch_sums(new, smeta, means[len(mats):])
    return new


def average_and_refresh(state, cv_new, compress: str | None, *,
                        n_workers: int | None = None):
    """CODASCA's window end: average the state AND the fresh per-worker
    control variates ``cv_new`` ({"params", "duals"} in the wire dtypes) in
    the same buckets.  The state mean is broadcast back, the variate mean
    becomes ``cg_*``, and each worker keeps its own ``cv_new`` as ``cv_*``.

    Under int8 each worker stores its variates re-quantized by the wire's
    quantizer (locally), so ``cg == mean_k cv_k`` survives quantization and
    the K = 1 and homogeneous CODASCA ≡ CoDA equivalences hold."""
    mats, meta, kloc = _state_mats(state)
    cmats, cmeta, _ = _state_mats(cv_new)
    smats, smeta = _sketch_mats(state, n_workers)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = int8_average(mats + cmats)
        cmats = [_int8_rows(m).to(m.dtype) for m in cmats]
    else:
        means = pmean_buckets(mats + cmats + smats)
    n, nc = len(mats), len(cmats)
    new = dict(state)
    new["params"], new["duals"] = _unmats(meta, kloc, means[:n])
    if smeta is not None:
        new = _apply_sketch_sums(new, smeta, means[n + nc:])
    new["cg_params"], new["cg_duals"] = _unmats(cmeta, kloc, means[n:n + nc])
    flat, like = cmeta
    stored = tree_unflatten(like, [m.reshape(l.shape) for m, l in zip(cmats, flat)])
    new["cv_params"], new["cv_duals"] = stored["params"], stored["duals"]
    return new


# --------------------------------------------------------------------------
# masked (partial-participation) averaging
# --------------------------------------------------------------------------
def _masks(faults):
    u = faults["weights"].to(F32)
    r = faults["resync"].to(F32)
    return u, r, (u > 0).to(F32)


def _masked_sums(mats, w):
    """Rows pre-scaled by the per-worker weights ``w`` in their own dtype
    (exact: 0, 1 or a power of two), summed over the workers."""
    return psum_buckets([m * w.to(m.dtype)[:, None] for m in mats])


def _masked_sketch_mats(state, m):
    """The sketch deltas under the masked SUM: rows pre-scaled by the binary
    participation mask only, so participants' exact counts fold in and
    absent workers' deltas stay local until they next participate."""
    if "sk_new" not in state:
        return [], None
    flat = tree_leaves(state["sk_new"])
    kloc = flat[0].shape[0]
    return ([l.to(F32).reshape(kloc, -1) * m[:, None] for l in flat],
            (flat, state["sk_new"]))


def _apply_masked_sketch_sums(new, smeta, sums, m):
    """Fold the participants' delta sums into the accumulator and their own
    histories; reset only the participants' deltas (binary mask: exact)."""
    flat, like = smeta
    delta = tree_unflatten(like, [s.reshape(l.shape[1:]) for s, l in zip(sums, flat)])
    new["sk_acc"] = {k: new["sk_acc"][k] + delta[k] for k in new["sk_acc"]}
    if "sk_loc" in new:
        new["sk_loc"] = {k: new["sk_loc"][k] + new["sk_new"][k] * _col(m, new["sk_new"][k])
                         for k in new["sk_loc"]}
    keep = 1.0 - m
    new["sk_new"] = {k: v * _col(keep, v) for k, v in new["sk_new"].items()}
    return new


def _select_rows(meta, kloc, merged, take):
    """Rows with ``take > 0`` (participants and re-syncing workers) adopt
    the merged value cast to their dtype; rows with ``take == 0``
    (mid-straggle workers) keep their own iterate."""
    flat, like = meta
    outs = [torch.where(_col(take, l) > 0, v.to(l.dtype).reshape(l.shape[1:]), l)
            for l, v in zip(flat, merged)]
    tree = tree_unflatten(like, outs)
    return tree["params"], tree["duals"]


def masked_int8_average(mats, lane_idx, lanes):
    """``int8_average`` under partial participation: the same per-worker
    quantized rows (the weights never touch the int8 payload), weighted by
    the f32 lane ``lane_idx[i]`` of ``lanes`` [K, n_lanes] and divided by
    that lane's sum."""
    totals = torch.clamp_min(torch.sum(lanes, dim=0), 1.0)
    return [div(torch.sum(_int8_rows(m) * lanes[:, j:j + 1], dim=0), totals[j]).to(m.dtype)
            for m, j in zip(mats, lane_idx)]


def masked_average_state(state, faults, compress: str | None):
    """``average_state`` under partial participation: the exact u-weighted
    mean over the participants, adopted by every worker with
    ``max(m, resync) > 0``.  ``faults``: {"weights": [K] f32, "resync":
    [K] f32} from ``core.faults.FaultPlan.window`` on the state's device."""
    u, r, m = _masks(faults)
    mats, meta, kloc = _state_mats(state)
    smats, smeta = _masked_sketch_mats(state, m)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = masked_int8_average(mats, [0] * len(mats), u[:, None])
        ssums = []
    else:
        W = torch.clamp_min(torch.sum(u), 1.0)      # the weight lane's sum
        means = [div(s.to(F32), W) for s in _masked_sums(mats, u)]
        ssums = psum_buckets(smats)
    new = dict(state)
    new["params"], new["duals"] = _select_rows(meta, kloc, means, torch.maximum(m, r))
    if smeta is not None:
        new = _apply_masked_sketch_sums(new, smeta, ssums, m)
    return new


def masked_average_and_refresh(state, cv_new, faults, compress: str | None):
    """``average_and_refresh`` under partial participation: the state merges
    over the weights u as in ``masked_average_state``; the variates refresh
    over the participants only (rows pre-scaled by the binary mask m,
    divided by P = Σm), so ``cg`` is the exact participant mean; each
    participant stores its fresh variate (re-quantized under int8) and an
    absent worker keeps its old ``c_k``."""
    u, r, m = _masks(faults)
    mats, meta, kloc = _state_mats(state)
    cmats, cmeta, _ = _state_mats(cv_new)
    smats, smeta = _masked_sketch_mats(state, m)
    n = len(mats)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        all_means = masked_int8_average(mats + cmats, [0] * n + [1] * len(cmats),
                                        torch.stack([u, m], dim=1))
        means, cmeans = all_means[:n], all_means[n:]
        cmats = [_int8_rows(mt).to(mt.dtype) for mt in cmats]
        ssums = []
    else:
        W = torch.clamp_min(torch.sum(u), 1.0)
        P = torch.clamp_min(torch.sum(m), 1.0)
        means = [div(s.to(F32), W) for s in _masked_sums(mats, u)]
        cmeans = [div(s.to(F32), P) for s in _masked_sums(cmats, m)]
        ssums = psum_buckets(smats)
    new = dict(state)
    new["params"], new["duals"] = _select_rows(meta, kloc, means, torch.maximum(m, r))
    if smeta is not None:
        new = _apply_masked_sketch_sums(new, smeta, ssums, m)
    new["cg_params"], new["cg_duals"] = _unmats(cmeta, kloc, cmeans)
    # c_k ← the fresh variate for participants, unchanged for absent workers
    flat, like = cmeta
    old = tree_leaves({"params": state["cv_params"], "duals": state["cv_duals"]})
    cv = tree_unflatten(like, [torch.where(_col(m, o) > 0, f.reshape(o.shape).to(o.dtype), o)
                               for f, o in zip(cmats, old)])
    new["cv_params"], new["cv_duals"] = cv["params"], cv["duals"]
    return new
