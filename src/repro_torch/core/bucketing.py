"""Bucketed cross-worker averaging shared by the executors, counterpart
of ``repro.core.bucketing``.

Every reduction first runs over the rank's own worker rows (the leading
axis), leaf by leaf: a mean or a sum over that axis is elementwise across
the payload, so the worker-batched executor (``wa=None``: every worker on
this device) needs no concatenated copy of the payload (gigabytes at
stablelm-1.6b's width).  The sharded executor passes ``wa``, a ``Wire``
over the process group of the ranks that hold the other workers: the
local partials are then concatenated into one flat buffer per dtype, in
``bucket_layout``'s order, and reduced across ranks with ONE collective
per dtype bucket — ``all_reduce`` for the mean and the masked sum, an s8 +
f32 ``all_gather`` pair for int8, or (``ring``) C chunked rings of
point-to-point hops, each hop a ``batch_isend_irecv`` pair in the
reference's hop order, so the ring's sums are added in the reference's
order.  ``bucket_layout``'s byte totals are
``coda.window_payload_by_dtype``.  Every collective is counted by kind in
``collectives`` (calls and bytes), and each call in ``wire_log`` (its kind,
dtype tag and bytes, in order), both zeroed by ``zero_collectives``.

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

import dataclasses

import torch
import torch.distributed as dist

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
# the wire: every collective the averaging issues, counted
# --------------------------------------------------------------------------
# calls and bytes (each rank's operand) by kind: the window's all_reduce and
# all_gather, the ring's point-to-point hops (p2p), and the host read-outs
# that are no part of a window (readout: the losses fit reports, a
# checkpoint's state)
collectives: dict[str, dict[str, int]] = {}
# every counted call, in order: (kind, dtype tag, bytes of this rank's operand)
wire_log: list[tuple[str, str, int]] = []


def zero_collectives() -> None:
    collectives.clear()
    wire_log.clear()
    collectives.update({k: {"calls": 0, "bytes": 0}
                        for k in ("all_reduce", "all_gather", "p2p", "readout")})


zero_collectives()


def _count(kind: str, t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    collectives[kind]["calls"] += 1
    collectives[kind]["bytes"] += n
    wire_log.append((kind, DTYPE_TAG.get(t.dtype, str(t.dtype)), n))


# ``all_gather_into_tensor`` is ``all_gather_single`` in newer torch
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Wire:
    """The worker mesh axes of one rank (the reference's ``wa``): a process
    group over the ranks whose rows together make all K workers, ordered
    as the workers are.  ``index`` is this rank's place in it."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_group_rank(group, dist.get_rank())
        self._next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self._prev = dist.get_global_rank(group, (self.index - 1) % self.size)

    def all_reduce(self, buf: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks, in place."""
        _count("all_reduce", buf)
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_gather(self, buf: torch.Tensor, kind: str = "all_gather") -> torch.Tensor:
        """Every rank's [rows, ...] block stacked in rank order."""
        buf = buf.contiguous()
        _count(kind, buf)
        out = buf.new_empty((self.size * buf.shape[0],) + tuple(buf.shape[1:]))
        _all_gather_single(out, buf, group=self.group)
        return out

    def hop(self, send: torch.Tensor) -> torch.Tensor:
        """One ring hop (the reference's ``ppermute`` i → i+1): send to the
        next rank, receive the previous rank's tensor."""
        send = send.contiguous()
        _count("p2p", send)
        recv = torch.empty_like(send)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, self._next, self.group),
                dist.P2POp(dist.irecv, recv, self._prev, self.group)]):
            req.wait()
        return recv


def _by_dtype(vecs) -> dict:
    """Indices of ``vecs`` grouped by dtype, in order of first appearance
    (the reference's bucket order)."""
    out: dict = {}
    for i, v in enumerate(vecs):
        out.setdefault(v.dtype, []).append(i)
    return out


def _wire_buckets(vecs, reduce):
    """Concatenate the per-leaf partials into one flat buffer per dtype,
    ``reduce`` each buffer (one collective), and split it back."""
    out = [None] * len(vecs)
    for idxs in _by_dtype(vecs).values():
        flat = reduce(torch.cat([vecs[i] for i in idxs]))
        for i, piece in zip(idxs, flat.split([vecs[i].numel() for i in idxs])):
            out[i] = piece
    return out


# --------------------------------------------------------------------------
# overlapped (ring) averaging
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RingSpec:
    """How to run a cross-worker reduction as point-to-point rings over one
    mesh axis: ``size``, its extent; ``chunks``, C, the independent ring
    chains each dtype bucket is split into; ``wire``, the axis's process
    group, which the hops go through (none is needed to count them)."""
    size: int
    chunks: int
    wire: Wire | None = None

    def __post_init__(self):
        if self.size < 1 or self.chunks < 1:
            raise ValueError(f"bad RingSpec {self}")


def _n_chunks(n: int, ring: RingSpec) -> int:
    """Chunks actually used for an n-element bucket: each chunk must hold at
    least one element per ring shard."""
    return max(1, min(ring.chunks, n // max(ring.size, 1) or 1))


def _chunk_offsets(n: int, c: int) -> list[int]:
    """c+1 split points tiling [0, n) into c chunks whose sizes differ by at
    most one (the first n % c chunks get the extra element)."""
    base, rem = divmod(n, c)
    offs = [0]
    for i in range(c):
        offs.append(offs[-1] + base + (1 if i < rem else 0))
    return offs


def ring_chain_count(sizes: dict, ring: RingSpec) -> int:
    """Independent hop chains one ring averaging forms: one per chunk per
    dtype bucket (``sizes``: elements per bucket)."""
    if ring.size == 1:
        return 0
    return sum(_n_chunks(n, ring) for n in sizes.values())


def ring_hop_count(sizes: dict, ring: RingSpec) -> int:
    """Hops one ring averaging makes on each rank: per chain 2·(R−1)
    (reduce-scatter, then all-gather)."""
    return ring_chain_count(sizes, ring) * 2 * (ring.size - 1)


def _ring_chunk_sum(chunk: torch.Tensor, ring: RingSpec) -> torch.Tensor:
    """The sum of a [m] chunk over the ring, the reference's hop for hop:
    reduce-scatter (R−1 hops; at hop t rank i forwards its partial of
    shard i−t+1 and folds its own shard into the one it receives), then
    all-gather (R−1 more hops around the same ring)."""
    R, idx = ring.size, ring.wire.index
    m = chunk.shape[0]
    s = -(-m // R)                       # ring shard length (padded)
    shards = chunk.new_zeros((R * s,))
    shards[:m] = chunk
    shards = shards.view(R, s)
    send = shards[(idx + 1) % R]
    for t in range(R - 1):
        send = shards[(idx - t) % R] + ring.wire.hop(send)
    own = (idx - (R - 2)) % R
    out = chunk.new_zeros((R, s))
    out[own] = send
    cur = send
    for t in range(R - 1):
        cur = ring.wire.hop(cur)
        out[(own - 1 - t) % R] = cur
    return out.view(-1)[:m]


def _ring_buckets(mats, ring: RingSpec, *, mean: bool):
    """Per-dtype bucket reduction as chunked rings: the local reduction over
    the rank's rows, then C independent reduce-scatter/all-gather chains a
    bucket (sizes differ by at most one, never 0).  ``mean`` divides each
    chunk's sum by the ring size; else the raw sum (the masked path divides
    by the on-wire weight sum instead)."""
    red = [mean0(m) if mean else sum0(m) for m in mats]
    if ring.size == 1:
        return red                       # degenerate: no wire

    def reduce(flat):
        offs = _chunk_offsets(flat.numel(), _n_chunks(flat.numel(), ring))
        sums = [_ring_chunk_sum(flat[lo:hi], ring) for lo, hi in zip(offs[:-1], offs[1:])]
        return torch.cat([div(x, ring.size) for x in sums] if mean else sums)
    return _wire_buckets(red, reduce)


def ring_mean_buckets(mats, ring: RingSpec):
    """``pmean_buckets`` semantics as chunked rings."""
    return _ring_buckets(mats, ring, mean=True)


def ring_sum_buckets(mats, ring: RingSpec):
    """``psum_buckets`` semantics as chunked rings (the masked overlapped
    path: rows arrive pre-scaled, the weight lanes ride the f32 bucket)."""
    return _ring_buckets(mats, ring, mean=False)


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
def _reduce_buckets(mats, wa, *, mean: bool):
    """Reduce the [K_loc, n_i] row blocks over every worker: over this
    rank's rows, then (``wa``) across the ranks with one all_reduce per
    dtype bucket.  Returns [n_i] vectors."""
    red = [mean0(m) if mean else sum0(m) for m in mats]
    if wa is None:
        return red
    return _wire_buckets(red, lambda flat: div(wa.all_reduce(flat), wa.size) if mean
                         else wa.all_reduce(flat))


def pmean_buckets(mats, wa: Wire | None = None):
    """Per-dtype bucketed cross-worker MEAN of [K_loc, n_i] rows → [n_i]."""
    return _reduce_buckets(mats, wa, mean=True)


def psum_buckets(mats, wa: Wire | None = None):
    """Per-dtype bucketed cross-worker SUM of [K_loc, n_i] rows → [n_i]
    (the masked window's reduction)."""
    return _reduce_buckets(mats, wa, mean=False)


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


def _int8_gather(mats, wa, lanes=None):
    """Every worker's [n_i] rows quantized per (worker, tensor) and
    dequantized: with ``wa``, the s8 payload and the f32 scales (with the
    weight ``lanes`` after them) cross the wire as one all_gather each.
    Returns the dequantized [K, n_i] blocks and the [K, n_lanes] lanes."""
    qs, scales = zip(*(int8_quantize(m.to(F32), (1,)) for m in mats))
    if wa is not None:
        q = wa.all_gather(torch.cat(qs, dim=1))
        s = wa.all_gather(torch.cat(list(scales) + ([] if lanes is None else [lanes]), dim=1))
        qs = q.split([m.shape[1] for m in mats], dim=1)
        scales = s[:, :len(mats)].split(1, dim=1)
        lanes = None if lanes is None else s[:, len(mats):]
    return [q.to(F32) * s for q, s in zip(qs, scales)], lanes


def int8_average(mats, wa: Wire | None = None):
    """Compressed averaging: per-(worker, tensor) max-abs fp32 scales, int8
    payload; the mean over all K workers of the dequantized rows, in each
    row block's dtype, on every rank."""
    deq, _ = _int8_gather(mats, wa)
    return [mean0(d).to(m.dtype) for d, m in zip(deq, mats)]


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


def _no_ring_int8(ring, compress):
    if ring is not None and compress:
        raise ValueError("ring averaging does not support compressed buckets")


def _mean_buckets(mats, wa, ring):
    """The window's one collective per dtype bucket of the means: by
    all_reduce, or by rings."""
    return ring_mean_buckets(mats, ring) if ring is not None else pmean_buckets(mats, wa)


def _sum_buckets(mats, wa, ring):
    """The masked window's one collective per dtype bucket of the sums of
    the pre-scaled rows and the weight lanes: by all_reduce, or by rings."""
    return ring_sum_buckets(mats, ring) if ring is not None else psum_buckets(mats, wa)


def average_state(state, compress: str | None, *, wa: Wire | None = None,
                  ring: RingSpec | None = None, n_workers: int | None = None):
    """Periodic model averaging (``coda.average``, CoDA's window end): the
    mean over the workers of every params and dual leaf, broadcast back,
    each leaf in its own dtype (a bf16 leaf summed in fp32 and rounded
    once, as ``jnp.mean`` rounds); ``compress="int8"`` averages each
    worker's int8-quantized rows.  The sketch deltas (which need
    ``n_workers``) ride the f32 bucket as exact count sums.  ``wa`` /
    ``ring``: across ranks, by all_reduce or by rings."""
    _no_ring_int8(ring, compress)
    mats, meta, kloc = _state_mats(state)
    smats, smeta = _sketch_mats(state, n_workers)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = int8_average(mats, wa)
    else:
        means = _mean_buckets(mats + smats, wa, ring)
    new = dict(state)
    new["params"], new["duals"] = _unmats(meta, kloc, means[:len(mats)])
    if smeta is not None:
        new = _apply_sketch_sums(new, smeta, means[len(mats):])
    return new


def average_and_refresh(state, cv_new, compress: str | None, *, wa: Wire | None = None,
                        ring: RingSpec | None = None, n_workers: int | None = None):
    """CODASCA's window end: average the state AND the fresh per-worker
    control variates ``cv_new`` ({"params", "duals"} in the wire dtypes) in
    the same buckets.  The state mean is broadcast back, the variate mean
    becomes ``cg_*``, and each worker keeps its own ``cv_new`` as ``cv_*``.

    Under int8 each worker stores its variates re-quantized by the wire's
    quantizer (locally), so ``cg == mean_k cv_k`` survives quantization and
    the K = 1 and homogeneous CODASCA ≡ CoDA equivalences hold."""
    _no_ring_int8(ring, compress)
    mats, meta, kloc = _state_mats(state)
    cmats, cmeta, _ = _state_mats(cv_new)
    smats, smeta = _sketch_mats(state, n_workers)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = int8_average(mats + cmats, wa)
        cmats = [_int8_rows(m).to(m.dtype) for m in cmats]
    else:
        means = _mean_buckets(mats + cmats + smats, wa, ring)
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


def _scaled(mats, w):
    """Rows pre-scaled by the per-worker weights ``w`` in their own dtype
    (exact: 0, 1 or a power of two)."""
    return [m * w.to(m.dtype)[:, None] for m in mats]


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


def masked_int8_average(mats, lane_idx, lanes, wa: Wire | None = None):
    """``int8_average`` under partial participation: the same per-worker
    quantized rows (the weights never touch the int8 payload), weighted by
    the f32 lane ``lane_idx[i]`` of ``lanes`` [K_loc, n_lanes] and divided by
    that lane's sum.  With ``wa`` the lanes ride the scales' all_gather."""
    deq, lanes = _int8_gather(mats, wa, lanes)
    totals = torch.clamp_min(torch.sum(lanes, dim=0), 1.0)
    return [div(torch.sum(d * lanes[:, j:j + 1], dim=0), totals[j]).to(m.dtype)
            for d, m, j in zip(deq, mats, lane_idx)]


def masked_average_state(state, faults, compress: str | None, *, wa: Wire | None = None,
                         ring: RingSpec | None = None):
    """``average_state`` under partial participation: the exact u-weighted
    mean over the participants, adopted by every worker with
    ``max(m, resync) > 0``.  ``faults``: {"weights": [K_loc] f32, "resync":
    [K_loc] f32} from ``core.faults.FaultPlan.window`` on the state's
    device, cut to the rank's workers.  The weight lane Σu rides the f32
    bucket (or the int8 pair's scales)."""
    _no_ring_int8(ring, compress)
    u, r, m = _masks(faults)
    mats, meta, kloc = _state_mats(state)
    smats, smeta = _masked_sketch_mats(state, m)
    n = len(mats)
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        means = masked_int8_average(mats, [0] * n, u[:, None], wa)
        ssums = []
    else:
        sums = _sum_buckets(_scaled(mats, u) + [u[:, None]] + smats, wa, ring)
        W = torch.clamp_min(sums[n][0], 1.0)
        means = [div(s.to(F32), W) for s in sums[:n]]
        ssums = sums[n + 1:]
    new = dict(state)
    new["params"], new["duals"] = _select_rows(meta, kloc, means, torch.maximum(m, r))
    if smeta is not None:
        new = _apply_masked_sketch_sums(new, smeta, ssums, m)
    return new


def masked_average_and_refresh(state, cv_new, faults, compress: str | None, *,
                               wa: Wire | None = None, ring: RingSpec | None = None):
    """``average_and_refresh`` under partial participation: the state merges
    over the weights u as in ``masked_average_state``; the variates refresh
    over the participants only (rows pre-scaled by the binary mask m,
    divided by P = Σm, a second lane), so ``cg`` is the exact participant
    mean; each participant stores its fresh variate (re-quantized under
    int8) and an absent worker keeps its old ``c_k``."""
    _no_ring_int8(ring, compress)
    u, r, m = _masks(faults)
    mats, meta, kloc = _state_mats(state)
    cmats, cmeta, _ = _state_mats(cv_new)
    smats, smeta = _masked_sketch_mats(state, m)
    n, nc = len(mats), len(cmats)
    lanes = torch.stack([u, m], dim=1)           # [K_loc, 2] f32
    if compress == "int8":
        if smats:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        all_means = masked_int8_average(mats + cmats, [0] * n + [1] * nc, lanes, wa)
        means, cmeans = all_means[:n], all_means[n:]
        cmats = [_int8_rows(mt).to(mt.dtype) for mt in cmats]
        ssums = []
    else:
        sums = _sum_buckets(_scaled(mats, u) + _scaled(cmats, m) + [lanes] + smats, wa, ring)
        W = torch.clamp_min(sums[n + nc][0], 1.0)
        P = torch.clamp_min(sums[n + nc][1], 1.0)
        means = [div(s.to(F32), W) for s in sums[:n]]
        cmeans = [div(s.to(F32), P) for s in sums[n:n + nc]]
        ssums = sums[n + nc + 1:]
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
