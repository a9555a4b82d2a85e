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
dtype tag, bytes and ring chain, in order), both zeroed by
``zero_collectives``.

An averaging is a ``Plan``: the rows it reduces and, per averaged leaf, a
finish that makes the leaf from the reduced rows it needs.  ``Plan.run``
reduces and finishes at once; ``PendingAverage`` runs a ring plan's
independent units (a chunk's chain of hops; at R = 1 a row's local mean)
beside the next window's local steps, each leaf finished after its last
unit, and the next window waits per leaf where it first reads one (the
overlapped pair of ``core/coda_sharded.py``).  A plan made with
``inplace=True`` (a donating executor's window) writes each averaged leaf,
and each entry it makes without a reduction, into the state's own leaf
instead of a new tensor: every finish computes its outputs before it
writes them, and reads no leaf another finish writes, so the bits are
those of the out-of-place plan.

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

import contextlib
import dataclasses
import functools
import threading
import time
from collections.abc import Callable

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import copy_into, tree_leaves, tree_paths, tree_unflatten

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
# every counted call, in order: (kind, dtype tag, bytes of this rank's
# operand, the ring chain a hop belongs to or None)
wire_log: list[tuple[str, str, int, str | None]] = []
# an overlapped pair's schedule on the host (``PendingAverage``), in order:
# ("issue", unit) as the first averaging hands a unit to its stream or
# thread, ("step", i) as the second window starts local step i with leaves
# pending, ("compute", op) for each matmul-bearing op it then dispatches,
# ("wait", unit) where it first waits on a unit, ("done", unit) as the gloo
# thread completes one; each with the host's ``time.perf_counter()``
overlap_log: list[tuple[str, str, float]] = []
_ring_serial = [0]          # ring reductions since the last zeroing: chain tags


def zero_collectives() -> None:
    collectives.clear()
    wire_log.clear()
    overlap_log.clear()
    _ring_serial[0] = 0
    collectives.update({k: {"calls": 0, "bytes": 0}
                        for k in ("all_reduce", "all_gather", "p2p", "readout")})


zero_collectives()


def _count(kind: str, t: torch.Tensor, chain: str | None = None) -> None:
    n = t.numel() * t.element_size()
    collectives[kind]["calls"] += 1
    collectives[kind]["bytes"] += n
    wire_log.append((kind, DTYPE_TAG.get(t.dtype, str(t.dtype)), n, chain))


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

    def hop(self, send: torch.Tensor, chain: str | None = None) -> torch.Tensor:
        """One ring hop (the reference's ``ppermute`` i → i+1) of ring chain
        ``chain``: send to the next rank, receive the previous rank's
        tensor."""
        send = send.contiguous()
        _count("p2p", send, chain)
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


def bucket_sizes(mats) -> dict:
    """Elements per dtype bucket of [K, n_i] row blocks, in the reference's
    bucket order (``repro.core.bucketing.bucket_sizes``): the ring's and the
    all_reduce's payload layout, {dtype: Σ n_i}."""
    return {dt: sum(mats[i].shape[1] for i in idxs) for dt, idxs in _by_dtype(mats).items()}


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


def _ring_chunk_sum(chunk: torch.Tensor, ring: RingSpec, chain: str) -> torch.Tensor:
    """The sum of a [m] chunk over the ring, the reference's hop for hop:
    reduce-scatter (R−1 hops; at hop t rank i forwards its partial of
    shard i−t+1 and folds its own shard into the one it receives), then
    all-gather (R−1 more hops around the same ring).  Every hop is logged
    under ``chain``."""
    R, idx = ring.size, ring.wire.index
    m = chunk.shape[0]
    s = -(-m // R)                       # ring shard length (padded)
    shards = chunk.new_zeros((R * s,))
    shards[:m] = chunk
    shards = shards.view(R, s)
    send = shards[(idx + 1) % R]
    for t in range(R - 1):
        send = shards[(idx - t) % R] + ring.wire.hop(send, chain)
    own = (idx - (R - 2)) % R
    out = chunk.new_zeros((R, s))
    out[own] = send
    cur = send
    for t in range(R - 1):
        cur = ring.wire.hop(cur, chain)
        out[(own - 1 - t) % R] = cur
    return out.view(-1)[:m]


@dataclasses.dataclass(frozen=True)
class _Unit:
    """One independent piece of a ring reduction: at R > 1 the chain of
    hops of one chunk, ``[lo, hi)`` of dtype bucket ``bucket``'s flat
    buffer; at R = 1 the local reduction of one row block.  ``rows``: the
    row blocks it covers, whole or in part."""
    tag: str
    rows: tuple
    bucket: int = -1
    lo: int = 0
    hi: int = 0


class _RingReduction:
    """A per-dtype bucket reduction of [K_loc, n_i] row blocks as chunked
    rings, run unit by unit (``run``) so that a caller can finish what each
    unit completes.  At R > 1: the local reduction over the rank's rows and
    the flat buffer of a bucket (before its first unit), then C independent
    reduce-scatter/all-gather chains a bucket (sizes differ by at most one,
    never 0).  At R = 1 there is no wire: a unit is one row block's local
    reduction.  ``mean`` divides each chunk's sum by the ring size; else
    the raw sum (the masked path divides by the on-wire weight sum).
    ``reduced(i)``: row block i's [n_i] result once its units have run."""

    def __init__(self, rows, ring: RingSpec, *, mean: bool):
        self.rows, self.ring, self.mean = list(rows), ring, mean
        serial = _ring_serial[0] = _ring_serial[0] + 1
        self.units: list[_Unit] = []
        if ring.size == 1:
            self.units = [_Unit(f"a{serial}/row{i}", (i,)) for i in range(len(self.rows))]
            self._out = [None] * len(self.rows)
            return
        self._buckets, self._at = [], {}
        totals = bucket_sizes(self.rows)
        for b, (dt, idxs) in enumerate(_by_dtype(self.rows).items()):
            sizes = [self.rows[i].shape[1] for i in idxs]
            starts = [sum(sizes[:k]) for k in range(len(idxs))]
            self._buckets.append(idxs)
            for i, st, n in zip(idxs, starts, sizes):
                self._at[i] = (b, st, n)
            n = totals[dt]
            offs = _chunk_offsets(n, _n_chunks(n, ring))
            tag = DTYPE_TAG[dt]
            for c, (lo, hi) in enumerate(zip(offs[:-1], offs[1:])):
                cover = tuple(i for i, st, m in zip(idxs, starts, sizes) if st < hi and st + m > lo)
                self.units.append(_Unit(f"a{serial}/{tag}/c{c}", cover, b, lo, hi))
        self._flat = [None] * len(self._buckets)
        self._out = [None] * len(self._buckets)
        self._left = [sum(1 for u in self.units if u.bucket == b)
                      for b in range(len(self._buckets))]

    def _local(self, i):
        return mean0(self.rows[i]) if self.mean else sum0(self.rows[i])

    def run(self, u: _Unit) -> None:
        if self.ring.size == 1:
            self._out[u.rows[0]] = self._local(u.rows[0])
            return
        b = u.bucket
        if self._out[b] is None:
            self._flat[b] = torch.cat([self._local(i) for i in self._buckets[b]])
            self._out[b] = torch.empty_like(self._flat[b])
        s = _ring_chunk_sum(self._flat[b][u.lo:u.hi], self.ring, u.tag)
        self._out[b][u.lo:u.hi] = div(s, self.ring.size) if self.mean else s
        self._left[b] -= 1
        if not self._left[b]:
            self._flat[b] = None         # the bucket's last chain has run

    def reduced(self, i: int) -> torch.Tensor:
        if self.ring.size == 1:
            return self._out[i]
        b, st, n = self._at[i]
        return self._out[b][st:st + n]


def _ring_buckets(mats, ring: RingSpec, *, mean: bool):
    """Every unit of a ring reduction in order, then each row's result."""
    rr = _RingReduction(mats, ring, mean=mean)
    for u in rr.units:
        rr.run(u)
    return [rr.reduced(i) for i in range(len(mats))]


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
    fp32 numerators, integer quotients).  [] when the sketch is off."""
    if "sk_new" not in state:
        return []
    if not n_workers:
        raise ValueError("averaging a state with a streaming-eval sketch "
                         "needs n_workers (the pre-scale that turns the "
                         "wire mean into the exact count sum)")
    flat = tree_leaves(state["sk_new"])
    kloc = flat[0].shape[0]
    return [(l.to(F32) * float(n_workers)).reshape(kloc, -1) for l in flat]



def _no_ring_int8(ring, compress):
    if ring is not None and compress:
        raise ValueError("ring averaging does not support compressed buckets")



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
        return []
    flat = tree_leaves(state["sk_new"])
    kloc = flat[0].shape[0]
    return [l.to(F32).reshape(kloc, -1) * m[:, None] for l in flat]


def masked_int8_average(mats, lane_idx, lanes, wa: Wire | None = None):
    """``int8_average`` under partial participation: the same per-worker
    quantized rows (the weights never touch the int8 payload), weighted by
    the f32 lane ``lane_idx[i]`` of ``lanes`` [K_loc, n_lanes] and divided by
    that lane's sum.  With ``wa`` the lanes ride the scales' all_gather."""
    deq, lanes = _int8_gather(mats, wa, lanes)
    totals = torch.clamp_min(torch.sum(lanes, dim=0), 1.0)
    return [div(torch.sum(d * lanes[:, j:j + 1], dim=0), totals[j]).to(m.dtype)
            for d, m, j in zip(deq, mats, lane_idx)]



# --------------------------------------------------------------------------
# an averaging as a plan: the rows it reduces, and the finishes that make
# each averaged leaf from the reduced rows it needs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Finish:
    """Leaves of the averaged state, each ``(state key, leaf index)``, and
    ``fn(get)`` making them from the reduced rows ``needs`` (``get(i)``:
    row i's reduced vector)."""
    outs: list
    needs: tuple
    fn: Callable


@dataclasses.dataclass
class Plan:
    """One window averaging.  ``rows``: the [K_loc, n_i] row blocks that
    cross the wire, in ``bucket_layout``'s order; ``reduce(rows)``: their
    reduction over every worker (blocking); ``ring`` and ``mean``: the same
    reduction as ring units, which ``PendingAverage`` runs beside the next
    window (None when the averaging has no ring form: all_reduce, int8);
    ``finishes``: every averaged leaf; ``local``: the top-level entries of
    the new state that need no reduced row; ``inplace``: both written into
    the state's leaves."""
    state: dict
    rows: list
    reduce: Callable
    finishes: list
    local: dict
    ring: RingSpec | None = None
    mean: bool = True
    inplace: bool = False
    _leaves: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def slots(self) -> dict:
        """An empty leaf list for every state key a finish writes."""
        keys = {k for f in self.finishes for k, _ in f.outs}
        return {k: [None] * len(tree_leaves(self.state[k])) for k in keys}

    def leaf(self, k: str, i: int) -> torch.Tensor:
        """Leaf i of the state's entry ``k`` (the in-place destination)."""
        if k not in self._leaves:
            self._leaves[k] = tree_leaves(self.state[k])
        return self._leaves[k][i]

    def assemble(self, slots: dict) -> dict:
        new = dict(self.state)
        for k, tree in self.local.items():
            new[k] = copy_into(self.state[k], tree) if self.inplace else tree
        for k, leaves in slots.items():
            new[k] = tree_unflatten(self.state[k], leaves)
        return new

    def run(self) -> dict:
        """The averaging, blocking: reduce, then every finish."""
        red = self.reduce(self.rows)
        slots = self.slots()
        for f in self.finishes:
            for (k, i), t in zip(f.outs, f.fn(red.__getitem__)):
                slots[k][i] = self.leaf(k, i).copy_(t) if self.inplace else t.contiguous()
        return self.assemble(slots)


def _outs(like, prefix: str = "") -> list:
    """(state key, leaf index) of each leaf of a {"params", "duals"} tree,
    in ``tree_leaves`` order."""
    return [(prefix + k, i) for k in sorted(like) for i in range(len(tree_leaves(like[k])))]


def _bcast(v, shape, dtype):
    """A reduced [n_i] row cast to the leaf's dtype, on every worker."""
    return v.reshape(shape[1:]).to(dtype).expand(shape)


def _fin_mean(get, *, row, lane, col, shape, dtype):
    """A leaf every worker adopts: the row's mean (the masked path: the
    weighted sum over the lane's total, in fp32)."""
    v = get(row)
    if lane is not None:
        v = div(v.to(F32), torch.clamp_min(get(lane)[col], 1.0))
    return [_bcast(v, shape, dtype)]


def _fin_select(get, *, row, lane, old, take):
    """A masked state leaf: the weighted mean over the participants (the
    int8 pair: already divided), adopted by the rows with ``take > 0``;
    the others keep their own iterate."""
    v = get(row)
    if lane is not None:
        v = div(v.to(F32), torch.clamp_min(get(lane)[0], 1.0))
    return [torch.where(_col(take, old) > 0, v.to(old.dtype).reshape(old.shape[1:]), old)]


def _fin_sketch(get, *, row, acc):
    """The replicated count accumulator plus the exact delta sums."""
    return [acc + get(row).reshape(acc.shape[1:])]


def _fin_momentum(get, *, inner, xs, m, beta):
    """Server momentum on the averaged iterate (CODASCA's server update)

        m ← β·m + (x̄ − x_start),    x ← x_start + m

    in fp32, where x_start is the synced iterate the window started from:
    the leaf's averaged value, then its momentum buffer (``srv_m``, a
    function of synced iterates, so replicated and never shipped)."""
    xb = inner(get)[0]
    m = beta * m + (xb.to(F32) - xs.to(F32))
    return [(xs.to(F32) + m).to(xb.dtype), m]


def _with_momentum(plan: Plan, start_params, beta: float) -> Plan:
    """``plan`` with server momentum folded into each params leaf's finish."""
    xs, ms = tree_leaves(start_params), tree_leaves(plan.state["srv_m"])
    fins = []
    for f in plan.finishes:
        (k, i), = f.outs
        if k == "params":
            f = _Finish([(k, i), ("srv_m", i)], f.needs, functools.partial(
                _fin_momentum, inner=f.fn, xs=xs[i], m=ms[i], beta=beta))
        fins.append(f)
    return dataclasses.replace(plan, finishes=fins)


def _sketch_finishes(state, first_row: int) -> list:
    """``sk_acc`` leaf i from reduced row ``first_row + i`` (the sketch rows
    follow ``sk_new``'s leaves, as ``sk_acc``'s do)."""
    return [_Finish([("sk_acc", i)], (first_row + i,),
                    functools.partial(_fin_sketch, row=first_row + i, acc=a))
            for i, a in enumerate(tree_leaves(state["sk_acc"]))]


def _reducer(compress, wa, ring, *, mean: bool):
    if compress == "int8":
        return functools.partial(int8_average, wa=wa)
    if ring is not None:
        return functools.partial(_ring_buckets, ring=ring, mean=mean)
    return functools.partial(_reduce_buckets, wa=wa, mean=mean)


def average_plan(state, cv_new, compress: str | None, *, wa: Wire | None = None,
                 ring: RingSpec | None = None, n_workers: int | None = None,
                 momentum=None, inplace: bool = False) -> Plan:
    """The plan of ``average_state`` (``cv_new`` None) or of
    ``average_and_refresh``; ``momentum``: (the window's start params, β)
    for server momentum."""
    _no_ring_int8(ring, compress)
    mats, (flat, like), _ = _state_mats(state)
    fins = [_Finish([o], (j,), functools.partial(_fin_mean, row=j, lane=None, col=0,
                                                  shape=l.shape, dtype=l.dtype))
            for j, (o, l) in enumerate(zip(_outs(like), flat))]
    rows, local = list(mats), {}
    if cv_new is not None:
        cmats, (cflat, clike), _ = _state_mats(cv_new)
        n = len(rows)
        fins += [_Finish([o], (n + j,), functools.partial(_fin_mean, row=n + j, lane=None,
                                                           col=0, shape=l.shape, dtype=l.dtype))
                 for j, (o, l) in enumerate(zip(_outs(clike, "cg_"), cflat))]
        rows += cmats
        if compress == "int8":           # each worker stores what the wire carried
            cmats = [_int8_rows(m).to(m.dtype) for m in cmats]
        stored = tree_unflatten(clike, [m.reshape(l.shape) for m, l in zip(cmats, cflat)])
        local["cv_params"], local["cv_duals"] = stored["params"], stored["duals"]
    smats = _sketch_mats(state, n_workers)
    if smats:
        if compress == "int8":
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        fins += _sketch_finishes(state, len(rows))
        rows += smats
        if "sk_loc" in state:
            local["sk_loc"] = {k: state["sk_loc"][k] + state["sk_new"][k]
                               for k in state["sk_loc"]}
        local["sk_new"] = {k: torch.zeros_like(v) for k, v in state["sk_new"].items()}
    plan = Plan(state, rows, _reducer(compress, wa, ring, mean=True), fins, local, ring,
                mean=True, inplace=inplace)
    return plan if momentum is None else _with_momentum(plan, *momentum)


def masked_plan(state, cv_new, faults, compress: str | None, *, wa: Wire | None = None,
                ring: RingSpec | None = None, inplace: bool = False) -> Plan:
    """The plan of ``masked_average_state`` (``cv_new`` None) or of
    ``masked_average_and_refresh``."""
    _no_ring_int8(ring, compress)
    u, r, m = _masks(faults)
    take = torch.maximum(m, r)
    mats, (flat, like), _ = _state_mats(state)
    n, int8 = len(mats), compress == "int8"
    cv = cv_new is not None
    cmats, (cflat, clike), _ = _state_mats(cv_new) if cv else ([], (None, None), None)
    nc = len(cmats)
    lane = None if int8 else n + nc      # the weight lanes' row (int8: divided already)
    fins = [_Finish([o], (j,) if int8 else (j, lane), functools.partial(
        _fin_select, row=j, lane=lane, old=l, take=take))
        for j, (o, l) in enumerate(zip(_outs(like), flat))]
    local = {}
    if cv:
        fins += [_Finish([o], (n + j,) if int8 else (n + j, lane), functools.partial(
            _fin_mean, row=n + j, lane=lane, col=1, shape=l.shape, dtype=l.dtype))
            for j, (o, l) in enumerate(zip(_outs(clike, "cg_"), cflat))]
        fresh = [_int8_rows(mt).to(mt.dtype) for mt in cmats] if int8 else cmats
        # c_k ← the fresh variate for participants, unchanged for absent workers
        old = tree_leaves({"params": state["cv_params"], "duals": state["cv_duals"]})
        stored = tree_unflatten(clike, [
            torch.where(_col(m, o) > 0, f.reshape(o.shape).to(o.dtype), o)
            for f, o in zip(fresh, old)])
        local["cv_params"], local["cv_duals"] = stored["params"], stored["duals"]
    lanes = torch.stack([u, m], dim=1) if cv else u[:, None]     # [K_loc, 1 or 2] f32
    if int8:
        if "sk_new" in state:
            raise ValueError("the streaming-eval sketch cannot ride int8 "
                             "compressed buckets")
        reduce = functools.partial(masked_int8_average, lane_idx=[0] * n + [1] * nc,
                                   lanes=lanes, wa=wa)
        return Plan(state, mats + cmats, reduce, fins, local, inplace=inplace)
    rows = _scaled(mats, u) + _scaled(cmats, m) + [lanes]
    smats = _masked_sketch_mats(state, m)
    if smats:
        fins += _sketch_finishes(state, len(rows))
        rows += smats
        if "sk_loc" in state:
            new = state["sk_new"]
            local["sk_loc"] = {k: state["sk_loc"][k] + new[k] * _col(m, new[k])
                               for k in state["sk_loc"]}
        keep = 1.0 - m
        local["sk_new"] = {k: v * _col(keep, v) for k, v in state["sk_new"].items()}
    return Plan(state, rows, _reducer(None, wa, ring, mean=False), fins, local, ring,
                mean=False, inplace=inplace)


def average_state(state, compress: str | None, *, wa: Wire | None = None,
                  ring: RingSpec | None = None, n_workers: int | None = None):
    """Periodic model averaging (``coda.average``, CoDA's window end): the
    mean over the workers of every params and dual leaf, broadcast back,
    each leaf in its own dtype (a bf16 leaf summed in fp32 and rounded
    once, as ``jnp.mean`` rounds); ``compress="int8"`` averages each
    worker's int8-quantized rows.  The sketch deltas (which need
    ``n_workers``) ride the f32 bucket as exact count sums.  ``wa`` /
    ``ring``: across ranks, by all_reduce or by rings."""
    return average_plan(state, None, compress, wa=wa, ring=ring, n_workers=n_workers).run()


def average_and_refresh(state, cv_new, compress: str | None, *, wa: Wire | None = None,
                        ring: RingSpec | None = None, n_workers: int | None = None):
    """CODASCA's window end: average the state AND the fresh per-worker
    control variates ``cv_new`` ({"params", "duals"} in the wire dtypes) in
    the same buckets.  The state mean is broadcast back, the variate mean
    becomes ``cg_*``, and each worker keeps its own ``cv_new`` as ``cv_*``.

    Under int8 each worker stores its variates re-quantized by the wire's
    quantizer (locally), so ``cg == mean_k cv_k`` survives quantization and
    the K = 1 and homogeneous CODASCA ≡ CoDA equivalences hold."""
    return average_plan(state, cv_new, compress, wa=wa, ring=ring, n_workers=n_workers).run()


def masked_average_state(state, faults, compress: str | None, *, wa: Wire | None = None,
                         ring: RingSpec | None = None):
    """``average_state`` under partial participation: the exact u-weighted
    mean over the participants, adopted by every worker with
    ``max(m, resync) > 0``.  ``faults``: {"weights": [K_loc] f32, "resync":
    [K_loc] f32} from ``core.faults.FaultPlan.window`` on the state's
    device, cut to the rank's workers.  The weight lane Σu rides the f32
    bucket (or the int8 pair's scales)."""
    return masked_plan(state, None, faults, compress, wa=wa, ring=ring).run()


def masked_average_and_refresh(state, cv_new, faults, compress: str | None, *,
                               wa: Wire | None = None, ring: RingSpec | None = None):
    """``average_and_refresh`` under partial participation: the state merges
    over the weights u as in ``masked_average_state``; the variates refresh
    over the participants only (rows pre-scaled by the binary mask m,
    divided by P = Σm, a second lane), so ``cg`` is the exact participant
    mean; each participant stores its fresh variate (re-quantized under
    int8) and an absent worker keeps its old ``c_k``."""
    return masked_plan(state, cv_new, faults, compress, wa=wa, ring=ring).run()


# --------------------------------------------------------------------------
# the overlapped pair: the first averaging in flight under the second
# window's local steps
# --------------------------------------------------------------------------
# the ops whose dispatch counts as compute in ``overlap_log``
MATMUL_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
                        "matmul", "linear", "convolution", "_convolution",
                        "cudnn_convolution", "convolution_backward"})


def _storage(t: torch.Tensor):
    return t.untyped_storage().data_ptr() if t.numel() else None


def _note(event: str, what: str) -> None:
    overlap_log.append((event, what, time.perf_counter()))


class _Reads(TorchDispatchMode):
    """Before an aten op reads a pending leaf (a view is no read), wait for
    the units that leaf waits on; log each matmul-bearing op."""

    def __init__(self, pending):
        super().__init__()
        self.pending = pending

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.pending.pending and not func.is_view:
            for t in pytree.tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    self.pending.wait_for(t)
        if func.overloadpacket.__name__ in MATMUL_OPS:
            _note("compute", func.overloadpacket.__name__)
        return func(*args, **kwargs)


class _PointerReads(TorchFunctionMode):
    """A hand-written kernel's wrapper hands the kernel ``data_ptr()``s,
    which no aten op sees: wait before the pointer of a pending leaf is
    taken."""

    def __init__(self, pending):
        super().__init__()
        self.pending = pending

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.data_ptr:
            self.pending.wait_for(args[0])
        return func(*args, **(kwargs or {}))


# the profiler range around the side stream's work (its kernels carry it)
SIDE_STREAM_RANGE = "PendingAverage.side_stream"


def warm_reads() -> None:
    """Enter and leave the read guards once: torch's first dispatch mode of
    a process imports its compiler stack (seconds), which an executor that
    will overlap pays at set-up rather than inside its first pair."""
    with _Reads(PendingAverage()):
        torch.zeros(1).add_(1)


class PendingAverage:
    """A window averaging that runs beside the next window's local steps
    (the reference's fused window pair, ``window_pair_fn``).

    ``start(plan)`` returns the averaged state at once, every averaged leaf
    pending (preallocated, or under an in-place plan the leaf it averages:
    the units read a leaf's rows before the finish that writes it, on the
    same stream or thread), and hands the plan's ring units to a
    dedicated CUDA stream (NCCL: the local reduction waits on an event the
    compute stream records at the end of the first window; the hops, the
    chains' adds and the leaves' finishing work follow, and each unit
    records a completion event) or to a worker thread (gloo: the second
    window's local steps issue no collective, so nothing else uses the
    group meanwhile; each unit sets its completion).  The units are
    independent: C chunk chains a dtype bucket at R > 1, one row block's
    local reduction at R = 1.  A leaf's finish runs right after the last
    unit it needs, so each unit's completion covers the leaves it
    finished.  ``order`` (a previous pair's ``read_order``: the units in
    the order its second window first waited on them) sets the order the
    units run in, so the leaves the next window reads first are finished
    first; any order gives the same bits, the chains being independent, and
    every rank runs the same program, so the ranks agree on it.

    The next window runs its local steps inside ``reads(step)``: before an
    op first reads a pending leaf the second window waits (the CUDA stream
    waits on the events; gloo blocks on the completions) on the units that
    cover the leaf's rows and on any unit its finish needs besides (the
    masked path's weight lanes); nothing else waits.  ``settle()``, before
    the next window's own averaging, waits for the rest and joins the
    thread.  Every step of ``overlap_log`` is noted as it happens."""

    def __init__(self, order=None):
        self.order = list(order or [])
        self.pending: dict = {}         # storage pointer → the units its leaf waits on
        self._lock = threading.Lock()
        self.read_order: list = []      # the units, as first waited on
        self._keep: list = []
        self.summary: dict = {}
        self.units: list = []
        self.events = self.done = self.thread = self.error = None

    # -- start -------------------------------------------------------------
    def start(self, plan: Plan) -> dict:
        if plan.ring is None:
            raise ValueError("only a ring averaging can run beside the next window")
        rr = _RingReduction(plan.rows, plan.ring, mean=plan.mean)
        self.units = rr.units
        seq = self.order if sorted(self.order) == list(range(len(rr.units))) \
            else list(range(len(rr.units)))
        pos = {k: i for i, k in enumerate(seq)}
        covers: dict = {}
        for k, u in enumerate(rr.units):
            for i in u.rows:
                covers.setdefault(i, []).append(k)
        slots, ready, extra = plan.slots(), [[] for _ in rr.units], 0
        for f in plan.finishes:
            need = sorted({k for i in f.needs for k in covers[i]}, key=pos.get)
            own = {k for i in f.needs[:1] for k in covers[i]}
            extra += len(f.outs) if set(need) - own else 0
            dsts = [plan.leaf(k, i) if plan.inplace else torch.empty_like(plan.leaf(k, i))
                    for k, i in f.outs]
            for (k, i), d in zip(f.outs, dsts):
                slots[k][i] = d
                self.pending[_storage(d)] = need
            self._keep += dsts
            ready[need[-1]].append((f.fn, [_writer(d) for d in dsts]))
        new = plan.assemble(slots)
        self.summary = {"units": len(rr.units), "chains": len(rr.units) if plan.ring.size > 1
                        else 0, "leaves": len(self._keep), "also_other_units": extra}
        dev = self._keep[0].device
        if dev.type == "cuda":
            self._start_cuda(rr, ready, seq, plan, dev)
        else:
            self.done = [threading.Event() for _ in rr.units]
            for k in seq:
                _note("issue", rr.units[k].tag)
            self.thread = threading.Thread(target=self._work_guarded, args=(rr, ready, seq),
                                           daemon=True)
            self.thread.start()
        return new

    def _start_cuda(self, rr, ready, seq, plan, dev):
        with torch.profiler.record_function(SIDE_STREAM_RANGE):
            self._enqueue(rr, ready, seq, plan, dev)

    def _enqueue(self, rr, ready, seq, plan, dev):
        side = torch.cuda.Stream(dev)
        end_of_window = torch.cuda.Event()
        end_of_window.record()
        side.wait_event(end_of_window)
        # every tensor the stream reads or writes that the compute stream
        # allocated: the first window's rows, what the finishes read, the
        # preallocated leaves
        for t in _cuda_tensors([plan.rows, [f.fn for f in plan.finishes], self._keep]):
            t.record_stream(side)
        self.events = [torch.cuda.Event() for _ in rr.units]
        with torch.cuda.stream(side):
            self._work(rr, ready, seq)

    def _work(self, rr, ready, seq):
        for k in seq:
            u = rr.units[k]
            if self.events is not None:
                _note("issue", u.tag)
            rr.run(u)
            for fn, dsts in ready[k]:
                for d, t in zip(dsts, fn(rr.reduced)):
                    d.copy_(t)
            if self.events is not None:
                self.events[k].record()
            else:
                _note("done", u.tag)
                self.done[k].set()

    def _work_guarded(self, rr, ready, seq):
        try:
            self._work(rr, ready, seq)
        except BaseException as e:       # re-raised where the main thread waits
            self.error = e
        finally:
            for d in self.done:
                d.set()

    # -- the second window ---------------------------------------------------
    def wait_for(self, t: torch.Tensor) -> None:
        """Wait for the units of the pending leaf whose storage ``t`` views
        (nothing when it views none)."""
        with self._lock:
            need = self.pending.pop(_storage(t), None) if self.pending else None
        if need:
            self._wait_units(need)

    def _wait_units(self, need) -> None:
        for k in need:
            if k in self.read_order:
                continue
            self.read_order.append(k)
            _note("wait", self.units[k].tag)
            if self.events is not None:
                torch.cuda.current_stream().wait_event(self.events[k])
            else:
                self.done[k].wait()
                if self.error is not None:
                    raise RuntimeError("the overlapped averaging failed") from self.error

    def reads(self, step: int):
        """The context of the second window's local step ``step``: the read
        guards while any leaf is pending, else nothing."""
        if not self.pending:
            return contextlib.nullcontext()
        _note("step", str(step))
        stack = contextlib.ExitStack()
        stack.enter_context(_PointerReads(self))
        stack.enter_context(_Reads(self))
        return stack

    def settle(self) -> None:
        """Wait for every unit not waited on yet, join the thread, and let go
        of the first window's tensors."""
        self.pending.clear()
        self._wait_units(range(len(self.units)))
        if self.thread is not None:
            self.thread.join()
            if self.error is not None:
                raise RuntimeError("the overlapped averaging failed") from self.error
        self._keep, self.thread, self.events, self.done = [], None, None, None


def _writer(t: torch.Tensor) -> torch.Tensor:
    """A second tensor over ``t``'s memory with a version counter of its
    own: the finish writes through it, so the write, which the second
    window's first read waits for, does not look to autograd like an
    in-place change of a tensor the step has already saved."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.size(), t.stride())


def _cuda_tensors(obj) -> list:
    """The CUDA tensors in nested lists, tuples, dicts and partials."""
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.is_cuda else []
    if isinstance(obj, functools.partial):
        return _cuda_tensors([obj.func, list(obj.args), obj.keywords])
    if isinstance(obj, dict):
        return _cuda_tensors(list(obj.values()))
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _cuda_tensors(x)]
    return []
