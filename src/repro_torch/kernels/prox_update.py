"""Fused CoDA proximal update: CUDA kernel wrapper (K2).

    v ← (γ·(v − η·g) + η·v₀) / (η + γ)

Replaces the Pallas kernel ``repro/kernels/prox_update.py::prox_update``
(lines 39-59, ``pallas_call`` at :46), which the reference calls once per
parameter leaf (``repro/kernels/ops.py:131-142``) inside one compiled step.
Here one launch covers every leaf of a local step, each with its leading K
worker axis (``prox_update_multi``, ``csrc/coda_kernels.cu``): one for the
mlp's 6 leaves, for ResNet50's 153, for bf16 stablelm's 17 mixed-dtype
leaves.  A step of more than ``MAX_LEAVES`` leaves takes more launches of
the same kernel (``launch_geometry``).

What bounds it on the card: bytes.  Each element is 3 reads and 1 write
(16 B in fp32, 8 B in bf16) against 6 fp32 operations, far below the
card's operations-per-byte balance.  One launch a leaf paid a wrapper call
and a launch's latency for each (a ResNet50 step: 153 launches, 4.76 ms of
CUDA-event time against 0.782 ms of device time, on an H100 80GB HBM3 at
700 W), so the kernel reads a table of every leaf's pointers, sizes and
dtype codes passed by value as a kernel parameter; a block owns one tile of
one leaf and moves it through 16-byte accesses.  The host's work a step is
one ``data_ptr()`` a tensor into one table, one ctypes call a launch and,
in place, one more for the aliasing check: the static part of the table
(sizes, dtype codes, the split into launches) is cached per tree
signature.  Per leaf, v and v₀ share one dtype (fp32 or bf16) and g
has theirs or fp32 (blocked Shampoo's fp32 step under bf16 parameters), so
bf16 matrices and fp32 norms ride in one launch.

The result goes to fresh tensors, or (``inplace=True``, what a donating
executor's local step asks for) back into each v: the kernel loads a
thread's whole share of a tile before it stores any of it, and carries no
``__restrict__``.  In place, no written leaf may overlap any other leaf the
launch reads or writes: a caller's ``ref_params`` then needs buffers of its
own.  A step that breaks this raises: on the card the library checks the
step's table (``apart``, ``coda_multi_apart``), on the CPU
``check_inplace_multi``; both sort the byte spans, O(n log n).

``prox_update`` is the one-leaf case.  The wrappers compute the plain
version (``ref.prox_update_ref``, leaf by leaf) for CPU tensors, and launch
the kernel or raise for CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# Kernel launches through these wrappers (one per launch that reaches the card).
launches = 0

# csrc/coda_kernels.cu's kMultiThreads, kVecsPerThread and kMaxLeaves: a
# thread takes four 16-byte vectors of v, so a tile (a block) is 4096
# elements of an fp32 v and 8192 of a bf16 one
THREADS = 256
VECS_PER_THREAD = 4
TILE = {False: THREADS * VECS_PER_THREAD * 4, True: THREADS * VECS_PER_THREAD * 8}
MAX_LEAVES = 384

# dtype code by (v and v0's dtype, g's dtype): the reference's kernel casts
# each input to fp32 on its own, so g may be fp32 under bf16 parameters
CODES = {(torch.float32, torch.float32): 0,
         (torch.bfloat16, torch.bfloat16): 1,
         (torch.bfloat16, torch.float32): 2}


def launch_geometry(sizes, codes) -> dict:
    """The launches of one step over leaves of ``sizes`` elements and dtype
    ``codes`` (``CODES``' values; any launch takes them mixed): the
    non-empty leaves in order, ``MAX_LEAVES`` a launch, one ``THREADS``-
    thread block a tile of a leaf (``TILE`` elements by whether v is bf16);
    no shared memory.  ``grid`` is the largest launch's, ``grids`` each
    one's, ``chunks`` the leaf indices each launch covers."""
    return multi_geometry("prox_update_multi_kernel", sizes, codes, set(CODES.values()),
                          lambda c: c != 0)


def multi_geometry(kernel: str, sizes, codes, known, bf16_v) -> dict:
    """``launch_geometry`` of K2 or K3: ``known`` their dtype codes,
    ``bf16_v(code)`` whether the code's v is bf16."""
    sizes, codes = [int(n) for n in sizes], list(codes)
    if len(codes) != len(sizes) or not set(codes) <= known:
        raise ValueError(f"{kernel}: dtype codes {codes} for {len(sizes)} leaves")
    live = [i for i, n in enumerate(sizes) if n > 0]
    chunks = [live[i:i + MAX_LEAVES] for i in range(0, len(live), MAX_LEAVES)]
    grids = tuple(sum(-(-sizes[i] // TILE[bf16_v(codes[i])]) for i in c) for c in chunks)
    return {"kernel": kernel, "launches": len(chunks), "grid": (max(grids, default=0),),
            "grids": grids, "threads": THREADS, "smem_bytes": 0,
            "tile_elems": (TILE[False], TILE[True]), "max_leaves": MAX_LEAVES,
            "chunks": chunks}


def byte_span(t: torch.Tensor) -> tuple[int, int]:
    """The byte range [lo, hi) of ``t``'s elements in memory."""
    if t.numel() == 0:
        return 0, 0
    lo = t.data_ptr()
    if t.is_contiguous():
        return lo, lo + t.numel() * t.element_size()
    ext = sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride())) + 1
    return lo, lo + ext * t.element_size()


def spans_overlap(lo, hi, written) -> bool:
    """Whether a written span [lo, hi) meets any other non-empty span (two
    spans that are only read may meet): one sort and two running maxima."""
    lo, hi, written = (np.asarray(x) for x in (lo, hi, written))
    keep = hi > lo
    lo, hi, written = lo[keep], hi[keep], written[keep]
    if lo.size < 2:
        return False
    order = np.lexsort((hi, lo))
    lo, hi, written = lo[order], hi[order], written[order]
    reach = np.maximum.accumulate(hi)[:-1]                        # any span so far
    reach_w = np.maximum.accumulate(np.where(written, hi, -1))[:-1]  # written ones
    later = lo[1:]
    return bool(np.any(later < reach_w) or np.any(written[1:] & (later < reach)))


def overlap_error(what: str) -> ValueError:
    return ValueError(f"{what} in place: a destination overlaps a tensor the update "
                      "reads or writes (a proximal reference sharing the parameters' "
                      "buffers?)")


def require_apart(lo, hi, written, what: str) -> None:
    if spans_overlap(lo, hi, written):
        raise overlap_error(what)


def check_inplace_multi(dsts, reads, what: str) -> None:
    """An in-place launch writes each of ``dsts`` element by element: each
    must be contiguous (no element shared, as an expanded view shares them)
    and lie apart from every other tensor the launch reads or writes."""
    spans = []
    for t in dsts:
        if not t.is_contiguous():
            raise ValueError(f"{what} in place needs a contiguous destination")
        spans.append(byte_span(t) + (True,))
    spans += [byte_span(t) + (False,) for t in reads if isinstance(t, torch.Tensor)]
    require_apart(*zip(*spans), what)


def _check(v, g, v0) -> int:
    """The leaf's dtype code; raises for a leaf the kernel cannot take."""
    if not (v.shape == g.shape == v0.shape):
        raise ValueError(f"prox_update wants one shape, got {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(v0.shape)}")
    code = CODES.get((v.dtype, g.dtype))
    if v.dtype != v0.dtype or code is None:
        raise ValueError(f"prox_update wants v and v0 all float32 or all "
                         f"bfloat16, and g in their dtype or float32; got "
                         f"{v.dtype}, {g.dtype}, {v0.dtype}")
    if len({v.device, g.device, v0.device}) != 1:
        raise ValueError("prox_update inputs lie on several devices")
    return code


class Plan:
    """The static part of a step's launches, cached per tree signature: the
    kernel's int64 ``meta`` rows (elements, dtype code[, seed index]) of
    every leaf, and per launch the live leaves' indices (None where the
    launch takes every leaf in order, so the host table goes as it is) and
    their ``meta`` rows."""

    def __init__(self, geometry: dict, meta_rows: list):
        self.meta = np.ascontiguousarray(meta_rows, dtype=np.int64)
        whole = [list(range(len(meta_rows)))]
        self.chunks = [(None if geometry["chunks"] == whole else np.asarray(c, dtype=np.int64),
                        np.ascontiguousarray(self.meta[c]))
                       for c in geometry["chunks"]]


_PLANS: dict = {}
_MAX_PLANS = 256


def cached_plan(key, build) -> Plan:
    plan = _PLANS.get(key)
    if plan is None:
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        plan = _PLANS[key] = build()
    return plan


def leaf_rows(cols, *, inplace: bool, written, what: str, extra_reads=()) -> list:
    """The tensor columns of a launch (a list over the leaves a role), each
    tensor contiguous.  With ``inplace`` the roles ``written`` are written:
    each must be contiguous, and where any tensor is not, the aliasing
    check runs here over the originals (``check_inplace_multi``, against
    ``extra_reads`` too) before the others are copied.  A launch over
    contiguous tensors is checked by the library (``apart``)."""
    if all(t.is_contiguous() for col in cols for t in col):
        return cols
    if inplace:
        check_inplace_multi([t for k in written for t in cols[k]],
                            [t for k, col in enumerate(cols) if k not in written for t in col]
                            + list(extra_reads), what)
    return [[t.contiguous() for t in col] for col in cols]


def pointer_table(cols) -> np.ndarray:
    """[leaves, roles] int64: each leaf's tensors' data pointers in the
    kernel's row layout (``cols``: a list over the leaves a role)."""
    n = len(cols[0])
    return np.fromiter([t.data_ptr() for row in zip(*cols) for t in row], dtype=np.int64,
                       count=n * len(cols)).reshape(n, len(cols))


def apart(lib, kernel: int, table: np.ndarray, plan: Plan, what: str,
          seeds=None) -> None:
    """The aliasing check of an in-place launch, in the library over the
    host table (``coda_multi_apart``, the rule of ``check_inplace_multi``):
    raises where a written leaf overlaps anything the step reads or writes."""
    lo, hi = (0, 0) if seeds is None else byte_span(seeds)
    res = lib.coda_multi_apart(kernel, len(table), table.ctypes.data, plan.meta.ctypes.data,
                               lo or None, hi - lo)
    if res < 0:
        raise ValueError(f"{what}: a dtype code the kernel does not know")
    if res:
        raise overlap_error(what)


def _prox_plan(vs, gs, v0s) -> Plan:
    key = ("prox",) + tuple((v.shape, g.shape, v0.shape, v.dtype, g.dtype, v0.dtype,
                             v.device, g.device, v0.device) for v, g, v0 in zip(vs, gs, v0s))

    def build():
        codes = [_check(v, g, v0) for v, g, v0 in zip(vs, gs, v0s)]
        sizes = [v.numel() for v in vs]
        return Plan(launch_geometry(sizes, codes), list(zip(sizes, codes)))
    return cached_plan(key, build)


def plain_multi(vs, gs, v0s, eta: float, gamma: float, *, inplace: bool = False) -> list:
    """The plain version leaf by leaf (``ref.prox_update_ref``), on any
    device; ``inplace`` checks the destinations as the kernel's launch does
    and copies each result into its v."""
    if inplace:
        check_inplace_multi(vs, list(gs) + list(v0s), "prox_update")
    outs = [ref.prox_update_ref(v, g, v0, eta, gamma) for v, g, v0 in zip(vs, gs, v0s)]
    return [v.copy_(o) for v, o in zip(vs, outs)] if inplace else outs


def prox_update_multi(vs, gs, v0s, eta: float, gamma: float, *,
                      inplace: bool = False) -> list:
    """The proximal step over every leaf of a step at once: ``vs``, ``gs``,
    ``v0s`` lists of one length, leaf i of one shape (v and v0 of one
    dtype, g of theirs or fp32).  Returns the new leaves (fresh tensors in
    v's dtypes), or with ``inplace`` the vs themselves, overwritten.  CPU
    leaves take the plain version; CUDA leaves one launch a ``MAX_LEAVES``
    leaves."""
    vs, gs, v0s = list(vs), list(gs), list(v0s)
    if not (len(vs) == len(gs) == len(v0s)):
        raise ValueError(f"prox_update_multi wants lists of one length, got "
                         f"{len(vs)}, {len(gs)}, {len(v0s)}")
    if not vs:
        return []
    plan = _prox_plan(vs, gs, v0s)
    dev = vs[0].device
    if dev.type == "cpu":
        return plain_multi(vs, gs, v0s, eta, gamma, inplace=inplace)
    if dev.type != "cuda":
        raise ValueError(f"prox_update runs on cpu or cuda, got {dev}")
    if len({v.device for v in vs}) != 1:
        raise ValueError("prox_update_multi leaves lie on several devices")
    vs, gs, v0s = leaf_rows([vs, gs, v0s], inplace=inplace, written=(0,), what="prox_update")
    outs = vs if inplace else [torch.empty_like(v) for v in vs]
    # the kernel's row: v, g, v0, out
    rows = pointer_table([vs, gs, v0s, outs])
    lib, stream = _build.load(), torch.cuda.current_stream(dev).cuda_stream
    if inplace:
        apart(lib, 1, rows, plan, "prox_update")
    global launches
    for idx, meta in plan.chunks:
        table = rows if idx is None else np.ascontiguousarray(rows[idx])
        err = lib.coda_prox_update_multi(len(meta), table.ctypes.data, meta.ctypes.data,
                                         float(eta), float(gamma), stream)
        _build.check(err, "prox_update launch")
        launches += 1
    return outs


def prox_update(v, g, v0, eta: float, gamma: float, *, inplace: bool = False):
    """Elementwise proximal step over tensors of one shape: v and v0 of one
    dtype (fp32 or bf16), g of theirs or fp32; returns a new tensor in v's
    dtype, or with ``inplace`` v itself, overwritten.  The one-leaf case of
    ``prox_update_multi`` (one launch on the card)."""
    _check(v, g, v0)
    return prox_update_multi([v], [g], [v0], eta, gamma, inplace=inplace)[0]
