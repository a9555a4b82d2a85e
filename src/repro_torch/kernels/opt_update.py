"""Fused local-optimizer update: CUDA kernel wrapper (K3).

    momentum: m ← coef·m + g, d = m   (a bf16 m stored with the reference's
                                       hash-based stochastic rounding)
    precond:  ν = cover + g², d = g/√(ν + coef)   (ν returned in fp32)
    then      v ← (γ·(v − η·d) + η·v₀) / (η + γ)

Replaces the Pallas kernel ``repro/kernels/opt_update.py::opt_update``
(lines 72-96, ``pallas_call`` at :86), which the reference's optimizers
call once per parameter leaf (``repro/core/optimizer.py:125,172``) inside
one compiled step.  Here one launch covers every leaf of a local step, each
with its leading K worker axis (``opt_update_multi``,
``csrc/coda_kernels.cu``), as ``prox_update_multi`` does for K2: the leaf
table (pointers, sizes, dtype codes, each leaf's seed index) is a kernel
parameter, a block owns one tile of one leaf, every access is 16 bytes
wide, and the static part of the table is cached per tree signature.  A
step of more than ``MAX_LEAVES`` leaves takes more launches.

What bounds it on the card: bytes.  Each element is 4 reads and 2 writes —
24 B in fp32, 20 B with a bf16 momentum buffer — against about 10 fp32
operations and an integer hash, far below the card's operations-per-byte
balance.  Per leaf, v, g and v₀ share one dtype (fp32 or bf16) and the
buffer has its own (fp32 or bf16 for momentum, fp32 for precond); leaves of
every combination ride in one launch, whose mode is momentum or precond.
Both results go to fresh tensors, or (``inplace=True``) back into v and the
buffer (neither may overlap g, v₀, the seeds or any other leaf's memory).
The buffer is elementwise: SM3's accumulators are reductions, so its caller
hands in the materialized covers, never an accumulator or an expanded view
of one.

The stochastic-rounding seeds are one int64 tensor on the card, one uint32
a leaf (``core.optimizer.leaf_seeds`` derives them from the device step
counter); leaf i's row of the table holds its index into that tensor, and
the kernel reads the seed there: no host read, no slice a leaf.

``opt_update`` is the one-leaf case.  The wrappers compute the plain
version (``ref.opt_update_ref``, leaf by leaf) for CPU tensors, and launch
the kernel or raise for CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.prox_update import (Plan, apart, cached_plan, check_inplace_multi,
                                             leaf_rows, multi_geometry, pointer_table)

# Kernel launches through these wrappers (one per launch that reaches the card).
launches = 0

MODES = {"momentum": 0, "precond": 1}
_F32, _BF16 = torch.float32, torch.bfloat16
# dtype code by (v, g and v0's dtype, the buffer's dtype)
CODES = {(_F32, _F32): 0, (_F32, _BF16): 1, (_BF16, _F32): 2, (_BF16, _BF16): 3}


def launch_geometry(sizes, codes) -> dict:
    """The launches of one step over leaves of ``sizes`` elements and dtype
    ``codes`` (``CODES``' values): the geometry of ``prox_update``'s
    (``prox_update.launch_geometry``) — the non-empty leaves in order,
    ``MAX_LEAVES`` a launch, a block a tile of a leaf."""
    return multi_geometry("opt_update_multi_kernel", sizes, codes, set(CODES.values()),
                          lambda c: c >= 2)


def _check(v, g, v0, buf, mode) -> int:
    """The leaf's dtype code; raises for a leaf the kernel cannot take."""
    if mode not in MODES:
        raise ValueError(f"unknown opt_update mode {mode!r}")
    if not (v.shape == g.shape == v0.shape == buf.shape):
        raise ValueError(f"opt_update wants one shape, got {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(v0.shape)}, {tuple(buf.shape)}")
    if not (v.dtype == g.dtype == v0.dtype) or v.dtype not in (_F32, _BF16):
        raise ValueError(f"opt_update wants v, g, v0 all float32 or all "
                         f"bfloat16, got {v.dtype}, {g.dtype}, {v0.dtype}")
    if buf.dtype not in (_F32, _BF16) or (mode == "precond" and buf.dtype != _F32):
        raise ValueError(f"opt_update mode {mode!r} cannot take a {buf.dtype} "
                         "buffer (momentum: float32 or bfloat16; precond: "
                         "float32)")
    if len({v.device, g.device, v0.device, buf.device}) != 1:
        raise ValueError("opt_update inputs lie on several devices")
    return CODES[(v.dtype, buf.dtype)]


def _opt_plan(vs, gs, v0s, bufs, mode) -> Plan:
    key = ("opt", mode) + tuple((v.shape, g.shape, v0.shape, b.shape, v.dtype, g.dtype,
                                 v0.dtype, b.dtype, v.device, g.device, v0.device, b.device)
                                for v, g, v0, b in zip(vs, gs, v0s, bufs))

    def build():
        codes = [_check(v, g, v0, b, mode) for v, g, v0, b in zip(vs, gs, v0s, bufs)]
        sizes = [v.numel() for v in vs]
        return Plan(launch_geometry(sizes, codes),
                    [(n, c, i) for i, (n, c) in enumerate(zip(sizes, codes))])
    return cached_plan(key, build)


def plain_multi(vs, gs, v0s, bufs, eta: float, gamma: float, coef: float, seeds, *,
                mode: str, inplace: bool = False) -> tuple[list, list]:
    """The plain version leaf by leaf (``ref.opt_update_ref``, leaf i under
    ``seeds[i]``), on any device; ``inplace`` checks the destinations as the
    kernel's launch does and copies each result into its v and buffer."""
    if inplace:
        check_inplace_multi(list(vs) + list(bufs), list(gs) + list(v0s) + [seeds],
                            "opt_update")
    outs = [ref.opt_update_ref(v, g, v0, b, eta, gamma, coef, seeds[i], mode=mode)
            for i, (v, g, v0, b) in enumerate(zip(vs, gs, v0s, bufs))]
    if inplace:
        return ([v.copy_(nv) for v, (nv, _) in zip(vs, outs)],
                [b.copy_(nb) for b, (_, nb) in zip(bufs, outs)])
    return [nv for nv, _ in outs], [nb for _, nb in outs]


def opt_update_multi(vs, gs, v0s, bufs, eta: float, gamma: float, coef: float, seeds, *,
                     mode: str, inplace: bool = False) -> tuple[list, list]:
    """The fused update over every leaf of a step at once: ``vs``, ``gs``,
    ``v0s``, ``bufs`` lists of one length, leaf i of one shape, updated
    under ``seeds[i]`` (on the card an int64 tensor on the leaves' device
    with one element a leaf; on the CPU also a list of ints).  Returns
    (new vs, new bufs): fresh tensors, or with ``inplace`` the vs and bufs
    themselves, overwritten.  CPU leaves take the plain version; CUDA leaves
    one launch a ``MAX_LEAVES`` leaves."""
    vs, gs, v0s, bufs = list(vs), list(gs), list(v0s), list(bufs)
    if not (len(vs) == len(gs) == len(v0s) == len(bufs)):
        raise ValueError(f"opt_update_multi wants lists of one length, got "
                         f"{len(vs)}, {len(gs)}, {len(v0s)}, {len(bufs)}")
    if mode not in MODES:
        raise ValueError(f"unknown opt_update mode {mode!r}")
    if not vs:
        return [], []
    plan = _opt_plan(vs, gs, v0s, bufs, mode)
    dev = vs[0].device
    if dev.type == "cpu":
        return plain_multi(vs, gs, v0s, bufs, eta, gamma, coef, seeds, mode=mode,
                           inplace=inplace)
    if dev.type != "cuda":
        raise ValueError(f"opt_update runs on cpu or cuda, got {dev}")
    if len({v.device for v in vs}) != 1:
        raise ValueError("opt_update_multi leaves lie on several devices")
    if not (isinstance(seeds, torch.Tensor) and seeds.dtype == torch.int64
            and seeds.dim() == 1 and seeds.numel() == len(vs) and seeds.device == dev):
        raise ValueError("opt_update on the card wants the seeds as an int64 tensor "
                         "on the leaves' device, one element a leaf")
    seeds = seeds.contiguous()
    vs, gs, v0s, bufs = leaf_rows([vs, gs, v0s, bufs], inplace=inplace, written=(0, 3),
                                  what="opt_update", extra_reads=(seeds,))
    if inplace:
        new_v, new_b = vs, bufs
    else:
        new_v = [torch.empty_like(v) for v in vs]
        new_b = [torch.empty_like(b) for b in bufs]
    # the kernel's row: v, g, v0, buf, out_v, out_buf
    rows = pointer_table([vs, gs, v0s, bufs, new_v, new_b])
    lib, stream = _build.load(), torch.cuda.current_stream(dev).cuda_stream
    if inplace:
        apart(lib, 2, rows, plan, "opt_update", seeds)
    global launches
    for idx, meta in plan.chunks:
        table = rows if idx is None else np.ascontiguousarray(rows[idx])
        err = lib.coda_opt_update_multi(MODES[mode], len(meta), table.ctypes.data,
                                        meta.ctypes.data, seeds.data_ptr(), float(eta),
                                        float(gamma), float(coef), stream)
        _build.check(err, "opt_update launch")
        launches += 1
    return new_v, new_b


def opt_update(v, g, v0, buf, eta: float, gamma: float, coef: float, seed, *,
               mode: str, inplace: bool = False):
    """Elementwise fused update of one leaf; returns (new_v in v's dtype,
    new_buf in buf's dtype), or with ``inplace`` (v, buf) themselves,
    overwritten.  ``seed``: on the card a one-element int64 tensor on v's
    device; on the CPU also a Python int.  The one-leaf case of
    ``opt_update_multi`` (one launch on the card)."""
    _check(v, g, v0, buf, mode)
    if v.device.type == "cuda" and not (isinstance(seed, torch.Tensor) and seed.numel() == 1
                                        and seed.dtype == torch.int64
                                        and seed.device == v.device):
        raise ValueError("opt_update on the card wants the seed as a "
                         "one-element int64 tensor on the same device")
    seeds = seed.reshape(1) if isinstance(seed, torch.Tensor) else [seed]
    nv, nb = opt_update_multi([v], [g], [v0], [buf], eta, gamma, coef, seeds, mode=mode,
                              inplace=inplace)
    return nv[0], nb[0]
