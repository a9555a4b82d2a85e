"""Fused local-optimizer update: CUDA kernel wrapper.

    momentum: m ← coef·m + g, d = m   (a bf16 m stored with the reference's
                                       hash-based stochastic rounding)
    precond:  ν = cover + g², d = g/√(ν + coef)   (ν returned in fp32)
    then      v ← (γ·(v − η·d) + η·v₀) / (η + γ)

Replaces the Pallas kernel ``repro/kernels/opt_update.py::opt_update``
(lines 72-96, ``pallas_call`` at :86).  One launch covers one parameter
leaf with its leading K worker axis (6 launches per local step for the mlp,
153 for ResNet50), as the reference's per-leaf loop in
``core/optimizer.py`` does.

What bounds it on the card: bytes.  Each element is 4 reads and 2 writes —
24 B in fp32, 20 B with a bf16 momentum buffer — against about 10 fp32
operations and an integer hash, far below the card's operations-per-byte
balance.  The kernel is one coalesced grid-stride pass (see
``csrc/coda_kernels.cu``).  v, g and v₀ share one dtype (fp32 or bf16); the
buffer has its own (fp32 or bf16 for momentum, fp32 for precond), so fp32
parameters with a bf16 momentum buffer is one launch.  Both results go to
fresh tensors, or (``inplace=True``) back into v and the buffer through
the kernel's in-place form (no ``__restrict__`` on those two; neither may
overlap g, v₀ or the other).  The buffer is elementwise: SM3's
accumulators are reductions, so its caller hands in the materialized
cover, never an accumulator or an expanded view of one.

The stochastic-rounding seed is a one-element int64 tensor on the card
holding a uint32 (``core.optimizer.leaf_seeds`` derives it from the device
step counter), read by the kernel: no host read per leaf.

The wrapper computes the plain version (``ref.opt_update_ref``) for CPU
tensors, and launches the kernel or raises for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.prox_update import check_inplace

# Kernel launches through this wrapper (one per call that reaches the card).
launches = 0

# csrc/coda_kernels.cu's kOptThreads and its grid-stride cap: 16 blocks per SM
# of the H100's 132
THREADS = 256
MAX_BLOCKS = 132 * 16


def launch_geometry(n: int) -> dict:
    """The one launch over a leaf of ``n`` elements (every worker's): a
    grid-stride pass of ``THREADS``-thread blocks, one thread an element up
    to ``MAX_BLOCKS`` blocks, past that each thread strides
    (``coda_kernels.cu``'s ``stride_blocks``); no shared memory."""
    return {"kernel": "opt_update_kernel", "launches": 1 if n > 0 else 0,
            "grid": (min(-(-n // THREADS), MAX_BLOCKS),), "threads": THREADS,
            "smem_bytes": 0}


MODES = {"momentum": 0, "precond": 1}
_DTYPES = (torch.float32, torch.bfloat16)


def _check(v, g, v0, buf, mode):
    if mode not in MODES:
        raise ValueError(f"unknown opt_update mode {mode!r}")
    if not (v.shape == g.shape == v0.shape == buf.shape):
        raise ValueError(f"opt_update wants one shape, got {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(v0.shape)}, {tuple(buf.shape)}")
    if not (v.dtype == g.dtype == v0.dtype) or v.dtype not in _DTYPES:
        raise ValueError(f"opt_update wants v, g, v0 all float32 or all "
                         f"bfloat16, got {v.dtype}, {g.dtype}, {v0.dtype}")
    if buf.dtype not in _DTYPES or (mode == "precond" and buf.dtype != torch.float32):
        raise ValueError(f"opt_update mode {mode!r} cannot take a {buf.dtype} "
                         "buffer (momentum: float32 or bfloat16; precond: "
                         "float32)")
    if len({v.device, g.device, v0.device, buf.device}) != 1:
        raise ValueError("opt_update inputs lie on several devices")


def check_inplace_pair(v, g, v0, buf, seed) -> None:
    """The in-place update writes v and buf: each contiguous, apart from
    each other and from everything else it reads."""
    seeds = (seed,) if isinstance(seed, torch.Tensor) else ()
    check_inplace(v, (g, v0, buf) + seeds, "opt_update")
    check_inplace(buf, (g, v0) + seeds, "opt_update")


def opt_update(v, g, v0, buf, eta: float, gamma: float, coef: float, seed, *,
               mode: str, inplace: bool = False):
    """Elementwise fused update of one leaf; returns (new_v in v's dtype,
    new_buf in buf's dtype), or with ``inplace`` (v, buf) themselves,
    overwritten (the plain version computes out of place and copies back).
    ``seed``: on the card a one-element int64 tensor on v's device; on the
    CPU also a Python int."""
    _check(v, g, v0, buf, mode)
    if inplace:
        check_inplace_pair(v, g, v0, buf, seed)
    if v.device.type == "cpu":
        nv, nb = ref.opt_update_ref(v, g, v0, buf, eta, gamma, coef, seed, mode=mode)
        return (v.copy_(nv), buf.copy_(nb)) if inplace else (nv, nb)
    if v.device.type != "cuda":
        raise ValueError(f"opt_update runs on cpu or cuda, got {v.device}")
    if not (isinstance(seed, torch.Tensor) and seed.numel() == 1
            and seed.dtype == torch.int64 and seed.device == v.device):
        raise ValueError("opt_update on the card wants the seed as a "
                         "one-element int64 tensor on the same device")
    global launches
    lib = _build.load()
    g, v0, seed = (t.contiguous() for t in (g, v0, seed))
    if inplace:
        out_v, out_buf = v, buf
        outs = (None, None)
    else:
        v, buf = v.contiguous(), buf.contiguous()
        out_v, out_buf = torch.empty_like(v), torch.empty_like(buf)
        outs = (out_v.data_ptr(), out_buf.data_ptr())
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = lib.coda_opt_update(
        MODES[mode], int(v.dtype == torch.bfloat16), int(buf.dtype == torch.bfloat16),
        v.data_ptr(), g.data_ptr(), v0.data_ptr(), buf.data_ptr(), *outs, v.numel(),
        float(eta), float(gamma), float(coef), seed.data_ptr(), stream)
    _build.check(err, "opt_update launch")
    launches += 1
    return out_v, out_buf
