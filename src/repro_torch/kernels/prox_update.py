"""Fused CoDA proximal update: CUDA kernel wrapper.

    v ← (γ·(v − η·g) + η·v₀) / (η + γ)

Replaces the Pallas kernel ``repro/kernels/prox_update.py::prox_update``
(lines 39-59, ``pallas_call`` at :46).  One launch covers one parameter
leaf with its leading K worker axis (6 launches per local step for the mlp,
153 for ResNet50), as the reference's per-leaf ``tree_map`` does.

What bounds it on the card: bytes.  Each element is 3 reads and 1 write
(16 B in fp32, 8 B in bf16) against 6 fp32 operations, far below the
card's operations-per-byte balance.  The design is a single coalesced
grid-stride pass that reads each input once and writes the output once,
with η and γ as runtime arguments so a new stage launches the same kernel.
The result goes to a fresh tensor, or (``inplace=True``, what a donating
executor's local step asks for) back into v through the kernel's in-place
form, which reads each element before it writes it and carries no
``__restrict__`` on v.  In place, v must not overlap g or v₀: a caller's
``ref_params`` then needs buffers of its own (``check_inplace`` raises
otherwise, on either device).

The wrapper computes the plain version (``ref.prox_update_ref``) for CPU
tensors, and launches the kernel or raises for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches through this wrapper (one per call that reaches the card).
launches = 0

# csrc/coda_kernels.cu's kProxThreads and its grid-stride cap: 16 blocks per SM
# of the H100's 132
THREADS = 256
MAX_BLOCKS = 132 * 16


def launch_geometry(n: int) -> dict:
    """The one launch over a leaf of ``n`` elements (every worker's): a
    grid-stride pass of ``THREADS``-thread blocks, one thread an element up
    to ``MAX_BLOCKS`` blocks, past that each thread strides
    (``coda_kernels.cu``'s ``stride_blocks``); no shared memory."""
    return {"kernel": "prox_update_kernel", "launches": 1 if n > 0 else 0,
            "grid": (min(-(-n // THREADS), MAX_BLOCKS),), "threads": THREADS,
            "smem_bytes": 0}


def byte_span(t: torch.Tensor) -> tuple[int, int]:
    """The byte range [lo, hi) of ``t``'s elements in memory."""
    if t.numel() == 0:
        return 0, 0
    lo = t.untyped_storage().data_ptr() + t.storage_offset() * t.element_size()
    ext = sum((n - 1) * abs(st) for n, st in zip(t.shape, t.stride())) + 1
    return lo, lo + ext * t.element_size()


def check_inplace(dst: torch.Tensor, reads, what: str) -> None:
    """An in-place update writes ``dst`` element by element: it must be
    contiguous (no element shared, as an expanded view shares them) and lie
    apart from every tensor in ``reads``."""
    if not dst.is_contiguous():
        raise ValueError(f"{what} in place needs a contiguous destination")
    base = dst.untyped_storage().data_ptr()
    shared = [t for t in reads if t.untyped_storage().data_ptr() == base]
    lo, hi = byte_span(dst) if shared else (0, 0)
    for t in shared:
        a, b = byte_span(t)
        if a < hi and lo < b:
            raise ValueError(f"{what} in place: the destination overlaps an input it "
                             "reads (a proximal reference sharing the parameters' "
                             "buffers?)")


# entry point by (v and v0's dtype, g's dtype): g may be fp32 under bf16
# parameters, as blocked Shampoo's fp32 step is (the reference's kernel
# casts each input to fp32 on its own)
_ENTRY = {(torch.float32, torch.float32): "coda_prox_update_f32",
          (torch.bfloat16, torch.bfloat16): "coda_prox_update_bf16",
          (torch.bfloat16, torch.float32): "coda_prox_update_bf16_gf32"}


def prox_update(v, g, v0, eta: float, gamma: float, *, inplace: bool = False):
    """Elementwise proximal step over tensors of one shape: v and v0 of one
    dtype (fp32 or bf16), g of theirs or fp32; returns a new tensor in v's
    dtype, or with ``inplace`` v itself, overwritten (the plain version
    computes out of place and copies back)."""
    if not (v.shape == g.shape == v0.shape):
        raise ValueError(f"prox_update wants one shape, got {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(v0.shape)}")
    if v.dtype != v0.dtype or (v.dtype, g.dtype) not in _ENTRY:
        raise ValueError(f"prox_update wants v and v0 all float32 or all "
                         f"bfloat16, and g in their dtype or float32; got "
                         f"{v.dtype}, {g.dtype}, {v0.dtype}")
    if len({v.device, g.device, v0.device}) != 1:
        raise ValueError("prox_update inputs lie on several devices")
    if inplace:
        check_inplace(v, (g, v0), "prox_update")
    if v.device.type == "cpu":
        out = ref.prox_update_ref(v, g, v0, eta, gamma)
        return v.copy_(out) if inplace else out
    if v.device.type != "cuda":
        raise ValueError(f"prox_update runs on cpu or cuda, got {v.device}")
    global launches
    lib = _build.load()
    g, v0 = g.contiguous(), v0.contiguous()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    entry = _ENTRY[(v.dtype, g.dtype)]
    if inplace:
        out = v
        err = getattr(lib, entry.replace("update_", "update_inplace_"))(
            v.data_ptr(), g.data_ptr(), v0.data_ptr(), v.numel(), float(eta), float(gamma),
            stream)
    else:
        v = v.contiguous()
        out = torch.empty_like(v)
        err = getattr(lib, entry)(v.data_ptr(), g.data_ptr(), v0.data_ptr(), out.data_ptr(),
                                  v.numel(), float(eta), float(gamma), stream)
    _build.check(err, "prox_update launch")
    launches += 1
    return out
