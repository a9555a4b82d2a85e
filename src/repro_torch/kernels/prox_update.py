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
The result goes to a fresh tensor (the update is not in place), so a
caller's ``ref_params`` may share buffers with ``params`` safely.

The wrapper computes the plain version (``ref.prox_update_ref``) for CPU
tensors, and launches the kernel or raises for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches through this wrapper (one per call that reaches the card).
launches = 0

_ENTRY = {torch.float32: "coda_prox_update_f32",
          torch.bfloat16: "coda_prox_update_bf16"}


def prox_update(v, g, v0, eta: float, gamma: float):
    """Elementwise proximal step over tensors of one shape and dtype (fp32
    or bf16); returns a new tensor in v's dtype."""
    if not (v.shape == g.shape == v0.shape):
        raise ValueError(f"prox_update wants one shape, got {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(v0.shape)}")
    if not (v.dtype == g.dtype == v0.dtype) or v.dtype not in _ENTRY:
        raise ValueError(f"prox_update wants v, g, v0 all float32 or all "
                         f"bfloat16, got {v.dtype}, {g.dtype}, {v0.dtype}")
    if len({v.device, g.device, v0.device}) != 1:
        raise ValueError("prox_update inputs lie on several devices")
    if v.device.type == "cpu":
        return ref.prox_update_ref(v, g, v0, eta, gamma)
    if v.device.type != "cuda":
        raise ValueError(f"prox_update runs on cpu or cuda, got {v.device}")
    global launches
    lib = _build.load()
    v, g, v0 = (t.contiguous() for t in (v, g, v0))
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = getattr(lib, _ENTRY[v.dtype])(
        v.data_ptr(), g.data_ptr(), v0.data_ptr(), out.data_ptr(), v.numel(),
        float(eta), float(gamma), stream)
    _build.check(err, "prox_update launch")
    launches += 1
    return out
