"""PyTorch + CUDA port of ``repro`` (CoDA: communication-efficient
distributed stochastic AUC maximization).

The package mirrors ``repro``'s module layout so each module's counterpart
is easy to find (``repro_torch.core.coda`` ↔ ``repro.core.coda``).  It
imports torch, numpy and the standard library only — never jax, never
``repro``.  The two Pallas kernels on the CoDA main path (``auc_loss``,
``prox_update``) are CUDA C++ kernels under ``kernels/csrc``, built with
nvcc at first use and reached through ``kernels.ops.dispatch``.

Entry points run on ``cuda`` unless the caller asks for the CPU;
``resolve_device`` is the one place that decides, and it never falls back
quietly.
"""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.  Asking for ``cuda`` where
    no card is visible raises instead of silently running on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but torch.cuda is not "
                           "available (pass --device cpu / device='cpu' to "
                           "run on the CPU)")
    return dev


def disable_tf32() -> None:
    """Keep matmul accumulation in full fp32 on the card.  cuDNN
    convolutions default to TF32 (about three decimal digits) while the JAX
    reference computes in fp32; TF32 is left to a later performance change.
    cuBLAS may also reduce bf16 and fp16 products' split-K partials in
    their own precision unless told not to; the reference accumulates them
    in fp32, and the audit's R3 holds every program to that."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
