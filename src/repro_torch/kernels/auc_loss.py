"""Fused AUC min-max loss: CUDA kernel wrapper.

Replaces the Pallas kernel ``repro/kernels/auc_loss.py::auc_loss`` (lines
61-93, ``pallas_call`` at :73).  One pass over the scores gives the mean of
the paper's F(w,a,b,α;z) (eq. 2), ``dh``, and the partials ``da``, ``db``,
``dα`` — for all K workers in one launch: scores ``h [K, T]``, labels
``y [K, T]`` and the duals as ``[K]`` device tensors (they change every
step, and reading them as host floats would force a sync).

What bounds it on the card: at the main path's shapes (K × B = 4 × 32 on
the mlp launcher defaults) it moves about 1.5 KB, so it is bound by launch
latency, not by bytes (12 B per score: h, y read, dh written) or by its ~30
fp32 operations per score.  So it is one launch (``launch_geometry``): a
block sums up to ``ROWS_PER_BLOCK`` scores of one worker, and when T fits
one block (every CoDA path) that block writes the worker's results; for a
longer T the last block of each worker to finish (a per-worker ticket)
sums the blocks' partials in a fixed order.  No atomics in the sums, so the
result is bitwise stable from run to run, and bitwise the earlier
two-launch form's (block partials, then a second launch to sum them).  On
an NVIDIA H100 80GB HBM3 at 700 W (``scripts/auc_loss_before_after.py``)
one call at [4, 32] takes 1.68 µs of device time, the two launches took
3.30 µs; at [8, 4096] (the ticket path, four blocks a worker) 4.47 µs
against 3.97, at [2, 65536] 3.89 against 4.32.

The wrapper computes the plain version (``ref.auc_loss_ref``) for CPU
tensors, and launches the kernel or raises for CUDA tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# Kernel launches through this wrapper (one per call that reaches the card).
launches = 0

# csrc/coda_kernels.cu's kAucThreads and kAucRowsPerThread
THREADS, ROWS_PER_THREAD = 256, 4
ROWS_PER_BLOCK = THREADS * ROWS_PER_THREAD
# per-device [K] uint32 tickets for T > ROWS_PER_BLOCK: zeroed once, left
# zero by every launch (calls run on the device's current stream, in order)
_tickets: dict = {}


def launch_geometry(K: int, T: int) -> dict:
    """The one launch of a call: grid (blocks per worker, K) of ``THREADS``
    threads, each block over ``ROWS_PER_BLOCK`` scores; ``ticket``: whether
    the last block of each worker sums the others' partials (T longer than
    one block), else each block finishes its worker."""
    blocks = max(1, -(-T // ROWS_PER_BLOCK))
    return {"kernel": "auc_loss_kernel", "launches": 1, "grid": (blocks, K),
            "threads": THREADS, "rows_per_block": ROWS_PER_BLOCK, "ticket": blocks > 1}


def _tickets_for(device, K: int):
    t = _tickets.get(device)
    if t is None or t.numel() < K:
        t = torch.zeros(max(K, 64), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def _check_inputs(h, y, a, b, alpha):
    if h.dim() != 2 or y.shape != h.shape:
        raise ValueError(f"auc_loss wants h, y of one shape [K, T]; got "
                         f"{tuple(h.shape)} and {tuple(y.shape)}")
    K = h.shape[0]
    for name, d in (("a", a), ("b", b), ("alpha", alpha)):
        if not torch.is_tensor(d) or d.shape != (K,):
            raise ValueError(f"auc_loss wants {name} as a [{K}] tensor, got "
                             f"{getattr(d, 'shape', type(d))}")
    devs = {t.device for t in (h, y, a, b, alpha)}
    if len(devs) != 1:
        raise ValueError(f"auc_loss inputs lie on several devices: {devs}")


def auc_loss(h, y, a, b, alpha, p: float):
    """Returns (loss [K], dh [K, T] fp32, da [K], db [K], dalpha [K]) —
    see ``ref.auc_loss_ref``."""
    _check_inputs(h, y, a, b, alpha)
    if h.device.type == "cpu":
        return ref.auc_loss_ref(h, y, a, b, alpha, p)
    if h.device.type != "cuda":
        raise ValueError(f"auc_loss runs on cpu or cuda, got {h.device}")
    global launches
    K, T = h.shape
    if K > 65535:
        raise ValueError(f"auc_loss launches one grid row per worker; K={K} "
                         "exceeds the grid's 65535")
    lib = _build.load()
    f32 = lambda t: t.to(torch.float32).contiguous()
    h, y, a, b, alpha = (f32(t) for t in (h, y, a, b, alpha))
    geo = launch_geometry(K, T)
    dh = torch.empty((K, T), dtype=torch.float32, device=h.device)
    out = torch.empty((K, 4), dtype=torch.float32, device=h.device)
    partials = tickets = None               # null: one block finishes its worker
    if geo["ticket"]:
        partials = torch.empty((K, geo["grid"][0], 4), dtype=torch.float32,
                               device=h.device)
        tickets = _tickets_for(h.device, K)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = lib.coda_auc_loss(h.data_ptr(), y.data_ptr(), a.data_ptr(),
                            b.data_ptr(), alpha.data_ptr(), float(p), K, T,
                            dh.data_ptr(), ptr(partials), ptr(tickets), out.data_ptr(),
                            stream)
    _build.check(err, "auc_loss launch")
    launches += 1
    return out[:, 0], dh, out[:, 1], out[:, 2], out[:, 3]
