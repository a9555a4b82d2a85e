"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):
  1. device check — no CUDA means exit 1; prints nvidia-smi's name and
     power limit;
  2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc)
     and prints the build time and ptxas's register report;
  3. holds each kernel against its plain PyTorch version on the card at the
     main path's shapes (and a few ragged ones), and times kernel and plain
     version with CUDA events after warm-up: auc_loss (one launch a call,
     bitwise equal from call to call) within atol 1e-5 + rtol 1e-4,
     prox_update (bf16 parameters with an fp32 step too) and opt_update
     bitwise (opt_update's bf16
     stochastic-rounding bits included, and equal to prox_update at
     coef = 0), each at one-leaf tables and over a local step's leaves as
     one launch (ResNet50's 153; bf16 stablelm-1.6b's 17 at 2 layers, bf16
     matrices beside fp32 norms; K3 in every mode and buffer dtype; out of
     place and in place, each bitwise the plain version leaf by leaf), timed
     beside the same leaves as one-leaf tables (a launch each);
     then K2's and K3's in-place forms (what a donating executor's step
     runs) at ResNet50's largest leaf × K=4, fp32 and bf16: bitwise their
     out-of-place forms and their plain versions, timed beside them;
  4. one mlp local step per optimizer (sgd, momentum with a bf16 buffer,
     sm3, shampoo_blocked) with the kernels and with the plain versions from
     the same state: the parameters must agree;
  5. the paths through ``train.main``, each with every launch counter set
     to 0 just before and read just after: mlp at the launcher's defaults
     (coda, auc, K=4, I=8, B=32, 3 stages) with sgd, momentum (bf16
     buffer), sm3, shampoo_blocked (one stage), the streaming sketch (``--metrics
     sketch --metric-interval 4``) and the other two objectives
     (``--objective pauc_dro``, ``--objective bce``: their losses are plain
     tensor code, so auc_loss = 0), CODASCA on Dirichlet(0.1) shards
     (``--algorithm codasca --dirichlet-alpha 0.1``), the same with faults
     and the sketch (``--participation 0.75 --straggler-prob 0.2
     --straggler-windows 2 --max-staleness 2 --fault-seed 3 --metrics
     sketch --metric-interval 4``: the masked averaging), the masked int8
     CoDA average (``--participation 0.5 --compress int8 --fault-seed 1``)
     and CODASCA with server momentum and the momentum optimizer
     (``--server-momentum 0.9 --optimizer momentum``: opt_update); each
     path's bytes/round/worker equal to the reference launcher's for the
     same flags; the crash-resume through ``coda.fit`` (the faulted CODASCA
     configuration, a window sampler that raises after window 5, a
     checkpoint every 2 windows, then ``resume=True``: state, history,
     rounds and bytes bitwise the uninterrupted run's); the quickstart twin
     (``python -m repro_torch.quickstart``, its own AUC > 0.85 assert);
     ResNet50 at full width (K=4, B=32, 32×32 images, one stage of 16 local
     steps) with sgd, momentum (bf16 buffer), sm3, CODASCA on
     Dirichlet(0.1) shards with the masked average (``--participation 0.75
     --fault-seed 1``: 2 × the CoDA path's payload + 8 B of weight
     lanes), and blocked Shampoo (``--optimizer shampoo_blocked``,
     ``--precond-every 1``, at the launcher's K=4: the executor donates its
     state, so a step holds one 6.0 GB/worker optimizer state plus one
     leaf's temporaries; its peak memory, ms per local step, one step
     from its final state with the kernels against the plain versions, and
     the ms of one refresh, a refresh step against a step that keeps its
     preconditioners).  Counters: auc_loss =
     local steps (objective auc); prox_update or opt_update = local steps ×
     the launches of one step over every leaf (``launch_geometry``: one for
     the mlp's 6 leaves and ResNet50's 153), the other 0; the sketch counts local
     steps × K × B scores.  Finite losses; ms per local step, peak memory
     and optimizer state bytes;
  6. one more window under torch.profiler of mlp, the faulted mlp CODASCA
     path, ResNet50, ResNet50 + momentum and ResNet50 CODASCA (masked):
     device busy time, idle share, the hand-written kernels'
     device time, the top kernels;
  7. the smoke paths again with ``--device cpu``: each test AUC (and the
     test pAUC of pauc_dro, and the quickstart's AUC) within 0.01 of the
     card's;
  8. K4 flash_attention against its plain version (``ref.attention_full``)
     on the card, fp32 within atol 2e-5 + rtol 2e-5 (through
     flash_fwd_tf32x3 at head_dim 64 and 128, its max and mean error printed
     beside SDPA's, its bound 3× the operations at the TF32 rate beside the
     fp32 FFMA bound; through flash_fwd at head_dim 32), bf16 through
     flash_fwd (head_dim 16/32) within one bf16 ulp (rtol 2^-7) + atol
     1e-4, bf16 through flash_fwd_pingpong (head_dim 64/128) within rtol 2^-7
     + atol 2^-9·max|v| + 1e-4 (P rounded to bf16 before P·V) and within
     2× SDPA's max and 1.5× its mean error against the fp32 plain version
     (flash_fwd_wgmma on the same values beside it, through the C entry
     point's variant id: held to the same tolerance, timed, and its largest
     difference from flash_fwd_pingpong printed),
     at stablelm-1.6b's training shape [128, 64, 32, 64] and prefill shape
     [4, 2048, 32, 64] (causal, and with window 256), qwen2.5-14b's GQA
     [1, 2048, 40/8, 128] (and with window 256) and its bf16 prefill shape
     [4, 2048, 40/8, 128], chatglm3-6b's prefill shape [4, 2048, 32/2,
     128], dbrx-132b's [2, 1024, 48/8, 128] (fp32 and bf16) and its
     smoke training shape [128, 64, 4/2, 128] (two heads a block), MQA,
     non-causal S=512 against Skv=2048, a ragged S=1000 (head_dim 64 and
     128) and a smoke width (head_dim 32, fp32 and bf16); each routed to
     the variant ``launch_geometry`` names (its counter checked), timed
     with CUDA events and the profiler (the profiler's time only when it
     recorded every launch the wrapper counted, else CUDA events, marked)
     beside its bound, the plain version and SDPA; the backward against
     autograd through the plain version at the training shape; then K4 at
     rows with no valid key (NO_KEY_CASES: every variant — flash_fwd at
     head_dim 16/32 and an unaligned base, flash_fwd_tf32x3 and
     flash_fwd_pingpong at 64/128, flash_fwd_wgmma beside the latter —
     followed by flash_fill_no_key): every row against the plain version
     under the variant's tolerance, the keyless rows' lse −1e30f bitwise,
     one fill counted a case; the backward there in fp32 and bf16; the fill
     alone at bf16 [4, 4096, 32/8, Skv 1024, 128], window 256, timed beside
     its byte bound and its plain version (0 fills on every path, checked
     at the end);
  9. full-depth fp32 prefills at full width, one replica each:
     stablelm-1.6b (24 layers, 1,644,369,921 parameters, head_dim 64) and
     chatglm3-6b (28 layers, 6,243,588,097 parameters, head_dim 128):
     ``prefill_step`` on [B=4, S=2048] tokens with the kernel and with
     ``impl="ref"`` (scores, last logits and bf16 caches compared), exactly
     one K4 launch per layer, all flash_fwd_tf32x3, ms per prefill,
     tokens/s, peak memory and a profile of one prefill (K4's and the
     GEMMs' shares); then the bf16 prefills: stablelm-1.6b at full depth
     and qwen2.5-14b at full width and depth (48 layers, 14,770,038,785
     parameters, 29.5 GB in bf16, a model no fp32 path could hold), every
     K4 launch flash_fwd_pingpong (24 and 48), held to ``impl="ref"`` under
     the bf16 rule (BF16_NOISE_FACTOR: the distance from ``impl="ref"`` at
     most twice impl="ref"'s own from the same prefill in fp32, each layer's
     weights widened as it runs, plus one bf16 ulp);
 10. stablelm-1.6b CoDA training at full width, depth cut to 2 layers
     (K=4, B=32, S=64, sgd, one stage of 16 local steps) through
     ``train.main`` with exact launch counts of auc_loss, prox_update and
     flash_attention (every K4 launch flash_fwd_tf32x3), and a profiled
     window; the same CoDA path with ``param_dtype=bfloat16`` through
     ``coda.init_state`` and ``coda.fit`` (one local step's losses and every
     gradient leaf held to impl="ref" under the bf16 rule against the fp32
     step; every K4 launch flash_fwd_pingpong, K2 on bf16 leaves); the same
     in bf16 with CODASCA under faults (participation 0.75, stragglers 0.2,
     max_staleness 1: the mixed bf16/f32 buckets, 2 × model_bytes + 8; one
     local step's losses and one masked window's merged parameters held to
     impl="ref" under the bf16 rule; exact launch counts, peak memory, a
     profiled window); and ``--arch
     stablelm-1.6b --smoke`` on the card, its test AUC within 0.01 of the
     same command with ``--device cpu`` (run with the mlp paths' CPU
     twins);
 11. K5 grouped_matmul against its plain version (``ref.grouped_matmul_ref``)
     on the card, fp32 within atol = rtol = 5e-5 and bf16 within one bf16
     ulp + atol 1e-4, at dbrx-132b's decode (N=16, gmm_rows) and prefill
     (N=8192, gmm_tf32x3) expert shapes in fp32 and its prefill
     (gmm_wgmma_m128) and decode (N=16, gmm_wgmma) shapes, gate and down, in
     bf16, arctic-480b's (128 experts, N=8 and 4096, gate and down) in bf16
     (gmm_wgmma), K-folded strided weights in both dtypes (and in bf16 at
     128-200 rows a group, gmm_wgmma_m128), the reference's edge tables,
     N = 1, ragged groups with empty ones and short tails (gmm_tf32x3,
     gmm_wgmma; gmm_wgmma_m128 with 1-, 127-, 128- and 129-row groups, Kd
     off 64 and F off 256), and fp32 and bf16 that TMA cannot read
     (gmm_tiles); at every gmm_wgmma_m128 case gmm_wgmma on the same values,
     timed and held bitwise equal; each
     case's kernel checked against the one ``launch_geometry`` names; group
     sizes from a seeded top-k routing; each timed beside its bound (the hit
     experts' bytes or the operations: fp32 FFMA's and 3xTF32's), the plain
     version and torch._grouped_mm where the installed torch takes the
     inputs, and the row tiles launched beside those holding rows; each
     fp32 case's error against a float64 product, and at dbrx's prefill
     shapes gmm_tiles on the same inputs (x copied to a base off 16 bytes,
     which TMA cannot read) timed and held to the same references beside
     gmm_tf32x3 (run with the kernel checks of phase 3);
 12. dbrx-132b at full width with 2 of 40 layers (7,751,337,985 fp32
     parameters, one replica): ``prefill_step`` on [B=2, S=1024] with the
     kernels and with ``impl="ref"`` (2 K4 and 6 K5 launches per prefill,
     every K4 launch flash_fwd_tf32x3 and every K5 launch gmm_tf32x3;
     scores, logits and caches compared, a profile with the K5, K4 and
     cuBLAS shares); then the same parameters through ``ServingEngine``
     (4 slots, max_len 64, chunk 8, a batch trace of 8 requests) with
     ``impl="auto"`` and ``"ref"``: tokens equal (a flip only at a printed
     near tie), scores within 1e-4, K5 launches = 3 × 2 × serve steps; ms
     per prefill and decode tick, tokens/s, TTFT and latency, a profiled
     decode tick against K5's bound; then the same in bf16 with 4 of 40
     layers (14,269,532,161 parameters, 28.5 GB): the prefill (4 K4
     flash_fwd_pingpong, 12 K5 gmm_wgmma_m128 launches, under the bf16 rule, the
     caches at the positions no routing flip reached) and the engine
     (every K5 launch gmm_wgmma at 1-4 rows an expert; a token
     flip allowed where impl="ref"'s top-2 logit gap is within the bf16
     rule's limit for those logits, the request score logits under the
     bf16 rule against each request's last prompt position in fp32);
     every K5 call of these paths at a shape phase 11 compared;
 13. ``--arch dbrx-132b --smoke`` training (K5 only in eval forwards; every
     K4 launch flash_fwd_tf32x3, two heads a block) and
     ``launch/serve.py --arch dbrx-132b --labeled --metrics sketch`` on the
     card with exact launch counts, against their ``--device cpu`` twins:
     test AUC within 0.01; the printed requests' tokens equal and the served
     AUC within 0.01;
 13b. arctic-480b in bf16 at full width with 2 of 35 layers (27,681,138,689
     parameters, 55.36 GB, drawn a matrix at a time; 128 experts top-2
     beside the dense residual MLP): the prefill on [B=2, S=1024] (2 K4
     flash_fwd_pingpong at 56/8 heads, 6 K5 gmm_wgmma launches) as in phase
     12's bf16 prefill, its fp32 baseline widening the experts one block at
     a time; K5 held to its plain version at the inputs the path's own
     router gives it, in the prefill (~32 rows an expert) and in a serve
     tick (8 rows); the engine as phase 12's bf16 one (6 K5 launches a
     serve step); then phi3-medium-14b in bf16 at full depth and width
     (14,659,512,321 parameters): the prefill on [B=4, S=2048] (40 K4
     flash_fwd_pingpong at 40/10 heads) and the engine (no kernel in decode:
     tokens equal impl='ref''s); each phase's peak memory beside the card's;
 14. the distributed executor (``--executor shard_map``: NCCL over R =
     torch.cuda.device_count() ranks, one a card; R = 1 on one card, so one
     rank holds all K workers and each bucket's all_reduce is a real NCCL
     launch over one rank): the mlp at the launcher's defaults, with
     ``--compress int8``, with ``--overlap --overlap-chunks 4``, as
     CODASCA with ``--participation 0.75 --straggler-prob 0.2 --fault-seed
     3`` and as CODASCA with ``--server-momentum 0.9 --optimizer momentum``
     (opt_update), and ResNet50 at full width (K=4, B=32, one stage of 16
     local steps), each with the launch counts of phase 5, its
     bytes/round/worker the reference launcher's, its collectives the
     reference's contract (a window one all_reduce per dtype bucket of
     window_payload_by_dtype bytes; int8 the s8 + f32 all_gather pair; an
     overlapped pair ring_hop_count hops an averaging, none at R = 1; a
     stage end one all_reduce of its α), its test AUC within 0.01 of the
     same flags on ``--executor vmap`` (the overlapped path beside the
     plain one) and its ms per local step beside it; the mlp paths but the
     overlapped one end with parameters bitwise the vmap path's; ResNet50's
     vmap fit run twice (bitwise or not, printed), then the vmap and the
     sharded fits under ``torch.backends.cudnn.deterministic``, bitwise
     equal, and the sharded fit with ``--overlap --overlap-chunks 4``
     (window pairs, the first averaging under the second window's steps:
     launch counts, the contract, ms per local step beside the sharded
     fit's), then from the sharded fit's final state one overlapped pair
     bitwise the same two windows in sequence and one profiled (the side
     stream's kernel time, the share of it under compute-stream kernels,
     ms per local step against the sequential windows'); one ResNet50
     window through the sharded executor on a one-rank
     NCCL group against the batched executor from the same state (bitwise,
     or the differing leaves printed and held to SHARD_WINDOW_RTOL), and one
     profiled (the NCCL kernels' device time, the idle share); the bf16
     stablelm-1.6b CoDA path (2 layers, full width) through ``coda.fit`` on
     the sharded executor: its window against the batched executor's as
     above, two all_reduces a window (the bf16 and the f32 bucket) of
     window_payload_by_dtype bytes, every K4 launch flash_fwd_pingpong, exact
     K1/K2/K4 launches, its ms per local step the median of 5 steady
     windows beside the batched fit's on the same windows (run after phase
     10's bf16 paths);
 15. the vlm, hybrid and audio families at full width (K4 held against its
     plain version at their shapes in phase 8: internvl2-2b's prefill
     [4, 2048, 16/8, 128] in fp32 and bf16 and its training length 257,
     hymba-1.5b's prefill [2, 4096, 25/5, 64] with and without its 2048
     window in fp32 and bf16 and its training shape [128, 64] (two heads a
     block, odd H), seamless-m4t-medium's encoder [4, 2048] non-causal,
     decoder [4, 512] causal, cross attention 512 over 2048 and its training
     shapes): full-depth prefills of internvl2-2b (256 patches + 1792
     tokens on B=4; fp32 and bf16), hymba-1.5b ([2, 4096]; fp32 and bf16;
     the SSM scan's and the SSM branch's share of device time) and
     seamless-m4t-medium (frames [4, 2048, 1024], 512 tokens; 36 K4
     launches: 12 encoder, 12 self, 12 cross), each against ``impl="ref"``
     as in phase 9; hymba's 32 layers through ``ServingEngine`` (tokens equal
     impl='ref''s, no kernel launched: decode and the SSM step are plain);
     seamless's ``encode_for_decode`` and 64 ``serve_step``s against the
     parallel forward on the same 64 tokens (atol = rtol = 2e-3); the three
     CoDA paths through ``train.main`` at full width with their depth cut
     (internvl2-2b 2 of 24 layers, 257 positions; hymba-1.5b 3 of 32: global,
     windowed, global; seamless-m4t-medium 2 + 2 of 12 + 12) with exact
     K1/K2/K4 launches and one local step's losses and gradients held to
     impl='ref'; and ``--arch internvl2-2b|hymba-1.5b|seamless-m4t-medium
     --smoke`` on the card, each test AUC within 0.01 of the same command
     with ``--device cpu`` (run with the other CPU twins);
 16. the ssm family, xlstm-350m at full width (no attention, so no K4 on
     its paths): full-depth prefills ([B=4, S=2048], 24 layers, fp32 and
     bf16; every launch counter 0, ``kv=None``; ms per prefill, tokens/s,
     peak memory, busy and idle share, and the mLSTM's and sLSTM's shares
     of device time from one profiled layer of each kind; bf16 under the
     bf16 rule against the same prefill on the weights widened to fp32);
     decode against the parallel form (the last logits of a [2, 256] prompt
     through ``prefill_step`` and 256 ``serve_step``s, atol = rtol = 2e-3)
     held on a full-width 3-layer cut (mLSTM, sLSTM, mLSTM) and printed at
     full depth beside the spread of two parallel forms (chunk 64 and 256),
     and ``apply_mlstm`` at chunk 256 against 64 (atol 2e-4, rtol 2e-3); the
     fp32 weights through ``ServingEngine`` as hymba's (tokens equal a
     second, impl='ref' run's but at a top-2 tie); a probe of two sgd steps
     at 24 layers (its gradients printed); the CoDA path through
     ``train.main`` at full width with 8 of 24 layers and ``--eta0 0.002``
     (K=4, B=32, S=64, one stage of 16 local steps, sgd) with exact K1 and
     K2 launches and one local step held to impl='ref'; ``--arch xlstm-350m
     --smoke --optimizer sm3`` (K3) and ``--arch dbrx-132b --smoke
     --optimizer shampoo_blocked`` (one local step a window, the held-out
     AUC after each) on the card, each held to the same command with
     ``--device cpu`` after the first window; and
     ``serving.loadgen.serve_load_report("xlstm-350m")`` on the card;
 17. the program audit on the card (``launch/audit.py``'s matrix, R1–R5:
     the batched and the sharded executor on NCCL at R = 1, serving, the
     kernels through the seam), the bf16 stablelm-1.6b CoDA window and stage
     at full width with 2 of 24 layers (K=4, B=32, S=64; R1–R3, R5's
     auc_loss, prox_update and flash_fwd_pingpong records equal to the
     kernels' own geometry queries, R2's allocated bytes against the new
     state's) and the bf16 dbrx-132b engine on the 4-layer weights of
     phase 12 (R3, R4's two chunk shapes, R5's gmm_wgmma records against
     the query), and R5 at every shape of ``analysis.audit.PATH_SHAPES``
     (every K4 and K5 variant, the five K5 ones included) against the
     kernels' own queries; a finding fails the run.  With it, the dry run's parameter
     bytes of the bf16 stablelm-1.6b weights on a 1 × 1 mesh against the
     bytes the card holds for them (phase 9's weights), and the dry run's
     FLOPs of that prefill beside its measured time;
then the ``{"sharded": {...}}``, ``{"zoo": {...}}``, ``{"ssm": {...}}`` and
``{"audit": {...}}`` lines, the
``{"kernels": [...]}`` line (all five kernels and K4's flash_fill_no_key),
nvidia-smi's line, and the
``{"ok": true, ...}`` line.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Device memory rate (bytes/s) and fp32 peak outside the tensor cores
# (operations/s) by card, from NVIDIA's data sheets (SXM part at 700 W).
CARDS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# dense bf16 tensor-core peak (operations/s), the bound for bf16 inputs;
# the dense TF32 peak is half of it (NVIDIA's data sheet: 495 TFLOP/s on the
# H100 SXM), the rate of flash_fwd_tf32x3's three products per fp32 product
BF16_PEAK = {"H100 PCIe": 756e12, "H100 NVL": 835e12, "H100": 989e12, "H200": 989e12}
TF32_PER_BF16 = 0.5
AUC_OPS_PER_SCORE = 40      # fp32 operations per score in the auc_loss kernel
PROX_OPS_PER_ELEMENT = 6    # 3 mul, 1 sub, 1 add, 1 div
# fp32 operations per element of opt_update: momentum = 1 mul + 1 add + the
# prox step; precond = 1 mul, 2 add, 1 sqrt, 1 div, 1 mul + the prox step.
# (The bf16 store's integer hash, ~12 integer operations, is not fp32 work.)
OPT_OPS_PER_ELEMENT = {"momentum": 2 + PROX_OPS_PER_ELEMENT,
                       "precond": 6 + PROX_OPS_PER_ELEMENT}
MLP_LEAVES, RN_LEAVES = 6, 153
CODASCA_ARGS = ["--algorithm", "codasca", "--dirichlet-alpha", "0.1"]
FAULT_ARGS = ["--participation", "0.75", "--straggler-prob", "0.2", "--straggler-windows", "2",
              "--max-staleness", "2", "--fault-seed", "3"]
RN_ARGS = ["--arch", "resnet50", "--stages", "1", "--t0", "16", "--n-data", "1024"]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str) -> tuple[float, float]:
    for key, rates in CARDS.items():   # most specific names first
        if key in name:
            return rates
    raise SystemExit(f"no memory/compute rates on record for {name!r}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, counts: dict | None = None):
    """Run ``fn`` once under torch.profiler.  Returns (host wall ms, device
    busy ms, {kernel name: device ms summed over its launches}); ``counts``,
    if given, receives the number of recorded launches per kernel name.
    Busy time is the union of the kernels' intervals: cuDNN may run kernels
    of one grouped convolution concurrently, so the per-kernel sum can
    exceed it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per: dict[str, float] = {}
    spans = []
    # the raw kineto events: prof.events() builds the whole CPU/GPU event
    # tree in Python first, ~40× slower (minutes for an sLSTM prefill's
    # ~10^5 launches)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            name = e.name()
            per[name] = per.get(name, 0.0) + e.duration_ns() / 1e6
            if counts is not None:
                counts[name] = counts.get(name, 0) + 1
            spans.append((e.start_ns(), e.end_ns()))
    busy, reach = 0, -1
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return wall, busy / 1e6, per


def kernel_device_ms(fn, tag: str, module, calls: int = 20,
                     kernels_per_launch: int = 1) -> tuple[float, str]:
    """Device time per call of ``fn`` from the profiler (no host time in
    it): the device time of the kernels whose names contain ``tag`` over
    ``calls`` calls.  The profiler has been seen to record fewer launches
    than were made, so its count is held against the wrapper's counter
    (``module.launches``; ``kernels_per_launch`` kernels per counted
    launch, e.g. K5's offset scan and its GEMM): the profiler's time is
    reported only when the two agree (one more try if not), else the
    CUDA-event time of ``calls`` calls.  Returns (ms, "profiler" or
    "cuda_events")."""
    for _ in range(2):
        n: dict[str, int] = {}
        before = module.launches
        _, _, per = device_profile(lambda: [fn() for _ in range(calls)], n)
        made = (module.launches - before) * kernels_per_launch
        seen = sum(c for k, c in n.items() if tag in k)
        if seen == made and made > 0:
            return sum(v for k, v in per.items() if tag in k) / calls, "profiler"
        print(f"profiler: recorded {seen} of {made} launches of {tag}")
    print(f"profiler: {tag} timed with CUDA events instead")
    return cuda_ms(fn, iters=calls), "cuda_events"


def dev_txt(ms: float, source: str, unit: str = "ms") -> str:
    """A device time for the log, marked when it is CUDA-event time."""
    scale = 1e3 if unit == "us" else 1.0
    what = "device" if source == "profiler" else "CUDA events"
    return f"{what} {ms * scale:.{2 if unit == 'us' else 4}f} {unit}"


def bound_ms(n_bytes: float, n_ops: float, rates) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / rates[0] * 1e3, n_ops / rates[1] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_peak(name: str) -> float:
    for key, rate in BF16_PEAK.items():   # most specific names first
        if key in name:
            return rate
    raise SystemExit(f"no bf16 peak on record for {name!r}")


def check_auc_loss(dev, rates, gen):
    """K1 against its plain version (atol 1e-5 + rtol 1e-4) and bitwise
    equal from call to call, at the main path's [4, 32], ragged T, T over
    several blocks and over 32 blocks (the ticket path); one kernel per
    call (the profiler's count held to the wrapper's)."""
    from repro_torch.kernels import auc_loss as K1
    from repro_torch.kernels import ref
    from repro_torch.kernels.auc_loss import auc_loss
    atol, rtol = 1e-5, 1e-4
    rows = []
    for K, T in ((1, 7), (4, 100), (4, 513), (4, 32), (8, 4096), (2, 65536)):
        h = torch.rand((K, T), generator=gen).to(dev)
        y = (torch.rand((K, T), generator=gen) < 0.71).float().to(dev)
        a, b, al = (torch.randn((K,), generator=gen).mul(0.3).to(dev)
                    for _ in range(3))
        got = auc_loss(h, y, a, b, al, 0.71)
        want = ref.auc_loss_ref(h, y, a, b, al, 0.71)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ok = all(bool(((g - w).abs() <= atol + rtol * w.abs()).all())
                 for g, w in zip(got, want))
        again = auc_loss(h, y, a, b, al, 0.71)
        stable = all(bool(torch.equal(g, x)) for g, x in zip(got, again))
        if not (ok and stable):
            raise SystemExit(f"auc_loss [{K},{T}] disagrees with its plain "
                             f"version: max_abs_err={err} stable={stable}")
        ms = cuda_ms(lambda: auc_loss(h, y, a, b, al, 0.71))
        plain = cuda_ms(lambda: ref.auc_loss_ref(h, y, a, b, al, 0.71))
        dev_ms, dev_src = kernel_device_ms(lambda: auc_loss(h, y, a, b, al, 0.71),
                                           "auc_loss", K1)
        bnd, by = bound_ms(12 * K * T + 28 * K, AUC_OPS_PER_SCORE * K * T, rates)
        rows.append({"shape": [K, T], "ticket": K1.launch_geometry(K, T)["ticket"],
                     "max_abs_err": err, "ms": ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src,
                     "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"auc_loss [{K},{T}]: max_abs_err={err:.3g} (atol {atol}, rtol "
              f"{rtol}) kernel {ms * 1e3:.2f} us ({dev_txt(dev_ms, dev_src, 'us')}), "
              f"plain {plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    return rows


def check_prox_update(dev, rates, gen):
    from repro_torch.kernels import prox_update as K2
    from repro_torch.kernels import ref
    from repro_torch.kernels.prox_update import prox_update
    K = 4
    leaf_sizes = resnet_leaf_sizes()
    # (n, dtype of v and v0, dtype of g): g in fp32 under bf16 parameters is
    # blocked Shampoo's step
    cases = [(n, dt, dt) for n in (5, 1000, 4097, K * max(leaf_sizes))
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(n, torch.bfloat16, torch.float32) for n in (4097, K * max(leaf_sizes))]
    rows = []
    for n, dt, gdt in cases:
        v, g, v0 = (torch.randn((n,), generator=gen).to(dev, t) for t in (dt, gdt, dt))
        got = prox_update(v, g, v0, 0.05, 0.5)
        want = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
        torch.cuda.synchronize()
        tol = 0.0   # bitwise: the same fp32 operations in the same order
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != dt or not torch.equal(got, want):
            raise SystemExit(f"prox_update n={n} {dt} (g {gdt}) is not bitwise its plain "
                             f"version: max_abs_err={err}")
        ms = cuda_ms(lambda: prox_update(v, g, v0, 0.05, 0.5))
        plain = cuda_ms(lambda: ref.prox_update_ref(v, g, v0, 0.05, 0.5))
        dev_ms, dev_src = kernel_device_ms(lambda: prox_update(v, g, v0, 0.05, 0.5),
                                           "prox_update", K2)
        bnd, by = bound_ms(n * (3 * v.element_size() + g.element_size()),
                           PROX_OPS_PER_ELEMENT * n, rates)
        dname = str(dt).replace("torch.", "") + ("" if gdt == dt else " (g float32)")
        rows.append({"shape": [n], "dtype": dname, "max_abs_err": err,
                     "tol": tol, "ms": ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "plain_ms": plain,
                     "bound_ms": bnd, "bound_by": by})
        print(f"prox_update n={n} {dname}: max_abs_err={err:.3g} (bitwise) "
              f"kernel {ms * 1e3:.2f} us ({dev_txt(dev_ms, dev_src, 'us')}), plain "
              f"{plain * 1e3:.2f} us, bound {bnd * 1e3:.3f} us ({by})")
    # a local step's leaves as one launch: ResNet50's 153 (fp32), bf16
    # stablelm-1.6b's 17 at 2 layers (bf16 matrices beside fp32 norms), and
    # the same with an fp32 step (blocked Shampoo under bf16 parameters)
    for what, tree, gf32 in (("resnet50 step", "resnet50", False),
                             ("bf16 stablelm-1.6b 2-layer step", "stablelm-1.6b:2:bfloat16",
                              False),
                             ("bf16 stablelm-1.6b 2-layer step, fp32 step",
                              "stablelm-1.6b:2:bfloat16", True)):
        rows.append(leaf_set_case("prox_update", what, tree, None, rates, dev, gf32=gf32))
    return rows


def resnet_leaf_sizes():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    return [l.numel() for l in tree_leaves(M.init_params(get_config("resnet50")))]


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def check_opt_update(dev, rates, gen):
    """opt_update against its plain version: bitwise in every mode and dtype,
    the bf16 buffer's stochastic-rounding bits included; and at coef = 0
    with an fp32 buffer, bitwise prox_update."""
    from repro_torch.kernels import opt_update as K3
    from repro_torch.kernels import ref
    from repro_torch.kernels.opt_update import opt_update
    from repro_torch.kernels.prox_update import prox_update
    K = 4
    leaf_sizes = resnet_leaf_sizes()
    big = K * max(leaf_sizes)
    f32, bf16 = torch.float32, torch.bfloat16
    variants = [("momentum", f32, f32), ("momentum", f32, bf16), ("precond", f32, f32)]
    cases = [(n, *v) for n in (5, 1000, 4097, big) for v in variants]
    cases += [(big, "momentum", bf16, bf16), (big, "precond", bf16, f32)]
    seed = torch.tensor([0x9E3779B9 ^ 0x85EBCA6B], dtype=torch.int64, device=dev)
    rows = []
    for n, mode, vdt, bdt in cases:
        v, g, v0, b = (torch.randn((n,), generator=gen) for _ in range(4))
        v, g, v0 = (t.to(dev, vdt) for t in (v, g, v0))
        b = (b.abs() if mode == "precond" else b).to(dev, bdt)
        coef = 0.9 if mode == "momentum" else 1e-6
        args = (v, g, v0, b, 0.05, 0.5, coef, seed)
        got = opt_update(*args, mode=mode)
        want = ref.opt_update_ref(*args, mode=mode)
        torch.cuda.synchronize()
        err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
        if not all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
                   for x, y in zip(got, want)):
            raise SystemExit(f"opt_update n={n} {mode} v {vdt} buf {bdt} is not "
                             f"bitwise its plain version: max_abs_err={err}")
        if mode == "momentum" and bdt == f32 and vdt == f32:
            nv, nm = opt_update(v, g, v0, torch.zeros_like(b), 0.05, 0.5, 0.0, seed,
                                mode="momentum")
            if not (torch.equal(nv, prox_update(v, g, v0, 0.05, 0.5)) and torch.equal(nm, g)):
                raise SystemExit(f"opt_update n={n} at coef=0 is not prox_update bitwise")
        ms = cuda_ms(lambda: opt_update(*args, mode=mode))
        plain = cuda_ms(lambda: ref.opt_update_ref(*args, mode=mode), iters=10)
        dev_ms, dev_src = kernel_device_ms(lambda: opt_update(*args, mode=mode),
                                           "opt_update", K3)
        nbytes = n * (4 * v.element_size() + 2 * b.element_size())
        bnd, by = bound_ms(nbytes, OPT_OPS_PER_ELEMENT[mode] * n, rates)
        name = lambda d: str(d).replace("torch.", "")
        rows.append({"shape": [n], "mode": mode, "dtype": name(vdt), "buf_dtype": name(bdt),
                     "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "plain_ms": plain, "bound_ms": bnd,
                     "bound_by": by})
        print(f"opt_update n={n} {mode} v {name(vdt)} buf {name(bdt)}: bitwise "
              f"(max_abs_err={err:.3g}) kernel {ms * 1e3:.2f} us "
              f"({dev_txt(dev_ms, dev_src, 'us')}), plain {plain * 1e3:.2f} us, bound "
              f"{bnd * 1e3:.3f} us ({by})")
    # a local step's leaves as one launch, in every mode and dtype: ResNet50's
    # 153 with a bf16 and an fp32 momentum buffer and SM3's fp32 covers, and
    # bf16 stablelm-1.6b's 17 at 2 layers (bf16 and fp32 leaves) with a bf16
    # momentum buffer and with fp32 covers
    for what, tree, mode in (("resnet50 step", "resnet50+bf16buf", "momentum"),
                             ("resnet50 step", "resnet50", "momentum"),
                             ("resnet50 step", "resnet50", "precond"),
                             ("bf16 stablelm-1.6b 2-layer step", "stablelm-1.6b:2:bfloat16+bf16buf",
                              "momentum"),
                             ("bf16 stablelm-1.6b 2-layer step", "stablelm-1.6b:2:bfloat16",
                              "precond")):
        rows.append(leaf_set_case("opt_update", what, tree, mode, rates, dev))
    return rows


# the plain version's elements at a time in the leaf-set checks
PLAIN_CHUNK = 1 << 26


def leaf_set_case(kernel: str, what: str, tree: str, mode, rates, dev, *,
                  gf32: bool = False) -> dict:
    """K2 (``prox_update``) or K3 (``opt_update`` in ``mode``) over one local
    step's leaves at K=4 (``analysis.audit.step_leaves``; ``gf32``: K2's g in
    fp32 under bf16 leaves), drawn on the card: one launch (the wrapper's
    counter and ``launch_geometry`` both say so), out of place and in place,
    each bitwise the plain version leaf by leaf (bf16 bits compared as
    int16), the in-place results in the memory given.  Timed in place (what
    a donating executor launches) and out of place with CUDA events and the
    profiler, beside the same leaves as one-leaf tables (a launch each, in
    place), the plain version (at most ``PLAIN_CHUNK`` elements a call) and
    the bound."""
    from repro_torch.analysis.audit import step_leaves
    from repro_torch.core.optimizer import leaf_seeds
    from repro_torch.kernels import opt_update as K3
    from repro_torch.kernels import prox_update as K2
    from repro_torch.kernels import ref
    mod = K2 if kernel == "prox_update" else K3
    spec = step_leaves(kernel, tree)
    dtypes = {c: d for d, c in mod.CODES.items()}
    codes = [2 if gf32 and c == 1 else c for c in spec["codes"]]
    cg = torch.Generator(device=dev).manual_seed(len(codes))
    draw = lambda n, dt: torch.randn((n,), generator=cg, device=dev).to(dt)
    geo = mod.launch_geometry(spec["sizes"], codes)
    leaves = []
    for n, c in zip(spec["sizes"], codes):
        vdt, xdt = dtypes[c]
        if kernel == "prox_update":
            leaves.append((draw(n, vdt), draw(n, xdt), draw(n, vdt)))
        else:
            buf = draw(n, F32).abs() if mode == "precond" else draw(n, F32)
            leaves.append((draw(n, vdt), draw(n, vdt), draw(n, vdt), buf.to(xdt)))
    cols = [list(c) for c in zip(*leaves)]
    del leaves
    coef = 0.9 if mode == "momentum" else 1e-6
    seeds = leaf_seeds(torch.full((4,), 7, dtype=torch.int32, device=dev), len(codes))
    if kernel == "prox_update":
        args, kw = (0.05, 0.5), {}
        multi = lambda c, **k: K2.prox_update_multi(*c, *args, **k)
        one = lambda c, i, **k: K2.prox_update(*(x[i] for x in c), *args, **k)
        plain = lambda xs, i: (ref.prox_update_ref(*xs, *args),)
    else:
        args, kw = (0.05, 0.5, coef), {"mode": mode}
        multi = lambda c, **k: K3.opt_update_multi(*c, *args, seeds, **kw, **k)
        one = lambda c, i, **k: K3.opt_update(*(x[i] for x in c), *args, seeds[i:i + 1],
                                              **kw, **k)
        plain = lambda xs, i: ref.opt_update_ref(*xs, *args, seeds[i], **kw)

    def pieces(i):
        """Leaf i's flat element ranges: the plain version is elementwise, so
        it runs on at most PLAIN_CHUNK elements at a time (a bf16 embedding
        leaf's int64 rounding temporaries would not fit whole)."""
        n = spec["sizes"][i]
        return [slice(a, min(n, a + PLAIN_CHUNK)) for a in range(0, n, PLAIN_CHUNK)]

    def matches(results) -> bool:
        """``results`` (a list a written column) bitwise the plain version,
        leaf by leaf, piece by piece."""
        for i in range(len(codes)):
            for sl in pieces(i):
                want = plain([x[i].reshape(-1)[sl] for x in cols], i)
                if not all(same(r[i].reshape(-1)[sl], w) for r, w in zip(results, want)):
                    return False
        return True

    same = lambda a, b: a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    before = mod.launches
    got = multi(cols)
    launched = mod.launches - before
    ok = matches([got] if kernel == "prox_update" else list(got))
    del got
    # the written columns: v, and K3's buffer
    writable = [[t.clone() for t in cols[j]] for j in ((0,) if kernel == "prox_update"
                                                        else (0, 3))]
    inplace_cols = ([writable[0], *cols[1:]] if kernel == "prox_update"
                    else [writable[0], cols[1], cols[2], writable[1]])
    res = multi(inplace_cols, inplace=True)
    res = [res] if kernel == "prox_update" else list(res)
    ok_in = all(r is w for col_r, col_w in zip(res, writable) for r, w in zip(col_r, col_w)) \
        and matches(writable)
    torch.cuda.synchronize()
    del res
    label = f"{kernel} {what}" + (f" {mode}" if mode else "") + (" (g float32)" if gf32 else "")
    if not (ok and ok_in and launched == geo["launches"] == 1):
        raise SystemExit(f"{label}: {launched} launches (geometry {geo['launches']}), bitwise "
                         f"out of place {ok}, in place {ok_in}")
    def out_of_place():      # the fresh outputs go before the next call
        multi(cols)

    ms = cuda_ms(lambda: multi(inplace_cols, inplace=True), iters=20)
    out_ms = cuda_ms(out_of_place, iters=20)
    dev_ms, dev_src = kernel_device_ms(lambda: multi(inplace_cols, inplace=True),
                                       "update_multi_kernel", mod, calls=5)
    out_dev, out_src = kernel_device_ms(out_of_place, "update_multi_kernel", mod, calls=5)
    sweep = lambda: [one(inplace_cols, i, inplace=True) for i in range(len(codes))]
    leaf_ms = cuda_ms(sweep, iters=10)
    leaf_dev, leaf_src = kernel_device_ms(sweep, "update_multi_kernel", mod, calls=3)

    def plain_step():
        for i in range(len(codes)):
            for sl in pieces(i):
                plain([x[i].reshape(-1)[sl] for x in cols], i)
    plain_ms = cuda_ms(plain_step, iters=3, warmup=1)
    elements = sum(spec["sizes"])
    size = lambda dt: torch.finfo(dt).bits // 8
    if kernel == "prox_update":
        nbytes = sum(n * (3 * size(dtypes[c][0]) + size(dtypes[c][1]))
                     for n, c in zip(spec["sizes"], codes))
        ops = PROX_OPS_PER_ELEMENT * elements
    else:
        nbytes = sum(n * (4 * size(dtypes[c][0]) + 2 * size(dtypes[c][1]))
                     for n, c in zip(spec["sizes"], codes))
        ops = OPT_OPS_PER_ELEMENT[mode] * elements
    bnd, by = bound_ms(nbytes, ops, rates)
    name = lambda d: str(d).replace("torch.", "")
    row = {"kernel": kernel, "variant": geo["kernel"], "what": what, "mode": mode,
           "leaves": len(codes), "codes": sorted(set(codes)),
           "dtypes": sorted({"/".join(map(name, dtypes[c])) for c in codes}),
           "shape": [elements], "launches": launched, "max_abs_err": 0.0,
           "ms": ms, "device_ms": dev_ms, "device_ms_source": dev_src,
           "out_of_place_ms": out_ms, "out_of_place_device_ms": out_dev,
           "out_of_place_device_ms_source": out_src, "per_leaf_ms": leaf_ms,
           "per_leaf_device_ms": leaf_dev, "per_leaf_device_ms_source": leaf_src,
           "per_leaf_launches": len([n for n in spec["sizes"] if n]), "plain_ms": plain_ms,
           "bound_ms": bnd, "bound_by": by, "grid": geo["grid"][0]}
    print(f"{label} ({len(codes)} leaves, {elements:,} elements, codes {row['codes']}): one "
          f"launch, bitwise the plain version out of place and in place; in place {ms:.3f} "
          f"ms ({dev_txt(dev_ms, dev_src)}), out of place {out_ms:.3f} ms "
          f"({dev_txt(out_dev, out_src)}); one-leaf tables ({row['per_leaf_launches']} "
          f"launches) {leaf_ms:.3f} ms ({dev_txt(leaf_dev, leaf_src)}); plain {plain_ms:.3f} "
          f"ms; bound {bnd:.4f} ms ({by})")
    del cols, inplace_cols, writable
    torch.cuda.empty_cache()
    return row


def check_inplace_updates(dev, rates, gen):
    """K2's and K3's in-place forms (``inplace=True``: the result written
    into v, and K3's new buffer into the buffer; what a donating executor's
    local step launches) at ResNet50's largest leaf × K=4, fp32 and bf16:
    bitwise their out-of-place forms and their plain versions, and in the
    memory they were given; each timed beside the out-of-place form (CUDA
    events and the profiler), with the same bound (the same bytes move).
    Returns rows for the kernels line's ``shapes`` (``"form": "inplace"``)."""
    from repro_torch.kernels import opt_update as K3
    from repro_torch.kernels import prox_update as K2
    from repro_torch.kernels import ref
    n = 4 * max(resnet_leaf_sizes())
    f32, bf16 = torch.float32, torch.bfloat16
    name = lambda d: str(d).replace("torch.", "")
    rows = []
    for dt, gdt in ((f32, f32), (bf16, bf16), (bf16, f32)):
        v, g, v0 = (torch.randn((n,), generator=gen).to(dev, t) for t in (dt, gdt, dt))
        want = K2.prox_update(v, g, v0, 0.05, 0.5)
        plain = ref.prox_update_ref(v, g, v0, 0.05, 0.5)
        vi = v.clone()
        got = K2.prox_update(vi, g, v0, 0.05, 0.5, inplace=True)
        torch.cuda.synchronize()
        if not (got is vi and torch.equal(got, want) and torch.equal(got, plain)):
            raise SystemExit(f"prox_update in place n={n} {dt} (g {gdt}) is not bitwise its "
                             "out-of-place form and its plain version")
        ms = cuda_ms(lambda: K2.prox_update(vi, g, v0, 0.05, 0.5, inplace=True))
        out_ms = cuda_ms(lambda: K2.prox_update(v, g, v0, 0.05, 0.5))
        dev_ms, dev_src = kernel_device_ms(
            lambda: K2.prox_update(vi, g, v0, 0.05, 0.5, inplace=True),
            "prox_update_multi_kernel", K2)
        out_dev, out_src = kernel_device_ms(lambda: K2.prox_update(v, g, v0, 0.05, 0.5),
                                            "prox_update_multi_kernel", K2)
        bnd, by = bound_ms(n * (3 * v.element_size() + g.element_size()),
                           PROX_OPS_PER_ELEMENT * n, rates)
        dname = name(dt) + ("" if gdt == dt else " (g float32)")
        rows.append({"kernel": "prox_update", "form": "inplace", "what": "in place",
                     "shape": [n], "dtype": dname, "max_abs_err": 0.0, "ms": ms,
                     "out_of_place_ms": out_ms, "device_ms": dev_ms,
                     "device_ms_source": dev_src, "out_of_place_device_ms": out_dev,
                     "out_of_place_device_ms_source": out_src, "bound_ms": bnd,
                     "bound_by": by})
        print(f"prox_update in place n={n} {dname}: bitwise the out-of-place form and the "
              f"plain version; kernel {ms * 1e3:.2f} us ({dev_txt(dev_ms, dev_src, 'us')}), "
              f"out of place {out_ms * 1e3:.2f} us ({dev_txt(out_dev, out_src, 'us')}), "
              f"bound {bnd * 1e3:.3f} us ({by})")
        del v, g, v0, vi, want, plain
    seed = torch.tensor([0x9E3779B9 ^ 0x85EBCA6B], dtype=torch.int64, device=dev)
    for mode, vdt, bdt in (("momentum", f32, f32), ("momentum", f32, bf16),
                           ("momentum", bf16, bf16), ("precond", f32, f32),
                           ("precond", bf16, f32)):
        v, g, v0, b = (torch.randn((n,), generator=gen) for _ in range(4))
        v, g, v0 = (t.to(dev, vdt) for t in (v, g, v0))
        b = (b.abs() if mode == "precond" else b).to(dev, bdt)
        coef = 0.9 if mode == "momentum" else 1e-6
        want = K3.opt_update(v, g, v0, b, 0.05, 0.5, coef, seed, mode=mode)
        plain = ref.opt_update_ref(v, g, v0, b, 0.05, 0.5, coef, seed, mode=mode)
        vi, bi = v.clone(), b.clone()
        got = K3.opt_update(vi, g, v0, bi, 0.05, 0.5, coef, seed, mode=mode, inplace=True)
        torch.cuda.synchronize()
        if not (got[0] is vi and got[1] is bi and all(
                torch.equal(_bits(x), _bits(y)) and torch.equal(_bits(x), _bits(z))
                for x, y, z in zip(got, want, plain))):
            raise SystemExit(f"opt_update in place n={n} {mode} v {vdt} buf {bdt} is not "
                             "bitwise its out-of-place form and its plain version")
        ms = cuda_ms(lambda: K3.opt_update(vi, g, v0, bi, 0.05, 0.5, coef, seed, mode=mode,
                                           inplace=True))
        out_ms = cuda_ms(lambda: K3.opt_update(v, g, v0, b, 0.05, 0.5, coef, seed, mode=mode))
        dev_ms, dev_src = kernel_device_ms(
            lambda: K3.opt_update(vi, g, v0, bi, 0.05, 0.5, coef, seed, mode=mode,
                                  inplace=True), "opt_update_multi_kernel", K3)
        out_dev, out_src = kernel_device_ms(
            lambda: K3.opt_update(v, g, v0, b, 0.05, 0.5, coef, seed, mode=mode),
            "opt_update_multi_kernel", K3)
        bnd, by = bound_ms(n * (4 * v.element_size() + 2 * b.element_size()),
                           OPT_OPS_PER_ELEMENT[mode] * n, rates)
        rows.append({"kernel": "opt_update", "form": "inplace", "what": "in place",
                     "shape": [n], "mode": mode, "dtype": name(vdt), "buf_dtype": name(bdt),
                     "max_abs_err": 0.0, "ms": ms, "out_of_place_ms": out_ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src,
                     "out_of_place_device_ms": out_dev, "out_of_place_device_ms_source": out_src,
                     "bound_ms": bnd, "bound_by": by})
        print(f"opt_update in place n={n} {mode} v {name(vdt)} buf {name(bdt)}: bitwise the "
              f"out-of-place form and the plain version; kernel {ms * 1e3:.2f} us "
              f"({dev_txt(dev_ms, dev_src, 'us')}), out of place {out_ms * 1e3:.2f} us "
              f"({dev_txt(out_dev, out_src, 'us')}), bound {bnd * 1e3:.3f} us ({by})")
        del v, g, v0, b, vi, bi, want, plain
    print(json.dumps({"inplace": rows}))
    return rows


F32, BF16 = torch.float32, torch.bfloat16
# (label, B, S, H, KV, Skv, hd, causal, window, dtype): stablelm-1.6b's
# training shape (K·B = 128 sequences of 64 tokens) and prefill shape,
# qwen2.5-14b's GQA, chatglm3-6b's and dbrx-132b's prefill shapes, the dbrx
# smoke training shape, MQA, cross-shaped, windowed and ragged cases, and a
# smoke width; the bf16 cases at head_dim 64/128 run flash_fwd_pingpong (two
# heads a block where S, Skv <= 64) with flash_fwd_wgmma beside it on the
# same values, the fp32 cases at head_dim 64/128 flash_fwd_tf32x3 (two heads
# a block where S, Skv <= 64), head_dim 32 flash_fwd
ATTN_CASES = [
    ("stablelm_train", 128, 64, 32, 32, 64, 64, True, None, F32),
    ("stablelm_train_bf16", 128, 64, 32, 32, 64, 64, True, None, BF16),
    ("stablelm_prefill", 4, 2048, 32, 32, 2048, 64, True, None, F32),
    ("stablelm_prefill_bf16", 4, 2048, 32, 32, 2048, 64, True, None, BF16),
    ("stablelm_prefill_window256", 4, 2048, 32, 32, 2048, 64, True, 256, F32),
    ("stablelm_prefill_window256_bf16", 4, 2048, 32, 32, 2048, 64, True, 256, BF16),
    ("qwen_gqa", 1, 2048, 40, 8, 2048, 128, True, None, F32),
    ("qwen_gqa_bf16", 1, 2048, 40, 8, 2048, 128, True, None, BF16),
    ("qwen_gqa_window256", 1, 2048, 40, 8, 2048, 128, True, 256, F32),
    ("qwen_prefill_bf16", 4, 2048, 40, 8, 2048, 128, True, None, BF16),
    ("chatglm_prefill", 4, 2048, 32, 2, 2048, 128, True, None, F32),
    ("dbrx_prefill", 2, 1024, 48, 8, 1024, 128, True, None, F32),
    ("dbrx_prefill_bf16", 2, 1024, 48, 8, 1024, 128, True, None, BF16),
    ("dbrx_smoke_train", 128, 64, 4, 2, 64, 128, True, None, F32),
    ("mqa", 2, 1024, 16, 1, 1024, 64, True, None, F32),
    ("mqa_hd128_bf16", 2, 1024, 16, 1, 1024, 128, True, None, BF16),
    ("noncausal_skv2048", 2, 512, 8, 8, 2048, 64, False, None, F32),
    ("noncausal_skv2048_hd128", 2, 512, 8, 8, 2048, 128, False, None, F32),
    ("ragged_s1000", 2, 1000, 8, 8, 1000, 64, True, None, F32),
    ("ragged_s1000_hd128", 2, 1000, 8, 8, 1000, 128, True, None, F32),
    ("ragged_s1000_hd128_bf16", 2, 1000, 8, 8, 1000, 128, True, None, BF16),
    ("smoke_hd32", 2, 256, 8, 2, 256, 32, True, None, F32),
    ("smoke_hd32_bf16", 2, 256, 8, 2, 256, 32, True, None, BF16),
    # the vlm, hybrid and audio paths: internvl2-2b's prefill (GQA 16/8 at
    # head_dim 128) and its training sequence of 256 patches + 1 token (a
    # ragged last query tile); hymba-1.5b's prefill (25/5 heads of 64; its
    # windowed layers' 2048 band inside S = 4096) and training shape (two
    # heads a block, odd H: the last block holds one head, and pairs straddle
    # KV groups); seamless-m4t-medium's non-causal encoder, causal decoder and
    # cross attention (S 512 over Skv 2048), and its training shapes
    ("internvl_prefill", 4, 2048, 16, 8, 2048, 128, True, None, F32),
    ("internvl_prefill_bf16", 4, 2048, 16, 8, 2048, 128, True, None, BF16),
    ("internvl_train", 128, 257, 16, 8, 257, 128, True, None, F32),
    ("hymba_prefill", 2, 4096, 25, 5, 4096, 64, True, None, F32),
    ("hymba_prefill_window2048", 2, 4096, 25, 5, 4096, 64, True, 2048, F32),
    ("hymba_prefill_bf16", 2, 4096, 25, 5, 4096, 64, True, None, BF16),
    ("hymba_prefill_window2048_bf16", 2, 4096, 25, 5, 4096, 64, True, 2048, BF16),
    ("hymba_train", 128, 64, 25, 5, 64, 64, True, None, F32),
    ("seamless_encoder", 4, 2048, 16, 16, 2048, 64, False, None, F32),
    ("seamless_decoder", 4, 512, 16, 16, 512, 64, True, None, F32),
    ("seamless_cross", 4, 512, 16, 16, 2048, 64, False, None, F32),
    ("seamless_train_encoder", 128, 64, 16, 16, 64, 64, False, None, F32),
    ("seamless_train_decoder", 128, 16, 16, 16, 16, 64, True, None, F32),
    ("seamless_train_cross", 128, 16, 16, 16, 64, 64, False, None, F32),
    # arctic-480b's prefill (56/8 heads: a GQA group of 7) and phi3-medium-14b's
    # (40/10: a group of 4), both bf16 at head_dim 128
    ("arctic_prefill_bf16", 2, 1024, 56, 8, 1024, 128, True, None, BF16),
    ("phi3_prefill_bf16", 4, 2048, 40, 10, 2048, 128, True, None, BF16),
]
# (atol, rtol): fp32 is the reference's own; bf16 through flash_fwd (head_dim
# 16/32): kernel and plain version both compute in fp32 and round once, so
# one bf16 ulp (≤ 2^-7 of the value) plus fp32 noise near zero
ATTN_TOL = {F32: (2e-5, 2e-5), BF16: (1e-4, 2 ** -7)}
# bf16 through flash_fwd_pingpong (and flash_fwd_wgmma beside it): each
# rounds each probability to bf16 before
# P·V (relative error ≤ 2^-9), as every tensor-core attention does; the
# weights sum to 1, so an output moves by at most 2^-9·max|v|; then the one
# ulp of the final rounding: atol = ATTN_P_ROUND·max|v| + 1e-4, rtol 2^-7.
# Beside it, the kernel's max and mean error against the fp32 plain version
# stay within 2× and 1.5× SDPA's own on the same inputs.
ATTN_P_ROUND = 2 ** -9
ATTN_SDPA_MAX, ATTN_SDPA_MEAN = 2.0, 1.5
LSE_ATOL = 1e-4                      # log-sum-exp of O(10) values in fp32
ATTN_BWD_TOL = 5e-5                  # atol = rtol, as tests/test_torch_attention.py


def attn_pairs(S: int, Skv: int, causal: bool, window) -> int:
    """(query, key) pairs inside the mask: the work this call's data needs."""
    from repro_torch.kernels import ref
    return int(ref._mask(torch.arange(S), torch.arange(Skv), causal, window).sum())


def sdpa_fn(q, k, v, causal: bool, window):
    """One ``scaled_dot_product_attention`` call on the same inputs (heads
    second; ``enable_gqa`` for GQA; an explicit boolean mask for the
    window).  Timed as the library yardstick only: the port never calls it."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    pos = lambda n: torch.arange(n, device=q.device)
    mask = ref._mask(pos(q.shape[1]), pos(k.shape[1]), causal, window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=gqa)


def wgmma_attention_beside(label: str, q, k, v, kw: dict, o, want, want_lse, atol: float,
                           rtol: float) -> dict:
    """flash_fwd_wgmma on the values a flash_fwd_pingpong case ran, through
    the C entry point's variant id (``fa._launch``, uncounted): held to the
    plain version under the same tolerance, its largest difference from
    flash_fwd_pingpong's output, CUDA-event and device time."""
    import types

    from repro_torch.kernels import flash_attention as fa
    ow, lw = fa._launch("flash_fwd_wgmma", q, k, v, kw["causal"], kw["window"])
    diff = (ow.float() - want.float()).abs()
    lse_err = float((lw - want_lse).abs().max())
    if not (bool((diff <= atol + rtol * want.float().abs()).all()) and lse_err <= LSE_ATOL):
        raise SystemExit(f"flash_attention {label}: flash_fwd_wgmma disagrees with the plain "
                         f"version: max_abs_err={float(diff.max())}, lse err {lse_err}")
    counted = types.SimpleNamespace(launches=0)

    def call():
        counted.launches += 1
        return fa._launch("flash_fwd_wgmma", q, k, v, kw["causal"], kw["window"])

    ms = cuda_ms(call, iters=20)
    dev_ms, src = kernel_device_ms(call, "flash_fwd_wgmma", counted, calls=5)
    return {"kernel": "flash_fwd_wgmma", "max_abs_err": float(diff.max()),
            "lse_max_abs_err": lse_err, "max_abs_diff_vs_pingpong":
            float((ow.float() - o.float()).abs().max()), "ms": ms, "device_ms": dev_ms,
            "device_ms_source": src}


def check_flash_attention(dev, rates, bf16_rate, gen):
    """K4 against its plain version at each case: output within ATTN_TOL,
    log-sum-exp within LSE_ATOL; CUDA-event time, device time, bound, the
    plain version's time and SDPA's; at each flash_fwd_pingpong case
    flash_fwd_wgmma on the same values beside it (``wgmma_attention_beside``).
    Then the backward at the training shape against autograd through the
    plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    rows = []
    for label, B, S, H, KV, Skv, hd, causal, window, dt in ATTN_CASES:
        q = torch.randn((B, S, H, hd), generator=gen).to(dev, dt)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen).to(dev, dt) for _ in range(2))
        kw = dict(causal=causal, window=window)
        variant = fa.launch_geometry(B, S, H, KV, Skv, hd, dt)["kernel"]
        before = fa.variant_launches[variant]
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        want, want_lse = ref.attention_full(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        if fa.variant_launches[variant] != before + 1:
            raise SystemExit(f"flash_attention {label}: {variant} was not launched")
        atol, rtol = ATTN_TOL[dt]
        if variant == "flash_fwd_pingpong":
            atol = ATTN_P_ROUND * float(v.float().abs().max()) + ATTN_TOL[BF16][0]
        diff = (o.float() - want.float()).abs()
        err = float(diff.max())
        lse_err = float((lse - want_lse).abs().max())
        if not (bool((diff <= atol + rtol * want.float().abs()).all()) and lse_err <= LSE_ATOL):
            raise SystemExit(f"flash_attention {label} disagrees with its plain version: "
                             f"max_abs_err={err} (atol {atol}, rtol {rtol}), lse err {lse_err}")
        beside = {}
        if variant == "flash_fwd_pingpong":
            beside = {"wgmma": wgmma_attention_beside(label, q, k, v, kw, o, want, want_lse,
                                                      atol, rtol)}
        lib = sdpa_fn(q, k, v, causal, window)
        if dt == BF16:
            # kernel and SDPA against the fp32 plain version on the same bf16 inputs
            exact = ref.attention_full(q.float(), k.float(), v.float(), **kw)
            de = (o.float() - exact).abs()
            ds = (lib().transpose(1, 2).float() - exact).abs()
            del exact
        else:
            # fp32: kernel and SDPA against the plain version, all in fp32
            de, ds = diff, (lib().transpose(1, 2) - want).abs()
        vs_sdpa = {"max_err_vs_fp32": float(de.max()), "mean_err_vs_fp32": float(de.mean()),
                   "sdpa_max_err_vs_fp32": float(ds.max()),
                   "sdpa_mean_err_vs_fp32": float(ds.mean())}
        del de, ds, diff, want
        print(f"flash_attention {label} vs the fp32 plain version: max/mean err "
              f"{vs_sdpa['max_err_vs_fp32']:.3g}/{vs_sdpa['mean_err_vs_fp32']:.3g}, SDPA "
              f"{vs_sdpa['sdpa_max_err_vs_fp32']:.3g}/{vs_sdpa['sdpa_mean_err_vs_fp32']:.3g}")
        if variant == "flash_fwd_pingpong" and not (
                vs_sdpa["max_err_vs_fp32"] <= ATTN_SDPA_MAX * vs_sdpa["sdpa_max_err_vs_fp32"]
                and vs_sdpa["mean_err_vs_fp32"]
                <= ATTN_SDPA_MEAN * vs_sdpa["sdpa_mean_err_vs_fp32"]):
            raise SystemExit(f"flash_attention {label}: error beyond {ATTN_SDPA_MAX}× "
                             f"(max) or {ATTN_SDPA_MEAN}× (mean) SDPA's: {vs_sdpa}")
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw), iters=20)
        dev_ms, dev_src = kernel_device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                           "flash_fwd", fa, calls=5)
        plain = cuda_ms(lambda: ref.attention_full(q, k, v, **kw), iters=5, warmup=2)
        lib_ms = cuda_ms(lib, iters=20)
        pairs = attn_pairs(S, Skv, causal, window)
        es = q.element_size()
        n_bytes = es * (2 * B * S * H * hd + 2 * B * Skv * KV * hd) + 4 * B * H * S
        n_ops = 4 * B * H * hd * pairs        # q·k and p·v, 2 operations a product
        bnd, by = bound_ms(n_bytes, n_ops, (rates[0], rates[1] if dt == F32 else bf16_rate))
        tf32 = {}
        if variant == "flash_fwd_tf32x3":
            # three tf32 products per fp32 product on the tensor cores; the
            # fp32 FFMA bound beside it
            tf32 = {"bound_ffma_ms": bnd, "bound_ffma_by": by}
            bnd, by = bound_ms(n_bytes, 3 * n_ops, (rates[0], TF32_PER_BF16 * bf16_rate))
        dname = str(dt).replace("torch.", "")
        rows.append({"case": label, "shape": [B, S, H, KV, Skv, hd], "causal": causal,
                     "window": window, "dtype": dname, "kernel": variant, "max_abs_err": err,
                     "lse_max_abs_err": lse_err, "atol": atol, "rtol": rtol, "ms": ms,
                     "device_ms": dev_ms, "device_ms_source": dev_src,
                     "plain_ms": plain, "library_ms": lib_ms, "bound_ms": bnd,
                     "bound_by": by, **tf32, "gflop": n_ops / 1e9, "mbytes": n_bytes / 1e6,
                     **vs_sdpa, **beside})
        print(f"flash_attention {label} [B={B}, S={S}, H={H}, KV={KV}, Skv={Skv}, hd={hd}] "
              f"{'causal' if causal else 'full'} window={window} {dname} {variant}: "
              f"max_abs_err={err:.3g} (atol {atol:.3g}, rtol {rtol:g}), lse err {lse_err:.3g}; "
              f"kernel {ms:.4f} ms ({dev_txt(dev_ms, dev_src)}), plain {plain:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by}: {n_ops / 1e9:.2f} GFLOP, "
              f"{n_bytes / 1e6:.1f} MB)"
              + (f"; 3xTF32 at {TF32_PER_BF16 * bf16_rate / 1e12:.0f} TFLOP/s, fp32 FFMA bound "
                 f"{tf32['bound_ffma_ms']:.4f} ms ({tf32['bound_ffma_by']})" if tf32 else "")
              + (f"; flash_fwd_wgmma on the same values {beside['wgmma']['ms']:.4f} ms "
                 f"({dev_txt(beside['wgmma']['device_ms'], beside['wgmma']['device_ms_source'])}"
                 f"), max_abs_err {beside['wgmma']['max_abs_err']:.3g}, largest difference "
                 f"from flash_fwd_pingpong {beside['wgmma']['max_abs_diff_vs_pingpong']:.3g}"
                 if beside else ""))
        del q, k, v, o, lse, want_lse
    # the backward (plain tensor code over the kernel's saved log-sum-exp) at
    # the training shape, against autograd through the plain version
    q = torch.randn((128, 64, 32, 64), generator=gen).to(dev).requires_grad_()
    k, v = (torch.randn((128, 64, 32, 64), generator=gen).to(dev).requires_grad_()
            for _ in range(2))
    do = torch.randn((128, 64, 32, 64), generator=gen).to(dev)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, causal=True), (q, k, v), do)
    want = torch.autograd.grad(ref.attention_full(q, k, v, causal=True), (q, k, v), do)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    ok = all(bool(((g - w).abs() <= ATTN_BWD_TOL * (1 + w.abs())).all())
             for g, w in zip(got, want))
    fwd = lambda: fa.flash_attention(q, k, v, causal=True)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (q, k, v), do), iters=10)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        ref.attention_full(q, k, v, causal=True), (q, k, v), do), iters=10)
    bwd = {"case": "stablelm_train backward", "shape": [128, 64, 32, 32, 64, 64],
           "max_abs_err": max(errs), "errs_dq_dk_dv": errs, "tol": ATTN_BWD_TOL,
           "fwd_bwd_ms": bwd_ms, "plain_fwd_bwd_ms": plain_bwd_ms}
    print(f"flash_attention backward at the training shape: dq/dk/dv max_abs_err "
          f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (atol=rtol={ATTN_BWD_TOL}); forward "
          f"+ backward {bwd_ms:.4f} ms with the kernel, {plain_bwd_ms:.4f} ms through "
          "the plain version")
    if not ok:
        raise SystemExit("flash_attention's backward disagrees with autograd through "
                         "the plain version")
    return rows, bwd


# rows with no valid key (a window that closes before the keys begin, or
# every row of a causal mask with window 0): (label, B, S, H, KV, Skv,
# causal, window) at head_dim 64 and 128 for flash_fwd_tf32x3 (fp32) and
# flash_fwd_pingpong (bf16, flash_fwd_wgmma beside it); flash_fwd at head_dim
# 32 (fp32), 16 (bf16) and at bf16 bases 8 bytes past a 16-byte boundary
# (head_dim 64: TMA cannot read them, flash_fwd's 8-byte loads can)
NO_KEY_SHAPES = [("window16", 1, 200, 2, 2, 64, False, 16),
                 ("causal_window16", 1, 300, 4, 2, 64, True, 16),
                 ("packed_window4", 2, 64, 4, 1, 16, True, 4),
                 ("causal_window0", 1, 130, 4, 2, 130, True, 0)]
# (label, B, S, H, KV, Skv, hd, causal, window, dtype, 16-byte aligned)
NO_KEY_CASES = [
    ("no_key_window16_hd32", 1, 200, 2, 2, 64, 32, False, 16, F32, True),
    ("no_key_causal_window16_hd16_bf16", 1, 300, 4, 2, 64, 16, True, 16, BF16, True),
    ("no_key_packed_window4_hd64_bf16_unaligned", 2, 64, 4, 1, 16, 64, True, 4, BF16, False),
] + [(f"no_key_{label}_hd{hd}{'_bf16' if dt == BF16 else ''}", B, S, H, KV, Skv, hd, causal,
      window, dt, True)
     for dt in (F32, BF16) for hd in (64, 128)
     for label, B, S, H, KV, Skv, causal, window in NO_KEY_SHAPES]
# the backward at one such shape (fp32 and bf16): B, S, H, KV, Skv, hd, causal, window
NO_KEY_BWD = (1, 200, 2, 2, 64, 64, False, 16)
# flash_fill_no_key alone, timed: bf16 [4, 4096, 32/8, Skv 1024, 128],
# non-causal, window 256 (rows 1279 … 4095 have no valid key)
FILL_TIMED = (4, 4096, 32, 8, 1024, 128, False, 256, BF16)


def off8(t):
    """A copy of bf16 ``t`` whose base lies 8 bytes past a 16-byte boundary
    (so the wrapper picks flash_fwd)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    return buf[4:].view(t.shape).copy_(t)


def check_no_key_rows(dev, rates, gen) -> dict:
    """K4 at rows with no valid key (NO_KEY_CASES): the variant
    ``launch_geometry`` names, then flash_fill_no_key, against the plain
    version at every row under the variant's tolerance (ATTN_TOL; P's
    rounding for the bf16 tensor-core variants), the keyed rows' lse within
    LSE_ATOL and the keyless rows' fp32(−1e30) bitwise; one variant launch
    and one fill counted per case; flash_fwd_wgmma on the same values beside
    each flash_fwd_pingpong case (``fa._launch``: uncounted, the same
    contract).  Then the backward at NO_KEY_BWD in fp32 (ATTN_BWD_TOL) and
    bf16 (the bf16 rule) against autograd through the plain version, and the
    fill alone at FILL_TIMED (``fa._fill``, uncounted) against
    ``fill_no_key_ref``, timed beside its byte bound and the plain version.
    Every fill the wrapper counted here is one case's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sentinel = torch.tensor(ref.NEG_INF, dtype=F32)
    fills0, rows = fa.no_key_fills, []
    for label, B, S, H, KV, Skv, hd, causal, window, dt, aligned in NO_KEY_CASES:
        q = torch.randn((B, S, H, hd), generator=gen).to(dev, dt)
        k, v = (torch.randn((B, Skv, KV, hd), generator=gen).to(dev, dt) for _ in range(2))
        if not aligned:
            q, k, v = (off8(t) for t in (q, k, v))
        kw = dict(causal=causal, window=window)
        first = fa.no_key_rows(S, Skv, causal, window)
        variant = fa.launch_geometry(B, S, H, KV, Skv, hd, dt, aligned)["kernel"]
        before, f0 = dict(fa.variant_launches), fa.no_key_fills
        outs = {variant: fa.flash_attention_fwd(q, k, v, **kw)}
        if (fa.variant_launches != before | {variant: before[variant] + 1}
                or fa.no_key_fills != f0 + 1):
            raise SystemExit(f"flash_attention {label}: expected one {variant} launch and "
                             f"one flash_fill_no_key; variants {fa.variant_launches} (before "
                             f"{before}), fills {fa.no_key_fills} (before {f0})")
        if variant == "flash_fwd_pingpong":
            outs["flash_fwd_wgmma"] = fa._launch("flash_fwd_wgmma", q, k, v, causal, window)
        want, want_lse = ref.attention_full(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        row = {"case": label, "shape": [B, S, H, KV, Skv, hd], "causal": causal,
               "window": window, "dtype": str(dt).replace("torch.", ""), "aligned": aligned,
               "first_keyless_row": first, "kernel": variant}
        for name, (o, lse) in outs.items():
            atol, rtol = ATTN_TOL[dt]
            if name in ("flash_fwd_pingpong", "flash_fwd_wgmma"):
                atol = ATTN_P_ROUND * float(v.float().abs().max()) + ATTN_TOL[BF16][0]
            diff = (o.float() - want.float()).abs()
            lse_err = float((lse[:, :, :first] - want_lse[:, :, :first]).abs().max()) \
                if first else 0.0
            bitwise = (torch.equal(lse[:, :, first:].cpu(), sentinel.expand(B, H, S - first))
                       and torch.equal(want_lse[:, :, first:].cpu(),
                                       sentinel.expand(B, H, S - first)))
            row[name] = {"max_abs_err": float(diff.max()),
                         "max_abs_err_keyless": float(diff[:, first:].max()),
                         "lse_max_abs_err_keyed": lse_err, "lse_keyless_bitwise": bitwise,
                         "atol": atol, "rtol": rtol}
            print(f"flash_attention {label} [B={B}, S={S}, H={H}, KV={KV}, Skv={Skv}, "
                  f"hd={hd}] {'causal' if causal else 'full'} window={window} {row['dtype']}"
                  f"{'' if aligned else ' unaligned'} {name} + flash_fill_no_key (rows "
                  f"{first}-{S - 1} keyless): max_abs_err {row[name]['max_abs_err']:.3g}, "
                  f"keyless rows {row[name]['max_abs_err_keyless']:.3g} (atol {atol:.3g}, "
                  f"rtol {rtol:g}), keyed lse err {lse_err:.3g}, keyless lse -1e30f bitwise "
                  f"{bitwise}")
            if not (bool((diff <= atol + rtol * want.float().abs()).all())
                    and lse_err <= LSE_ATOL and bitwise):
                raise SystemExit(f"flash_attention {label}: {name} + flash_fill_no_key "
                                 f"disagrees with the plain version: {row[name]}")
        rows.append(row)
        del q, k, v, outs, want, want_lse
    # the backward (attention_bwd on the kernel's o and lse) at rows with no key
    B, S, H, KV, Skv, hd, causal, window = NO_KEY_BWD
    kw = dict(causal=causal, window=window)
    inputs = [torch.randn(shape, generator=gen).to(dev)
              for shape in ((B, S, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd), (B, S, H, hd))]
    bwd = {}
    for dt in (F32, BF16):
        q, k, v = (t.to(dt).requires_grad_() for t in inputs[:3])
        do = inputs[3].to(dt)
        grads = {"kernels": torch.autograd.grad(fa.flash_attention(q, k, v, **kw),
                                                (q, k, v), do),
                 "plain": torch.autograd.grad(ref.attention_full(q, k, v, **kw), (q, k, v), do)}
        names = ("dq", "dk", "dv")
        errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(grads["kernels"], grads["plain"])]
        label = f"flash_attention backward at rows with no key {str(dt)[6:]}"
        if dt == F32:
            ok = all(bool(((g - w).abs() <= ATTN_BWD_TOL * (1 + w.abs())).all())
                     for g, w in zip(grads["kernels"], grads["plain"]))
            bwd["float32"] = {"max_abs_err": max(errs), "errs_dq_dk_dv": errs,
                              "tol": ATTN_BWD_TOL}
            print(f"{label}: dq/dk/dv max_abs_err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} "
                  f"(atol=rtol={ATTN_BWD_TOL})")
            if not ok:
                raise SystemExit(f"{label} disagrees with autograd through the plain version")
        else:
            q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
            exact = torch.autograd.grad(ref.attention_full(q32, k32, v32, **kw),
                                        (q32, k32, v32), do.float())
            bwd["bfloat16"] = {"errs_dq_dk_dv": errs, "bf16_rule": bf16_noise_check(
                label, dict(zip(names, grads["kernels"])), dict(zip(names, grads["plain"])),
                dict(zip(names, exact)))}
    bwd["shape"], bwd["causal"], bwd["window"] = [B, S, H, KV, Skv, hd], causal, window
    fills = fa.no_key_fills - fills0
    if fills != len(NO_KEY_CASES) + 2:
        raise SystemExit(f"flash_fill_no_key: {fills} launches counted in the check, expected "
                         f"{len(NO_KEY_CASES)} cases + 2 backward forwards")
    # the fill alone at a larger shape, beside its byte bound and plain version
    import types
    B, S, H, KV, Skv, hd, causal, window, dt = FILL_TIMED
    first = fa.no_key_rows(S, Skv, causal, window)
    v = torch.randn((B, Skv, KV, hd), generator=gen).to(dev, dt)
    o, lse = torch.zeros((B, S, H, hd), dtype=dt, device=dev), torch.zeros((B, H, S), device=dev)
    o_ref, lse_ref = o.clone(), lse.clone()
    fa._fill(o, lse, v, first)
    fa.fill_no_key_ref(o_ref, lse_ref, v, first)
    err = float((o.float() - o_ref.float()).abs().max())
    if not (err <= ATTN_TOL[BF16][0] + ATTN_TOL[BF16][1] * float(o_ref.float().abs().max())
            and torch.equal(lse, lse_ref)):
        raise SystemExit(f"flash_fill_no_key alone disagrees with fill_no_key_ref: {err}")
    counted = types.SimpleNamespace(launches=0)

    def call():
        counted.launches += 1
        fa._fill(o, lse, v, first)

    ms = cuda_ms(call, iters=50)
    dev_ms, dev_src = kernel_device_ms(call, "flash_fill_no_key", counted, calls=20)
    plain = cuda_ms(lambda: fa.fill_no_key_ref(o_ref, lse_ref, v, first), iters=20)
    n_bytes = v.numel() * v.element_size() + B * (S - first) * H * hd * o.element_size() \
        + B * H * (S - first) * 4
    n_ops = v.numel() + B * KV * hd          # the sums' adds, one scale a column
    bnd, by = bound_ms(n_bytes, n_ops, rates)
    timed = {"case": "fill_timed", "shape": [B, S, H, KV, Skv, hd], "causal": causal,
             "window": window, "dtype": "bfloat16", "first_keyless_row": first,
             "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "device_ms_source": dev_src,
             "plain_ms": plain, "bound_ms": bnd, "bound_by": by, "library_ms": None,
             "mbytes": n_bytes / 1e6}
    print(f"flash_fill_no_key alone [B={B}, S={S}, H={H}, KV={KV}, Skv={Skv}, hd={hd}] bf16, "
          f"rows {first}-{S - 1}: max_abs_err {err:.3g} vs fill_no_key_ref; {ms:.4f} ms "
          f"({dev_txt(dev_ms, dev_src)}), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}: "
          f"{n_bytes / 1e6:.1f} MB); {fills} fills counted in the check "
          f"({len(NO_KEY_CASES)} cases + 2 backward forwards)")
    del v, o, lse, o_ref, lse_ref
    return {"rows": rows, "backward": bwd, "timed": timed, "fills": fills}


STEP_OPTIMIZERS = [("sgd", torch.float32), ("momentum", torch.bfloat16),
                   ("sm3", torch.float32), ("shampoo_blocked", torch.float32)]


def check_step(dev):
    """One mlp local step per optimizer with the kernels and with the plain
    versions, from the same state."""
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda
    from repro_torch.tree import tree_leaves
    mcfg = mlp_config()
    g = torch.Generator().manual_seed(1)
    y = (torch.rand((4, 32), generator=g) < 0.71).float()
    batch = {"features": (torch.randn((4, 32, 64), generator=g)
                          + 0.3 * (2 * y[..., None] - 1)).to(dev),
             "labels": y.to(dev)}
    for name, odt in STEP_OPTIMIZERS:
        out = {}
        for impl in ("kernel", "ref"):
            ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, impl=impl, optimizer=name,
                                   opt_dtype=odt)
            st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0),
                                 device=dev)
            out[impl] = coda.local_step(mcfg, ccfg, st, batch, 0.5)
        err = max(float((a.float() - b.float()).abs().max()) for a, b in
                  zip(tree_leaves(out["kernel"][0]["params"]),
                      tree_leaves(out["ref"][0]["params"])))
        lerr = float((out["kernel"][1] - out["ref"][1]).abs().max())
        print(f"main-path step (mlp, {name} {str(odt)[6:]}), kernels vs plain versions: "
              f"params max_abs_err={err:.3g}, losses max_abs_err={lerr:.3g} (atol 1e-5)")
        if not (err <= 1e-5 and lerr <= 1e-5):
            raise SystemExit(f"the {name} step with kernels disagrees with the plain "
                             "versions")


def zero_counts():
    """Set every launch counter to 0: each kernel's, each variant's, and the
    distributed executor's collective counts."""
    from repro_torch.core import bucketing
    from repro_torch.launch import train
    for mod in train.KERNELS.values():
        mod.launches = 0
        if hasattr(mod, "zero_launches"):
            mod.zero_launches()
    bucketing.zero_collectives()


def read_counts() -> dict:
    from repro_torch.launch import train
    return {k: mod.launches for k, mod in train.KERNELS.items()}


def step_launches(kernel: str, state: dict) -> int:
    """K2's (``prox_update``) or K3's (``opt_update``) launches in one local
    step over ``state``'s parameter leaves, from the wrapper's own
    ``launch_geometry`` over their sizes and dtype codes (the kernel's
    geometry query and R5 say the same): one launch while a step has at most
    ``MAX_LEAVES`` leaves.  Every tree chip_smoke trains has fewer, so
    anything but one launch a step fails here, whatever the geometry says."""
    from repro_torch.kernels import opt_update as K3
    from repro_torch.kernels import prox_update as K2
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(state["params"])
    sizes = [l.numel() for l in leaves]
    if kernel == "prox_update":
        n = K2.launch_geometry(sizes, [K2.CODES[(l.dtype, l.dtype)] for l in leaves])["launches"]
    else:
        # a momentum buffer a leaf, or SM3's accumulators (the launch reads fp32 covers)
        bufs = [b if isinstance(b, torch.Tensor) else None for b in state["opt"]["leaves"]]
        codes = [K3.CODES[(l.dtype, F32 if b is None else b.dtype)]
                 for l, b in zip(leaves, bufs)]
        n = K3.launch_geometry(sizes, codes)["launches"]
    if n != 1:
        raise SystemExit(f"{kernel}: {n} launches a local step over {len(leaves)} leaves, "
                         "not one")
    return n


def run_main_path(label: str, argv: list[str], leaves_per_step: int,
                  per_leaf: str = "prox_update", attn_layers: int = 0, moe_layers: int = 0):
    """Drive ``train.main(argv)`` with every launch counter set to 0 just
    before and read just after; ``per_leaf`` is the kernel of the optimizer
    step, launched ``step_launches`` times a local step over every one of
    the ``leaves_per_step`` parameter leaves (the other must stay 0).
    ``flash_attention`` runs once per attention layer in every forward: each
    local step and each stage-end α batch inside ``fit``, then each chunk of
    the held-out split the launcher scores after it.  ``grouped_matmul``
    runs three times per moe layer in every eval forward (the stage-end α
    batches and the held-out chunks) and never in a local step."""
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    held = torch.cuda.memory_allocated()       # the script's other tensors
    zero_counts()
    out = train.main(argv)
    counts = read_counts()
    after = torch.cuda.memory_stats()
    # the caching allocator around the path: cudaMalloc retries (each one
    # frees the cache and synchronises) and the reserved bytes
    out["allocator"] = {"alloc_retries": after["num_alloc_retries"] - before["num_alloc_retries"],
                        "reserved_before": before["reserved_bytes.all.current"],
                        "reserved_after": after["reserved_bytes.all.current"],
                        "reserved_peak": after["reserved_bytes.all.peak"]}
    out["variant_launches"] = read_variants()
    steps = out["iterations"]
    # fit's history holds each window's loss, then, on eval windows, the
    # eval value under the same (stage, iteration): keep the losses
    hist = out["history"]
    losses = [h[2] for i, h in enumerate(hist) if i == 0 or hist[i - 1][:2] != h[:2]]
    peak = torch.cuda.max_memory_allocated()
    out["peak_bytes"], out["peak_above_held"] = peak, peak - held
    print(f"{label}: {steps} local steps, {out['ms_per_local_step']:.3f} ms per "
          f"local step (steady median), peak memory {peak / 2**30:.3f} GiB "
          f"({(peak - held) / 2**30:.3f} above the {held / 2**30:.3f} held before it), "
          f"optimizer state {out['opt_state_bytes']:,} B/worker, bytes/round/worker "
          f"{out['bytes_per_round']:,}, launches {counts}, "
          f"first/last window loss {losses[0]:.5f}/{losses[-1]:.5f}, test AUC "
          f"{out['auc']:.4f}" + ("" if out["metric"] is None else
                                  f", test pauc {out['metric']:.4f}"))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss in {losses}")
    if out["leaves"] != leaves_per_step:
        raise SystemExit(f"{label}: {out['leaves']} leaves, expected {leaves_per_step}")
    # pauc_dro and bce compute their losses in plain tensor code, as the
    # reference does: auc_loss runs only for the auc objective
    objective = argv[argv.index("--objective") + 1] if "--objective" in argv else "auc"
    chunks = math.ceil(out["n_test"] / train.TEST_CHUNK)
    # ``--metrics exact`` evals score the held-out split inside fit (one
    # eval value in the history after its window's loss); sketch evals read
    # the sketch and run no forward
    exact = "--metrics" in argv and argv[argv.index("--metrics") + 1] == "exact"
    evals = sum(1 for i, h in enumerate(hist) if i and hist[i - 1][:2] == h[:2]) if exact else 0
    want = {"auc_loss": steps if objective == "auc" else 0, "prox_update": 0, "opt_update": 0,
            "flash_attention": attn_layers * (steps + out["stages"] + evals * chunks),
            "grouped_matmul": 3 * moe_layers * (out["stages"] + evals * chunks)}
    out["step_launches"] = step_launches(per_leaf, out["state"])
    want[per_leaf] = steps * out["step_launches"]
    want_all = dict(want, flash_attention=want["flash_attention"] + attn_layers * chunks,
                    grouped_matmul=want["grouped_matmul"] + 3 * moe_layers * chunks)
    if len(out["step_seconds"]) <= 8:     # the short paths: each window's ms per step
        print(f"{label}: ms per local step by window "
              f"{[round(1e3 * t, 3) for t in out['step_seconds']]}")
    if counts != want_all or out["launches"] != want:
        raise SystemExit(f"{label}: launch counts {counts} (fit's {out['launches']}), "
                         f"expected {want_all} (fit's {want})")
    want_bytes = BYTES_PER_ROUND.get(label.removeprefix("main path "))
    if want_bytes is not None and out["bytes_per_round"] != want_bytes:
        raise SystemExit(f"{label}: bytes/round/worker {out['bytes_per_round']:,}, the "
                         f"reference's launcher prints {want_bytes:,}")
    scores = out["test_scores"]
    if not (scores.dim() == 1 and bool(torch.isfinite(scores).all())):
        raise SystemExit(f"{label}: test scores not a finite vector")
    return out, counts


def require_k4_variant(label: str, run: dict, variant: str, why: str) -> None:
    """Every K4 launch of a main path's run took ``variant`` (so none took
    another, flash_fwd included)."""
    k4 = run["variant_launches"]["flash_attention"]
    if k4[variant] != sum(k4.values()) or not k4[variant]:
        raise SystemExit(f"main path {label}: K4 variants {k4}, expected every launch "
                         f"{variant} ({why})")


# (label, launcher arguments, the kernel of the optimizer step: one launch a
# local step over every leaf, step_launches)
MLP_PATHS = [
    ("mlp", [], "prox_update"),
    ("mlp_momentum", ["--optimizer", "momentum", "--opt-dtype", "bf16"], "opt_update"),
    ("mlp_sm3", ["--optimizer", "sm3"], "opt_update"),
    # one stage (64 local steps): its CPU twin, ~0.3 s a step, was the
    # longest of the twins at the launcher's three stages
    ("mlp_shampoo", ["--optimizer", "shampoo_blocked", "--stages", "1"], "prox_update"),
    ("mlp_sketch", ["--metrics", "sketch", "--metric-interval", "4"], "prox_update"),
    ("mlp_pauc_dro", ["--objective", "pauc_dro"], "prox_update"),
    ("mlp_bce", ["--objective", "bce"], "prox_update"),
    # CODASCA on Dirichlet-skewed shards; with faults (dropout, stragglers
    # merged up to 2 windows late) and the sketch; the masked int8 CoDA
    # average; CODASCA with server momentum and the momentum optimizer (K3)
    ("mlp_codasca", CODASCA_ARGS, "prox_update"),
    ("mlp_codasca_faults", CODASCA_ARGS + FAULT_ARGS + ["--metrics", "sketch",
                                                        "--metric-interval", "4"],
     "prox_update"),
    ("mlp_masked_int8", ["--participation", "0.5", "--compress", "int8", "--fault-seed", "1"],
     "prox_update"),
    ("mlp_codasca_server_momentum", ["--algorithm", "codasca", "--server-momentum", "0.9",
                                     "--optimizer", "momentum"], "opt_update"),
]
RN_PATHS = [
    ("resnet50", [], "prox_update"),
    ("resnet50_momentum", ["--optimizer", "momentum", "--opt-dtype", "bf16"], "opt_update"),
    ("resnet50_sm3", ["--optimizer", "sm3"], "opt_update"),
    ("resnet50_codasca_masked", ["--algorithm", "codasca", "--dirichlet-alpha", "0.1",
                                 "--participation", "0.75", "--fault-seed", "1"],
     "prox_update"),
    # blocked Shampoo with --precond-every 1: ~730,000 32×32 blocks a worker,
    # statistics and inverse roots 6.0 GB a worker in fp32, 24.1 GB at
    # RN_ARGS' K = 4; the donating executor writes each step into that state
    # leaf by leaf, so a step holds one copy of it plus one leaf's temporaries
    ("resnet50_shampoo", ["--optimizer", "shampoo_blocked"], "prox_update"),
]
# bytes/round/worker as the reference's launcher prints them for the same
# flags (tests/test_torch_codasca.py holds these numbers against
# repro.core.coda's accounting): the mlp's 24,961 fp32 parameters and its
# objective's fp32 duals; CODASCA doubles them; the sketch adds 2·2048·4;
# int8 ships 1 B an element and a 4-B scale a leaf; ResNet50's 23,494,721
# parameters and 3 duals, doubled by CODASCA.  The masked window's weight
# lanes (+4 B, +8 B for CODASCA) are not in the printed number.
MLP_BYTES = (24961 + 3) * 4
# the mlp paths whose final state a later phase reads (the sketch count, the
# profiled windows, the --executor shard_map twins held bitwise)
MLP_STATES_READ_LATER = ("mlp", "mlp_sketch", "mlp_codasca_faults",
                         "mlp_codasca_server_momentum")
BYTES_PER_ROUND = {
    "mlp": MLP_BYTES, "mlp_momentum": MLP_BYTES, "mlp_sm3": MLP_BYTES,
    "mlp_shampoo": MLP_BYTES, "mlp_sketch": MLP_BYTES + 2 * 2048 * 4,
    "mlp_pauc_dro": (24961 + 4) * 4, "mlp_bce": 24961 * 4,
    "mlp_codasca": 2 * MLP_BYTES, "mlp_codasca_faults": 2 * MLP_BYTES + 2 * 2048 * 4,
    "mlp_masked_int8": 24961 + 3 + 9 * 4, "mlp_codasca_server_momentum": 2 * MLP_BYTES,
    "resnet50_codasca_masked": 2 * (23494721 + 3) * 4,
    "mlp_int8": 24961 + 3 + 9 * 4, "mlp_codasca_participation": 2 * MLP_BYTES,
    "mlp_shard_map": MLP_BYTES, "mlp_shard_map_int8": 24961 + 3 + 9 * 4,
    "mlp_shard_map_overlap": MLP_BYTES, "mlp_shard_map_codasca_faults": 2 * MLP_BYTES,
    "mlp_shard_map_codasca_server_momentum": 2 * MLP_BYTES,
    "resnet50_shard_map": (23494721 + 3) * 4, "resnet50_shard_map_det": (23494721 + 3) * 4,
    "resnet50_shampoo": (23494721 + 3) * 4, "resnet50_shard_map_overlap": (23494721 + 3) * 4,
}
# the distributed executor (--executor shard_map: NCCL, one rank a card): the
# mlp at the launcher's defaults plain, int8, overlapped and as faulted
# CODASCA, and ResNet50 at full width; each beside the --executor vmap path
# with the same flags (the overlapped path beside the plain one: the vmap
# executor has no ring)
SHARD_ARGS = ["--executor", "shard_map"]
SHARD_FAULTS = ["--algorithm", "codasca", "--participation", "0.75", "--straggler-prob", "0.2",
                "--fault-seed", "3"]
SHARD_VMAP_PATHS = [("mlp_int8", ["--compress", "int8"]),
                    ("mlp_codasca_participation", SHARD_FAULTS)]
# (label, launcher arguments, the vmap path beside it, the kernel launched once
# of the optimizer step, whether the final parameters are held bitwise the vmap
# path's: at R = 1 the same arithmetic on the same draws, except the
# overlapped path, whose vmap twin has no pairs, and ResNet50, whose two fits
# are held bitwise under deterministic cuDNN in run_resnet50_determinism)
SHARDED_PATHS = [
    ("mlp_shard_map", SHARD_ARGS, "mlp", "prox_update", True),
    ("mlp_shard_map_int8", SHARD_ARGS + ["--compress", "int8"], "mlp_int8", "prox_update",
     True),
    ("mlp_shard_map_overlap", SHARD_ARGS + ["--overlap", "--overlap-chunks", "4"], "mlp",
     "prox_update", False),
    ("mlp_shard_map_codasca_faults", SHARD_ARGS + SHARD_FAULTS, "mlp_codasca_participation",
     "prox_update", True),
    ("mlp_shard_map_codasca_server_momentum",
     SHARD_ARGS + ["--algorithm", "codasca", "--server-momentum", "0.9", "--optimizer",
                   "momentum"], "mlp_codasca_server_momentum", "opt_update", True),
    ("resnet50_shard_map", RN_ARGS + SHARD_ARGS, "resnet50", "prox_update", False),
]
RN_SHARD_DET = ("resnet50_shard_map_det", RN_ARGS + SHARD_ARGS)    # under deterministic cuDNN
# the overlapped pair at full width, also under deterministic cuDNN (its pairs
# draw other windows than RN_SHARD_DET's, so the two fits end apart)
RN_OVERLAP = ("resnet50_shard_map_overlap",
              RN_ARGS + SHARD_ARGS + ["--overlap", "--overlap-chunks", "4"])
# stablelm-1.6b: full width with the depth cut to 2 of 24 layers (K=4 replicas,
# their references, gradients and the step's new copy: ~33 GB at 2 layers,
# ~105 GB at 24); and the launcher's smoke config, whose test AUC is held
# against the same command with --device cpu
DENSE_LEAVES, TRAIN_LAYERS = 17, 2
LM_TRAIN_ARGS = ["--arch", "stablelm-1.6b", "--n-layers", str(TRAIN_LAYERS), "--stages", "1",
                 "--t0", "16", "--n-data", "1024"]
LM_SMOKE = ("stablelm_smoke", ["--arch", "stablelm-1.6b", "--smoke", "--stages", "2",
                               "--t0", "30"], "prox_update")
MOE_SMOKE = ("dbrx_smoke", ["--arch", "dbrx-132b", "--smoke", "--stages", "2", "--t0", "30"],
             "prox_update")
MOE_LEAVES = 18
# the vlm, hybrid and audio families through the launcher: (label, arguments,
# leaves, K4 launches a forward).  At full width with their depth cut
# (internvl2-2b to 2 of 24 layers: 257 positions, 256 patches + 1 token;
# hymba-1.5b to 3 of 32: global, windowed, global; seamless-m4t-medium to 2 +
# 2 of 12 + 12: 64 frames, 16 tokens), one stage of 16 local steps; and their
# smoke configs, each test AUC held against the same command with --device cpu
ZOO_TRAIN_ARGS = ["--stages", "1", "--t0", "16", "--n-data", "1024"]
ZOO_TRAIN = [
    ("internvl_train", ["--arch", "internvl2-2b", "--n-layers", "2"] + ZOO_TRAIN_ARGS, 15, 2),
    ("hymba_train", ["--arch", "hymba-1.5b", "--n-layers", "3"] + ZOO_TRAIN_ARGS, 24, 3),
    ("seamless_train", ["--arch", "seamless-m4t-medium", "--n-layers", "2"] + ZOO_TRAIN_ARGS,
     35, 6),
]
ZOO_SMOKE_ARGS = ["--smoke", "--stages", "1", "--t0", "32"]
ZOO_SMOKE = [
    ("internvl_smoke", ["--arch", "internvl2-2b"] + ZOO_SMOKE_ARGS, 15, 2),
    ("hymba_smoke", ["--arch", "hymba-1.5b"] + ZOO_SMOKE_ARGS, 24, 2),
    ("seamless_smoke", ["--arch", "seamless-m4t-medium"] + ZOO_SMOKE_ARGS, 35, 6),
]
# the ssm family's smoke config with sm3 (K3), and dbrx's with shampoo_blocked
# (the axis-order optimizers on the moe family): (label, arguments, the kernel
# of the optimizer step, one launch a step)
# Both optimizers scale a gradient's fp32 rounding up where it is near zero,
# so two runs that round differently part within a few steps (on the CPU
# alone, ATEN_CPU_CAPABILITY=default against avx2 moves the test AUC of the
# xlstm path by 0.03 at step 4 and by 0.4 at step 7): the card and the CPU
# are held at the first window's eval (one local step, ``--interval 1
# --metrics exact --metric-interval 1``); the final test AUCs are printed.
CHAOTIC_ARGS = ["--smoke", "--stages", "1", "--interval", "1", "--metrics", "exact",
                "--metric-interval", "1", "--n-data", "2048"]
SSM_TWINS = [
    ("xlstm_smoke_sm3", ["--arch", "xlstm-350m", "--t0", "8", "--optimizer", "sm3"]
     + CHAOTIC_ARGS, "opt_update"),
    ("dbrx_smoke_shampoo", ["--arch", "dbrx-132b", "--t0", "4", "--optimizer",
                            "shampoo_blocked", "--shampoo-block", "8"] + CHAOTIC_ARGS,
     "prox_update"),
]
EVAL_1_RE = r"^\[train\] eval 1: streaming auc=(\d\.\d+) "
# (label, module, arguments): the commands run again with --device cpu
TRAIN, SERVE, QUICKSTART = ("repro_torch.launch.train", "repro_torch.launch.serve",
                            "repro_torch.quickstart")
TWIN_PATHS = ([(label, TRAIN, args) for label, args, _ in MLP_PATHS + [LM_SMOKE, MOE_SMOKE]]
              + [(label, TRAIN, args) for label, args, _, _ in ZOO_SMOKE]
              + [(label, TRAIN, args) for label, args, _ in SSM_TWINS]
              + [("dbrx_serve_smoke", SERVE, ["--arch", "dbrx-132b", "--labeled",
                                              "--metrics", "sketch"]),
                 ("quickstart", QUICKSTART, [])])
# the test AUC (and pAUC) a training twin prints
DONE_RE = {TRAIN: r"^done: .* test AUC=(\d\.\d+)(?:, test pauc@[\d.]+=(\d\.\d+))?$",
           QUICKSTART: r"^final test AUC +: (\d\.\d+)()$"}


class CpuTwins:
    """The smoke paths' commands again with ``--device cpu``, one process
    after another in a background thread at the lowest CPU priority
    (``nice``), so the CPU runs overlap the card's phases; ``stop`` ends the
    running process, whatever state the script is in.  A training twin
    gives its test AUC, a serving twin its output."""

    def __init__(self, paths, threads: int = 6):
        self.paths, self.threads = paths, threads
        self.auc: dict[str, float] = {}
        self.pauc: dict[str, float] = {}
        self.out: dict[str, str] = {}
        self.seconds: dict[str, float] = {}
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self._proc = None
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS=str(self.threads))
        for label, module, args in self.paths:
            with self._lock:
                if self._stopped:
                    return
                self._proc = subprocess.Popen(
                    ["nice", "-n", "19", sys.executable, "-m", module,
                     "--device", "cpu", *args], cwd=ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            t0 = time.perf_counter()
            out, err = self._proc.communicate()
            self.seconds[label] = time.perf_counter() - t0
            found = re.search(DONE_RE[module], out, re.M) if module in DONE_RE else None
            if self._proc.returncode != 0 or (module in DONE_RE and not found):
                self.errors.append(f"{label}: exit {self._proc.returncode}\n"
                                   f"{out[-1500:]}{err[-1500:]}")
            else:
                self.out[label] = out
                if found:
                    self.auc[label] = float(found.group(1))
                    if found.group(2):
                        self.pauc[label] = float(found.group(2))

    def wait(self, timeout: float = 900.0):
        t0 = time.perf_counter()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise SystemExit(f"the CPU runs of the smoke paths took over {timeout:.0f} s")
        if self.errors:
            raise SystemExit("a CPU run of a smoke path failed:\n" + "\n".join(self.errors))
        print(f"cpu runs: waited {time.perf_counter() - t0:.1f} s for the --device cpu "
              "runs of the smoke paths; each took (s) "
              + ", ".join(f"{k} {v:.1f}" for k, v in self.seconds.items()))

    def stop(self):
        with self._lock:
            self._stopped = True
            if self._proc is not None and self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()


KERNEL_TAGS = {"auc_loss": "auc_loss", "prox_update": "prox_update",
               "opt_update": "opt_update", "flash_attention": "flash_fwd",
               "grouped_matmul": "gmm_"}


def window_batch(mcfg, dev) -> dict:
    """A seeded window of I=8 local steps for K=4 workers, B=32 each."""
    g = torch.Generator().manual_seed(2)
    y = (torch.rand((8, 4, 32), generator=g) < 0.71).float()
    if mcfg.family == "mlp":
        wb = {"features": torch.randn((8, 4, 32, 64), generator=g)}
    elif mcfg.family == "dense":
        wb = {"tokens": torch.randint(0, mcfg.vocab_size, (8, 4, 32, 64), generator=g)}
    else:
        wb = {"images": torch.randn((8, 4, 32, 32 * 32, 3), generator=g)}
    return {k: v.to(dev) for k, v in wb.items()} | {"labels": y.to(dev)}


def copied(state):
    """A copy of a state for a donating executor, which consumes what it is
    given, where the caller keeps using the original."""
    from repro_torch.tree import tree_map
    return tree_map(torch.clone, state)


def profile_window(label: str, mcfg, state, dev, *, consume: bool = False,
                   **ccfg_kw) -> dict:
    """Where one window (I=8 local steps + the average) of a main path spends
    its time: host wall time, device busy time, the hand-written kernels'
    share, and the kernels that take the most device time.  The donating
    executor runs a warm-up window, then the profiled one from its result,
    on a copy of ``state`` (``consume``: on ``state`` itself)."""
    from repro_torch.core import coda
    from repro_torch.core.faults import FaultPlan
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, **ccfg_kw)
    exe, fl = coda.make_executor(mcfg, ccfg), None
    if ccfg.faults_enabled:                # window 0's fault vectors
        fl = {k: torch.from_numpy(v).to(dev)
              for k, v in zip(("weights", "resync"), FaultPlan.from_config(ccfg).window(0))}
    wb = window_batch(mcfg, dev)
    held = [exe.window_step(state if consume else copied(state), wb, 0.5, faults=fl)[0]]
    del state                                           # after the warm-up window

    def window():
        held.append(exe.window_step(held.pop(), wb, 0.5, faults=fl)[0])

    wall, busy, per = device_profile(window)
    del held
    ours = {name: sum(v for k, v in per.items() if tag in k)
            for name, tag in KERNEL_TAGS.items()}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    out = {"path": label, "local_steps": 8, "wall_ms": wall, "device_busy_ms": busy,
           "kernel_sum_ms": sum(per.values()), "idle_share": 1.0 - busy / wall,
           "hand_written_ms": ours,
           "top_kernels_ms": {k[:90]: v for k, v in top}}
    print(f"profile {label} window: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"(idle share {1.0 - busy / wall:.3f}; kernel time summed "
          f"{sum(per.values()):.3f} ms), auc_loss {ours['auc_loss']:.4f} ms, "
          f"prox_update {ours['prox_update']:.4f} ms, opt_update "
          f"{ours['opt_update']:.4f} ms, flash_attention {ours['flash_attention']:.4f} ms")
    print(json.dumps({"profile": out}))
    return out


# prefill with the kernels vs impl="ref" on the card, in fp32 through every
# layer: sigmoid scores, O(1) last-position logits, and the bf16 caches (one
# bf16 ulp, 2⁻⁷ relative, on top of the fp32 noise)
PREFILL_TOL = {"scores": 1e-5, "logits": 1e-4, "cache_rtol": 2 ** -7, "cache_atol": 1e-4}
# bf16 weights: the kernels and impl="ref" are two bf16 computations of one
# fp32 function, rounding in different places (flash_fwd_pingpong rounds each
# probability to bf16 before P·V where the plain attention rounds its output
# once; gmm_wgmma and the plain grouped GEMM sum in fp32 in another order), so
# after a few layers they differ by bf16 noise, not by an fp32 tolerance.
# That noise is measured in the same run: the same prefill in fp32 on the same
# weights (``prefill_fp32``: each layer's bf16 weights widened as the layer
# runs).  The rule, for the scores, the last logits and both caches: the
# kernels' max |difference| from impl="ref" is at most BF16_NOISE_FACTOR
# times impl="ref"'s own max |difference| from fp32, plus one bf16 ulp of the
# largest fp32 value (2⁻⁷ of it): a second bf16 rounding of the same
# function lands about as far from the first as the first from fp32; the
# factor leaves room for the spread of a maximum over different roundings.
BF16_NOISE_FACTOR = 2.0
BF16_ULP = 2 ** -7
F32_NAMES = ("scores", "logits", "k_cache", "v_cache")


@dataclasses.dataclass(frozen=True)
class PrefillPath:
    """A model's ``prefill_step`` at full width on one replica (K = 1): the
    configuration (``n_layers`` cuts its depth; None keeps it), its parameter
    count, the [B, S] token batch, how both were cut (printed as
    ``reduced:``), the parameter dtype, and the K4 and K5 variants every
    launch must take."""
    label: str
    arch: str
    n_params: int
    B: int
    S: int
    reduced: str
    n_layers: int | None = None
    dtype: torch.dtype = torch.float32
    k4: str = "flash_fwd_tf32x3"     # fp32 at head_dim 64/128
    k5: str = "gmm_tf32x3"           # fp32 at ~512 rows per expert


PREFILL_32K = "prefill_32k [B=32, S=32768] cut to [B={B}, S={S}]"
STABLELM_PREFILL = PrefillPath(
    "stablelm_prefill", "stablelm-1.6b", 1_644_369_921, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (24 layers)")
CHATGLM_PREFILL = PrefillPath(
    "chatglm_prefill", "chatglm3-6b", 6_243_588_097, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (28 layers: d=4096, 32/2 "
    "heads of 128, d_ff 13696, vocab 65,024, half-rotary 2-d RoPE, qkv bias)")
DBRX_LAYERS = 2
DBRX_PREFILL = PrefillPath(
    "dbrx_prefill", "dbrx-132b", 7_751_337_985, 2, 1024,
    f"{DBRX_LAYERS} of 40 layers (full width: d=6144, 48/8 heads of 128, 16 experts top-4, "
    "d_ff 10752, vocab 100,352), one replica (K=1); " + PREFILL_32K,
    n_layers=DBRX_LAYERS)
# the bf16 paths: every K4 launch flash_fwd_pingpong, every K5 launch gmm_wgmma
# but the bf16 dbrx prefill's (~512 rows an expert: gmm_wgmma_m128)
BF16_STABLELM_PREFILL = dataclasses.replace(
    STABLELM_PREFILL, label="bf16_stablelm_prefill", dtype=BF16, k4="flash_fwd_pingpong",
    k5="gmm_wgmma", reduced=STABLELM_PREFILL.reduced + "; bf16 weights")
BF16_QWEN_PREFILL = PrefillPath(
    "bf16_qwen_prefill", "qwen2.5-14b", 14_770_038_785, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (48 layers: d=5120, 40/8 heads "
    "of 128, d_ff 13824, vocab 152,064, qkv bias); bf16 weights (29.5 GB; 59 GB in fp32)",
    dtype=BF16, k4="flash_fwd_pingpong", k5="gmm_wgmma")
BF16_DBRX_LAYERS = 4
BF16_DBRX_PREFILL = PrefillPath(
    "bf16_dbrx_prefill", "dbrx-132b", 14_269_532_161, 2, 1024,
    f"{BF16_DBRX_LAYERS} of 40 layers (full width, as dbrx_prefill; bf16 weights, 28.5 GB, "
    "where fp32 fits 2), one replica (K=1); " + PREFILL_32K,
    n_layers=BF16_DBRX_LAYERS, dtype=BF16, k4="flash_fwd_pingpong", k5="gmm_wgmma_m128")


# the vlm, hybrid and audio families at full width
INTERNVL_PREFILL = PrefillPath(
    "internvl_prefill", "internvl2-2b", 1_893_343_233, 4, 2048,
    PREFILL_32K + " positions: 256 patch embeddings (the ViT stub) + 1792 tokens; one "
    "replica (K=1); full width and depth (24 layers: d=2048, 16/8 heads of 128, d_ff 8192, "
    "vocab 92,553)")
BF16_INTERNVL_PREFILL = dataclasses.replace(
    INTERNVL_PREFILL, label="bf16_internvl_prefill", dtype=BF16, k4="flash_fwd_pingpong",
    reduced=INTERNVL_PREFILL.reduced + "; bf16 weights (the fp32 patches project in fp32)")
HYMBA_PREFILL = PrefillPath(
    "hymba_prefill", "hymba-1.5b", 1_662_214_401, 2, 4096,
    "prefill_32k [B=32, S=32768] cut to [B={B}, S={S}], one replica (K=1); full width and "
    "depth (32 layers: d=1600, 25/5 heads of 64, d_ff 5504, vocab 32,001, an SSM branch "
    "of d_inner 3200 and state 16 in every layer, a 2048 window but on layers 0, 16 and 31)")
BF16_HYMBA_PREFILL = dataclasses.replace(
    HYMBA_PREFILL, label="bf16_hymba_prefill", dtype=BF16, k4="flash_fwd_pingpong",
    reduced=HYMBA_PREFILL.reduced + "; bf16 weights (A_log, D and the scan in fp32)")
SEAMLESS_PREFILL = PrefillPath(
    "seamless_prefill", "seamless-m4t-medium", 878_208_001, 4, 2048,
    "prefill_32k [B=32, S=32768] cut to [B={B}, S={S}] frames (the speech-encoder stub, "
    "fp32 [4, 2048, 1024]) and S/4 = 512 target tokens, one replica (K=1); full width and "
    "depth (12 encoder + 12 decoder layers: d=1024, 16 heads of 64, d_ff 4096, vocab "
    "256,206; logits at the last position only)")
ZOO_PREFILLS = (INTERNVL_PREFILL, BF16_INTERNVL_PREFILL, HYMBA_PREFILL, BF16_HYMBA_PREFILL,
                SEAMLESS_PREFILL)
# arctic-480b in bf16 at full width: 2 layers are 55.36 GB, 3 would be ~83 GB
ARCTIC_LAYERS = 2
BF16_ARCTIC_PREFILL = PrefillPath(
    "bf16_arctic_prefill", "arctic-480b", 27_681_138_689, 2, 1024,
    f"{ARCTIC_LAYERS} of 35 layers (full width: d=7168, 56/8 heads of 128, 128 experts "
    "top-2 of d_ff 4864 beside a dense residual MLP of d_ff 4864, vocab 32,000; bf16 "
    "weights, 55.36 GB, where 3 layers would be ~83 GB), one replica (K=1); " + PREFILL_32K,
    n_layers=ARCTIC_LAYERS, dtype=BF16, k4="flash_fwd_pingpong", k5="gmm_wgmma")
BF16_PHI3_PREFILL = PrefillPath(
    "bf16_phi3_prefill", "phi3-medium-14b", 14_659_512_321, 4, 2048,
    PREFILL_32K + ", one replica (K=1); full width and depth (40 layers: d=5120, 40/10 heads "
    "of 128, d_ff 17920, vocab 100,352); bf16 weights (29.32 GB; 58.6 GB in fp32)",
    dtype=BF16, k4="flash_fwd_pingpong", k5="gmm_wgmma")


def hidden_fp32(cfg, params, batch):
    """The final normed hidden states [1, B, S, d] in fp32 of a transformer
    with bf16 weights, each layer's weights widened to fp32 only while it
    runs (the plain versions, ``impl="ref"``), so a model that fits only in
    bf16 gets its fp32 result; and the stacked bf16 (K, V) caches.  A moe
    layer's expert stacks stay bf16: the plain grouped GEMM widens one
    expert's block at a time (``ops.grouped_matmul``), the values of the
    whole layer widened (arctic-480b's experts are 53.55 GB a layer in
    fp32).  ``batch``: tokens [1, B, S] (and a vlm's patches)."""
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.models.embeddings import apply_norm
    x = M._embed_inputs(cfg, _f32({k: params[k] for k in ("embed", "projector")
                                   if k in params}), batch)
    positions = torch.arange(x.shape[2], device=x.device)
    windows = blocks.layer_windows_static(cfg, False)
    ks, vs = [], []
    for lp, w in zip(blocks.unstack(params["layers"], cfg.n_layers), windows, strict=True):
        x, _, (k, v) = blocks.apply_layer(cfg, _f32_layer(lp), x, positions, w, impl="ref",
                                          return_kv=True)
        ks.append(k)
        vs.append(v)
    return apply_norm(cfg, params["final_norm"], x), (torch.stack(ks, dim=1),
                                                      torch.stack(vs, dim=1))


def _f32(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.to(torch.float32), tree)


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def _f32_layer(lp):
    """A layer's weights in fp32, but a moe layer's expert stacks, left in
    their dtype for the grouped GEMM to widen expert by expert."""
    out = _f32({k: v for k, v in lp.items() if k != "moe"})
    if "moe" in lp:
        moe = lp["moe"]
        out["moe"] = (_f32({k: v for k, v in moe.items() if k not in EXPERT_STACKS})
                      | {k: moe[k] for k in EXPERT_STACKS})
    return out


def _lm_head_f32(params):
    return _f32({k: params[k] for k in ("embed", "lm_head") if k in params})


def prefill_fp32(cfg, params, batch):
    """``prefill_step``'s outputs in fp32 from bf16 weights (``hidden_fp32``):
    (scores, last logits, bf16 caches)."""
    from repro_torch.models import model as M
    h, kv = hidden_fp32(cfg, params, batch)
    logits = M.lm_logits(cfg, _lm_head_f32(params), h[:, :, -1])
    scores = M._score_head(_f32(params["score_head"]), torch.mean(h, dim=2))
    return scores, logits, kv


def last_fp32(cfg, params, seqs):
    """For each token sequence, in fp32 from bf16 weights: the last
    position's logits [n, vocab] and score-head logit [n] (what the engine
    reports as ``Request.score``).  The sequences are right-padded into one
    causal forward: no position sees the padding after it."""
    from repro_torch.models import model as M
    dev = params["embed"]["table"].device
    n, L = len(seqs), max(len(q) for q in seqs)
    toks = torch.zeros((1, n, L), dtype=torch.int64, device=dev)
    for i, q in enumerate(seqs):
        toks[0, i, :len(q)] = torch.tensor(q, device=dev)
    h, _ = hidden_fp32(cfg, params, {"tokens": toks})
    last = h[0, torch.arange(n, device=dev),
             torch.tensor([len(q) - 1 for q in seqs], device=dev)]          # [n, d]
    logits = M.lm_logits(cfg, _lm_head_f32(params), last[None])[0]
    return logits, M.score_logit(_f32(params["score_head"]), last[None])[0]


def recorded(fn, routes: bool = False, keep: list | None = None):
    """fn()'s result, the (N, Kd, F, dtype) of every K5 call it makes, and
    (``routes``) each token's sorted expert set in every moe layer it runs,
    [L, T, k] in call order (one ``moe.route`` call a layer), or None.
    ``keep``: a list that gets the inputs (x, w, sizes) of fn's first three
    K5 calls, the first moe layer's gate, up and down (``check_path_k5``)."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.models import moe
    shapes, seen = set(), []
    route, gmm = moe.route, md.grouped_matmul

    def rec_route(cfg, p, xf):
        out = route(cfg, p, xf)
        seen.append(torch.sort(out[1], dim=-1).values.flatten(0, -2))
        return out

    def rec_gmm(x, w, sizes):
        shapes.add((x.shape[0], x.shape[1], w.shape[-1], str(x.dtype).replace("torch.", "")))
        if keep is not None and len(keep) < 3:
            keep.append((x.clone(), w, sizes.clone()))
        return gmm(x, w, sizes)

    md.grouped_matmul = rec_gmm
    if routes:
        moe.route = rec_route
    try:
        out = fn()
    finally:
        moe.route, md.grouped_matmul = route, gmm
    return out, shapes, (torch.stack(seen) if seen else None)


def require_k5_checked(label: str, shapes: set, checked: set):
    """Every K5 call of a path ran at a shape that ``check_grouped_matmul``
    held against its plain version in the same dtype."""
    if not shapes <= checked:
        raise SystemExit(f"{label}: K5 ran at {sorted(shapes - checked)}, shapes the kernel "
                         "check did not compare with its plain version")
    if shapes:
        print(f"{label}: every K5 call at a shape the kernel check compared (N, Kd, F, "
              f"dtype): {sorted(shapes)}")


def settled(routes, B: int, S: int):
    """[L, B, S] bool: the positions whose layer-l K and V no routing
    choice reached, held under the bf16 rule.  A layer's K and V at a
    position read only the positions up to it in the layers below, so a
    position is settled in layer l when no position at or before it in its
    sequence routes to another expert set in any two of ``routes`` ([L, T,
    k] each: the kernels', impl='ref''s and fp32's) in a layer below l."""
    L = routes[0].shape[0]
    flip = torch.zeros((L, B, S), dtype=torch.bool, device=routes[0].device)
    for i, a in enumerate(routes):
        for b in routes[i + 1:]:
            flip |= (a != b).any(-1).reshape(L, B, S)
    below = torch.zeros_like(flip)
    below[1:] = torch.cumsum(flip[:-1].int(), dim=0) > 0
    return torch.cumsum(below.int(), dim=2) == 0


def bf16_noise_check(label: str, kern: dict, plain: dict, exact: dict, *,
                     quiet: bool = False) -> dict:
    """The bf16 rule (BF16_NOISE_FACTOR): {name: tensor} of the kernels,
    impl="ref" and fp32; raises if the kernels are further from impl="ref"
    than the rule allows.  Returns each output's distances and limit;
    ``quiet`` prints one line for all of them (the largest distance, and
    the output nearest its limit) instead of one an output."""
    out, bad = {}, []
    for name, f in exact.items():
        f = f.float()
        direct = float((kern[name].float() - plain[name].float()).abs().max())
        er = float((plain[name].float() - f).abs().max())
        lim = BF16_NOISE_FACTOR * er + BF16_ULP * float(f.abs().max())
        ek = float((kern[name].float() - f).abs().max())
        out[name] = {"kernel_vs_ref": direct, "ref_vs_fp32": er, "limit": lim,
                     "kernel_vs_fp32": ek}
        if not quiet:
            print(f"{label}: {name}: kernels vs impl='ref' {direct:.3g} (limit {lim:.3g}: "
                  f"{BF16_NOISE_FACTOR:g}× impl='ref' vs fp32 {er:.3g} + one bf16 ulp); "
                  f"kernels vs fp32 {ek:.3g}")
        if not direct <= lim:
            bad.append(name)
    if quiet and out:
        def used(n):                # the share of its limit an output uses
            d, lim = out[n]["kernel_vs_ref"], out[n]["limit"]
            return d / lim if lim else (math.inf if d else 0.0)
        near = max(out, key=used)
        print(f"{label}: {len(out)} outputs, kernels vs impl='ref' at most "
              f"{max(o['kernel_vs_ref'] for o in out.values()):.3g}; nearest its limit: "
              f"{near} {out[near]['kernel_vs_ref']:.3g} (limit {out[near]['limit']:.3g}: "
              f"{BF16_NOISE_FACTOR:g}× impl='ref' vs fp32 {out[near]['ref_vs_fp32']:.3g} + "
              "one bf16 ulp)")
    if bad:
        raise SystemExit(f"{label}: the kernels' bf16 {bad} differ from impl='ref' by more "
                         "than the bf16 rule allows")
    return out


def attention_layers(cfg) -> int:
    """K4 launches in one forward: a layer's self attention, and an
    encoder-decoder's encoder layers and the decoder's cross attentions."""
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def prefill_batch(cfg, B: int, S: int, dev) -> dict:
    """A seeded prefill batch of one replica: S positions of tokens, or for
    vlm ``n_patches`` fp32 patch embeddings and S - n_patches tokens, or for
    audio S fp32 frames and S // decoder_fraction tokens."""
    g = torch.Generator(device=dev).manual_seed(1)
    n_tok = {"vlm": S - cfg.n_patches, "audio": S // cfg.decoder_fraction}.get(cfg.family, S)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, B, n_tok), generator=g,
                                     device=dev)}
    stub = {"vlm": cfg.n_patches, "audio": S}.get(cfg.family)
    if stub:
        batch["patches" if cfg.family == "vlm" else "frames"] = torch.randn(
            (1, B, stub, cfg.d_model), generator=g, device=dev)
    return batch


def ssm_scan_share(cfg, params, B: int, S: int, busy_ms: float) -> dict:
    """The SSM branch's share of a hybrid prefill's device time: the
    chunked scan (``models/ssm.linear_scan``) and the whole branch
    (``apply_ssm``: projections, convolution, the recurrence's inputs, the
    scan, its readout) of layer 0, timed with CUDA events on the prefill's
    [1, B, S] shape, times the layers, over the prefill's device busy time."""
    from repro_torch.models import blocks, ssm
    from repro_torch.models.mlp import linear
    di, N, _ = ssm._dims(cfg)
    table = params["embed"]["table"]
    g = torch.Generator(device=table.device).manual_seed(3)
    lp = blocks.unstack(params["layers"], cfg.n_layers)[0]["ssm"]
    x = torch.randn((1, B, S, cfg.d_model), generator=g, device=table.device).to(table.dtype)
    with torch.no_grad():
        xi = torch.nn.functional.silu(ssm._causal_conv(
            lp, torch.chunk(linear(x, lp["in_proj"]), 2, dim=-1)[0]))
        dA, dBx, _ = ssm._ssm_inputs(cfg, lp, xi)
        scan = cuda_ms(lambda: ssm.linear_scan(dA, dBx, 2), iters=3, warmup=1)
        del xi, dA, dBx
        branch = cuda_ms(lambda: ssm.apply_ssm(cfg, lp, x), iters=3, warmup=1)
    L = cfg.n_layers
    out = {"scan_ms_per_layer": scan, "ssm_ms_per_layer": branch,
           "scan_share": L * scan / busy_ms, "ssm_share": L * branch / busy_ms,
           "shape": [B, S, di, N]}
    print(f"ssm share: the scan {scan:.3f} ms and the SSM branch {branch:.3f} ms a layer "
          f"(CUDA events, [B={B}, S={S}, di={di}, N={N}] fp32); × {L} layers = "
          f"{100 * out['scan_share']:.1f} % and {100 * out['ssm_share']:.1f} % of the "
          f"prefill's {busy_ms:.2f} ms of device busy time")
    return out


def run_prefill(dev, path: PrefillPath, k5_checked: set, k5_inputs: list | None = None):
    """``prefill_step`` of ``path`` with the kernels (every counter set to 0
    just before one prefill and read just after: one K4 launch per layer,
    three K5 launches per moe layer, all of ``path.k4`` and ``path.k5``, at
    shapes in ``k5_checked``) and with ``impl="ref"``, compared under
    PREFILL_TOL in fp32 and under the bf16 rule (against ``prefill_fp32``)
    in bf16, where a moe model's caches are held at the ``settled``
    positions only; ms per prefill,
    tokens/s, peak memory, and one profiled prefill with the K4, K5 and
    cuBLAS GEMM shares.  ``k5_inputs`` gets the first moe layer's K5 inputs
    of the counted prefill (``recorded``).  Returns (the record, cfg,
    params): the serving phases reuse dbrx's parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    label, B, S = path.label, path.B, path.S
    cfg = get_config(path.arch)
    if path.n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=path.n_layers)
    print(f"{label}: reduced: {path.reduced.format(B=B, S=S)}")
    gc.collect()              # an earlier phase's cyclic garbage may hold the card
    torch.cuda.empty_cache()
    print(f"{label}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held before init")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=path.dtype, device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(l.numel() for l in leaves)
    n_bytes = sum(l.numel() * l.element_size() for l in leaves)
    dname = str(path.dtype).replace("torch.", "")
    print(f"{label}: init_params on the card in {time.perf_counter() - t0:.2f} s: "
          f"{n:,} {dname} parameters ({n_bytes / 1e9:.2f} GB"
          + ("; norms, router and score bias fp32" if path.dtype == BF16 else "")
          + f") in {len(leaves)} leaves")
    if n != path.n_params:
        raise SystemExit(f"{label}: {n:,} parameters, expected {path.n_params:,}")
    params = tree_map(lambda x: x[None], params)               # K = 1 (views)
    batch = prefill_batch(cfg, B, S, dev)
    # the decoder's positions: an encoder-decoder's tokens, else all S
    Sd = batch["tokens"].shape[2] if cfg.is_encoder_decoder else S
    prefill = lambda impl="auto": M.prefill_step(cfg, params, batch, impl=impl)
    moe_layers = cfg.n_layers if cfg.family == "moe" else 0
    n_attn = attention_layers(cfg)
    with torch.no_grad():
        prefill()                                               # warm-up
        torch.cuda.synchronize()
        zero_counts()
        (s, logits, (kc, vc)), k5_shapes, k_routes = recorded(prefill, routes=True,
                                                              keep=k5_inputs)
        torch.cuda.synchronize()
        counts, variants = read_counts(), read_variants()
        want = dict.fromkeys(counts, 0) | {"flash_attention": n_attn,
                                           "grouped_matmul": 3 * moe_layers}
        k4, k5 = variants["flash_attention"], variants["grouped_matmul"]
        if counts != want or k5[path.k5] != 3 * moe_layers:
            raise SystemExit(f"{label}: launch counts {counts} ({variants}), expected {want}, "
                             f"every K5 launch {path.k5}")
        print(f"{label}: launches {counts}; K4 variants {k4}; K5 variants {k5}")
        require_k4_variant(label, {"variant_launches": variants}, path.k4, str(path.dtype))
        require_k5_checked(label, k5_shapes, k5_checked)
        times = []
        for _ in range(3):
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        ms = sorted(times)[1]
        (rs, rlogits, (rk, rv)), _, r_routes = recorded(lambda: prefill("ref"), routes=True)
        torch.cuda.synchronize()
        ref_ms = []
        for _ in range(2):
            t = time.perf_counter()
            prefill("ref")
            torch.cuda.synchronize()
            ref_ms.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        errs = {"scores": float((s - rs).abs().max()),
                "logits": float((logits - rlogits).abs().max()),
                "k_cache": float((kc.float() - rk.float()).abs().max()),
                "v_cache": float((vc.float() - rv.float()).abs().max())}
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (s, logits, kc, vc))
        shapes_ok = (tuple(s.shape) == (1, B) and s.dtype == torch.float32
                     and tuple(logits.shape) == (1, B, cfg.vocab_size)
                     and tuple(kc.shape) == (1, cfg.n_layers, B, Sd, cfg.n_kv_heads,
                                             cfg.head_dim)
                     and kc.dtype == vc.dtype == torch.bfloat16)
        if path.dtype == torch.float32:
            cache_ok = all(bool(((a.float() - b.float()).abs() <= PREFILL_TOL["cache_atol"]
                                 + PREFILL_TOL["cache_rtol"] * b.float().abs()).all())
                           for a, b in ((kc, rk), (vc, rv)))
            print(f"{label}: kernels vs impl='ref' on the card: scores max_abs_err "
                  f"{errs['scores']:.3g} (atol {PREFILL_TOL['scores']}), last logits "
                  f"{errs['logits']:.3g} (atol {PREFILL_TOL['logits']}), bf16 caches k "
                  f"{errs['k_cache']:.3g} v {errs['v_cache']:.3g} (rtol 2^-7 + atol "
                  f"{PREFILL_TOL['cache_atol']}); shapes {'ok' if shapes_ok else 'WRONG'}, "
                  f"finite {finite}")
            if not (finite and shapes_ok and cache_ok
                    and errs["scores"] <= PREFILL_TOL["scores"]
                    and errs["logits"] <= PREFILL_TOL["logits"]):
                raise SystemExit(f"{label}: the prefill with kernels disagrees with "
                                 "impl='ref'")
            noise = None
        else:
            print(f"{label}: shapes {'ok' if shapes_ok else 'WRONG'}, finite {finite}; "
                  "against the same prefill in fp32 (bf16 rule):")
            if not (finite and shapes_ok):
                raise SystemExit(f"{label}: the bf16 prefill's outputs are not finite or "
                                 "not of the expected shapes")
            t = time.perf_counter()
            (fs, flog, (fk, fv)), _, f_routes = recorded(
                lambda: prefill_fp32(cfg, params, batch), routes=True)
            torch.cuda.synchronize()
            fp32_peak = torch.cuda.max_memory_allocated()
            print(f"{label}: the fp32 prefill took {time.perf_counter() - t:.2f} s; peak "
                  f"memory with it {peak_txt(fp32_peak)}")
            cut, held = (lambda c: c), None
            if moe_layers:
                # a routing flip moves a token's K and V by their own size, so
                # the caches are held where no flip reached them; the scores
                # and last logits read every position, flips included
                held = settled((k_routes, r_routes, f_routes), B, S)
                n_held = [int(n) for n in held.sum(dim=(1, 2))]
                print(f"{label}: caches held at the positions no routing flip reached, per "
                      f"layer {n_held} of {B * S}")
                if min(n_held) == 0:
                    raise SystemExit(f"{label}: a layer's caches have no settled position")
                cut = lambda c: c[0][held]
            outs = lambda a, b, c, d: dict(zip(F32_NAMES, (a, b, cut(c), cut(d))))
            noise = bf16_noise_check(label, outs(s, logits, kc, vc),
                                     outs(rs, rlogits, rk, rv), outs(fs, flog, fk, fv))
            noise["fp32_peak_bytes"] = fp32_peak
            if held is not None:
                noise["settled_positions"] = n_held
            del fs, flog, fk, fv, held
        del rs, rlogits, rk, rv
        torch.cuda.empty_cache()
        wall, busy, per = device_profile(prefill)
    total = sum(per.values())
    # cuBLAS names its fp32 GEMMs "…gemm…" and its bf16 Hopper GEMMs "nvjet_…"
    share = {name: sum(v for k, v in per.items() if any(t in k.lower() for t in tags))
             for name, tags in (("flash_attention", (KERNEL_TAGS["flash_attention"],)),
                                ("grouped_matmul", (KERNEL_TAGS["grouped_matmul"],)),
                                ("cublas_gemm", ("gemm", "nvjet")))}
    top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
    # positions through the stacks: an encoder-decoder's frames and tokens
    tokens = B * (S + Sd if cfg.is_encoder_decoder else S)
    ssm_share = ssm_scan_share(cfg, params, B, S, busy) if cfg.family == "hybrid" else None
    out = {"path": label, "dtype": dname, "ms_per_prefill": ms, "ms_runs": times,
           "ref_ms_per_prefill": sorted(ref_ms)[0], "tokens_per_s": tokens / ms * 1e3,
           "peak_bytes": peak, "launches": counts, "variant_launches": variants, "errs": errs,
           "bf16_rule": noise, "ssm": ssm_share,
           "profile": {"wall_ms": wall, "device_busy_ms": busy, "kernel_sum_ms": total,
                       "idle_share": 1.0 - busy / wall,
                       **{f"{k}_ms": v for k, v in share.items()},
                       **{f"{k}_share": v / total for k, v in share.items()},
                       "top_kernels_ms": {k[:90]: v for k, v in top}}}
    print(f"{label}: {ms:.2f} ms per prefill (median of {[round(t, 2) for t in times]}), "
          f"{tokens / ms * 1e3:,.0f} tokens/s, impl='ref' {sorted(ref_ms)[0]:.2f} ms; "
          f"peak memory {peak_txt(peak)}; launches {counts}")
    print(f"profile {label}: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
          f"{1.0 - busy / wall:.3f}), kernel time {total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f} %)" for k, v in share.items()))
    print(json.dumps({"profile": out["profile"] | {"path": label}}))
    del batch, s, logits, kc, vc
    return out, cfg, params


# --------------------------------------------------------------------------
# K5 grouped_matmul, the dbrx-132b prefill and serving paths
# --------------------------------------------------------------------------
# (atol, rtol): fp32 sums of up to d_ff = 10,752 products in another order;
# bf16 one bf16 ulp (2^-7 of the value) + fp32 noise near zero, as K4
GMM_TOL = {F32: (5e-5, 5e-5), BF16: (1e-4, 2 ** -7)}


def routed_sizes(seed: int, T: int, E: int, k: int, R: int = 1):
    """Group sizes [R·E] of a seeded top-k routing of T tokens per replica
    over random router logits (numpy), rows sorted by (replica, expert)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((R, T, E))
    top = np.argsort(-logits, axis=-1, kind="stable")[..., :k]
    return np.concatenate([np.bincount(top[r].ravel(), minlength=E) for r in range(R)])


def grouped_mm_fn(x, w, sizes):
    """One ``torch._grouped_mm`` call on the same inputs, where the installed
    torch offers one for them (the library yardstick; the port never calls
    it).  Returns (fn or None, why not)."""
    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if w.dim() != 3:
        return None, "torch._grouped_mm takes a [G, K, N] weight, not a strided K-fold view"
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    fn = lambda: torch._grouped_mm(x, w, offs=offs, out_dtype=x.dtype)
    try:
        fn()
        torch.cuda.synchronize()
    except Exception as e:     # the yardstick only: the port's path has no try
        return None, f"torch._grouped_mm refused {x.dtype}: {type(e).__name__}: {str(e)[:160]}"
    return fn, ""


def gmm_bound(x, w, sizes, rates, bf16_rate, kernel: str):
    """The least time for one call on this routing, the larger of: x read,
    the hit groups' weights read and out written (bytes); 2·N·Kd·F
    operations at the rate of the kernel's type — bf16, fp32 FFMA, or for
    gmm_tf32x3 three TF32 products an fp32 product at the TF32 rate (half
    the bf16 rate, as flash_fwd_tf32x3's).  Returns (bound, by, bytes, ops,
    {fp32: both bounds})."""
    N, Kd = x.shape
    F = w.shape[-1]
    es = x.element_size()
    hit = int((sizes > 0).sum())
    n_bytes = es * (N * Kd + hit * Kd * F + N * F)
    n_ops = 2 * N * Kd * F
    if x.dtype != F32:
        return (*bound_ms(n_bytes, n_ops, (rates[0], bf16_rate)), n_bytes, n_ops, {})
    ffma, ffma_by = bound_ms(n_bytes, n_ops, rates)
    tf, tf_by = bound_ms(n_bytes, 3 * n_ops, (rates[0], TF32_PER_BF16 * bf16_rate))
    both = {"bound_ffma_ms": ffma, "bound_ffma_by": ffma_by, "bound_tf32x3_ms": tf,
            "bound_tf32x3_by": tf_by}
    bnd, by = (tf, tf_by) if kernel == "gmm_tf32x3" else (ffma, ffma_by)
    return bnd, by, n_bytes, n_ops, both


def gmm_f64(x, w, sizes_np):
    """The float64 product on the card, one group's [Kd, F] block widened
    at a time (the yardstick of the fp32 kernels' error)."""
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=torch.float64, device=x.device)
    r0 = 0
    for g, n in enumerate(int(v) for v in sizes_np):
        blk = w[g] if w.dim() == 3 else w[g // w.shape[1], g % w.shape[1]]
        if n:
            out[r0:r0 + n] = x[r0:r0 + n].double() @ blk.double()
        r0 += n
    return out


def unaligned_copy(x):
    """x's values at a base 4 bytes past a 16-byte boundary: TMA cannot read
    it, so the wrapper routes an fp32 prefill call to gmm_tiles."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def gmm_case(rows: list, label: str, x, w, sizes, iters: int, rates, bf16_rate,
             want_kernel=None, tiles_beside: bool = False) -> dict:
    """K5 at one call's inputs against its plain version, within GMM_TOL;
    CUDA-event time, device time, the bound, the plain version's time and
    peak, torch._grouped_mm's time, and the row tiles the geometry
    launches beside those holding rows; in fp32 both bounds and the error
    against a float64 product, and with ``tiles_beside`` gmm_tiles on the
    same values (``unaligned_copy``) timed and held to the same references;
    at a gmm_wgmma_m128 case gmm_wgmma on the same values, timed and held
    bitwise equal to it (``wgmma_beside``).
    ``sizes``: the group sizes (a list, an array or a tensor on the card).
    Appends the record to ``rows`` and returns it."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ref
    dev = x.device
    sizes_np = (sizes.cpu().numpy() if torch.is_tensor(sizes)
                else np.asarray(sizes, np.int64))
    sizes = torch.from_numpy(sizes_np.astype(np.int64)).to(dev)
    atol, rtol = GMM_TOL[x.dtype]
    G = ref.n_groups(w)
    geo = md.launch_geometry(x.shape[0], x.shape[1], G, w.shape[-1], x.dtype,
                             md.tma_aligned(x, w))
    kernel = geo["kernel"]
    if want_kernel is not None and kernel != want_kernel:
        raise SystemExit(f"grouped_matmul {label}: routed to {kernel}, not {want_kernel}")
    before = md.variant_launches[kernel]
    got = md.grouped_matmul(x, w, sizes)
    # the plain version's memory above what the case holds (it copies
    # its group's [Kd, F] block for every row tile)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = ref.grouped_matmul_ref(x, w, sizes)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - held
    if md.variant_launches[kernel] != before + 1:
        raise SystemExit(f"grouped_matmul {label}: {kernel} was not launched")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * want.float().abs()).all()):
        raise SystemExit(f"grouped_matmul {label} disagrees with its plain version: "
                         f"max_abs_err={err} (atol {atol}, rtol {rtol})")
    del got, want, diff
    fn = lambda: md.grouped_matmul(x, w, sizes)
    ms = cuda_ms(fn, iters=iters, warmup=1)
    dev_ms, dev_src = kernel_device_ms(fn, "gmm_", md, calls=max(2, iters // 4),
                                       kernels_per_launch=2)   # offset scan + GEMM
    plain = cuda_ms(lambda: ref.grouped_matmul_ref(x, w, sizes), iters=max(2, iters // 2),
                    warmup=1)
    lib, why = grouped_mm_fn(x, w, sizes)
    lib_ms = cuda_ms(lib, iters=iters, warmup=1) if lib is not None else None
    bnd, by, n_bytes, n_ops, both = gmm_bound(x, w, sizes, rates, bf16_rate, kernel)
    f64 = {}
    if x.dtype == F32:
        # each fp32 kernel's error against the float64 product; at the
        # gmm_tf32x3 cases named, gmm_tiles on the same values beside it
        exact = gmm_f64(x, w, sizes_np)
        f64 = {"err_vs_f64": float((fn().double() - exact).abs().max()),
               "plain_err_vs_f64": float((ref.grouped_matmul_ref(x, w, sizes).double()
                                          - exact).abs().max())}
        if tiles_beside:
            xu = unaligned_copy(x)
            tgeo = md.launch_geometry(xu.shape[0], xu.shape[1], G, w.shape[-1], x.dtype,
                                      md.tma_aligned(xu, w))
            if tgeo["kernel"] != "gmm_tiles":
                raise SystemExit(f"grouped_matmul {label}: the unaligned copy routed to "
                                 f"{tgeo['kernel']}, not gmm_tiles")
            tfn = lambda: md.grouped_matmul(xu, w, sizes)
            before_t = md.variant_launches["gmm_tiles"]
            tgot = tfn()
            torch.cuda.synchronize()
            if md.variant_launches["gmm_tiles"] != before_t + 1:
                raise SystemExit(f"grouped_matmul {label}: gmm_tiles was not launched")
            twant = ref.grouped_matmul_ref(x, w, sizes)
            tdiff = (tgot - twant).abs()
            if not bool((tdiff <= atol + rtol * twant.abs()).all()):
                raise SystemExit(f"grouped_matmul {label}: gmm_tiles disagrees with its plain "
                                 f"version: max_abs_err={float(tdiff.max())}")
            t_ms = cuda_ms(tfn, iters=iters, warmup=1)
            t_dev, t_src = kernel_device_ms(tfn, "gmm_", md, calls=max(2, iters // 4),
                                            kernels_per_launch=2)
            f64["tiles"] = {"kernel": "gmm_tiles", "max_abs_err": float(tdiff.max()),
                            "err_vs_f64": float((tgot.double() - exact).abs().max()),
                            "ms": t_ms, "device_ms": t_dev, "device_ms_source": t_src,
                            "bound_ms": both["bound_ffma_ms"],
                            "bound_by": both["bound_ffma_by"]}
            del xu, tgot, twant, tdiff
        del exact
    if kernel == "gmm_wgmma_m128":
        f64["wgmma"] = wgmma_beside(label, x, w, sizes, iters, fn)
    hit = int((sizes_np > 0).sum())
    # row tiles: the grid's bound against the tiles that hold a row
    bm = geo["bm"]
    busy = int(sum(-(-int(n) // bm) for n in sizes_np if n > 0))
    dname = str(x.dtype).replace("torch.", "")
    rec = {"case": label, "N": x.shape[0], "Kd": x.shape[1], "F": w.shape[-1],
           "groups": G, "hit_groups": hit, "dtype": dname, "kernel": kernel,
           "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms,
           "device_ms": dev_ms, "device_ms_source": dev_src, "plain_ms": plain,
           "plain_peak_bytes": plain_peak, "library_ms": lib_ms,
           "library_note": why, "bound_ms": bnd, "bound_by": by,
           "gbytes": n_bytes / 1e9, "gflop": n_ops / 1e9, "bm": bm,
           "row_tiles": geo["grid"][0], "busy_row_tiles": busy,
           "row_share": x.shape[0] / max(busy * bm, 1), **both, **f64}
    rows.append(rec)
    lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else f"none ({why})"
    fp32_txt = ""
    if both:
        fp32_txt = (f"; bounds fp32 FFMA {both['bound_ffma_ms']:.4f} ms "
                    f"({both['bound_ffma_by']}), 3xTF32 at "
                    f"{TF32_PER_BF16 * bf16_rate / 1e12:.0f} TFLOP/s "
                    f"{both['bound_tf32x3_ms']:.4f} ms ({both['bound_tf32x3_by']}); error "
                    f"against float64 {f64['err_vs_f64']:.3g} (the plain version's "
                    f"{f64['plain_err_vs_f64']:.3g})")
        if "tiles" in f64:
            t = f64["tiles"]
            fp32_txt += (f"; gmm_tiles on the same values: {t['ms']:.4f} ms "
                         f"({dev_txt(t['device_ms'], t['device_ms_source'])}), error "
                         f"against float64 {t['err_vs_f64']:.3g}, against the plain version "
                         f"{t['max_abs_err']:.3g}")
    if "wgmma" in f64:
        t = f64["wgmma"]
        fp32_txt += (f"; gmm_wgmma on the same values: {t['ms']:.4f} ms "
                     f"({dev_txt(t['device_ms'], t['device_ms_source'])}), bitwise equal: "
                     f"{t['bitwise']}")
    print(f"grouped_matmul {label} [N={x.shape[0]}, Kd={x.shape[1]}, F={w.shape[-1]}, "
          f"G={G}, {hit} hit] {dname} {kernel}: max_abs_err={err:.3g} (atol {atol:g}, "
          f"rtol {rtol:g}); kernel {ms:.4f} ms ({dev_txt(dev_ms, dev_src)}), plain "
          f"{plain:.4f} ms (peak {plain_peak / 2**30:.3f} GiB above the case's tensors), "
          f"torch._grouped_mm {lib_txt}, bound {bnd:.4f} ms ({by}: "
          f"{n_bytes / 1e9:.3f} GB, {n_ops / 1e9:.1f} GFLOP); {geo['grid'][0]} row tiles "
          f"of {bm} launched, {busy} hold rows, {100 * rec['row_share']:.1f} % of their "
          f"rows real{fp32_txt}")
    return rec


@contextlib.contextmanager
def no_m128():
    """K5 calls inside pick gmm_wgmma where they would pick gmm_wgmma_m128
    (``ROWS_PER_GROUP_M128`` raised past any call), so a check can run both
    kernels on the same values."""
    from repro_torch.kernels import moe_dispatch as md
    threshold, md.ROWS_PER_GROUP_M128 = md.ROWS_PER_GROUP_M128, 1 << 30
    try:
        yield
    finally:
        md.ROWS_PER_GROUP_M128 = threshold


def wgmma_beside(label: str, x, w, sizes, iters: int, fn) -> dict:
    """gmm_wgmma on the values a gmm_wgmma_m128 case ran (``no_m128``):
    launched, bitwise the 128-row kernel's output (the same products in the
    same order), timed beside it."""
    from repro_torch.kernels import moe_dispatch as md
    got = fn()
    wfn = lambda: md.grouped_matmul(x, w, sizes)
    with no_m128():
        before = md.variant_launches["gmm_wgmma"]
        base = wfn()
        torch.cuda.synchronize()
        if md.variant_launches["gmm_wgmma"] != before + 1:
            raise SystemExit(f"grouped_matmul {label}: gmm_wgmma was not launched")
        if not torch.equal(got, base):
            raise SystemExit(f"grouped_matmul {label}: gmm_wgmma_m128 is not bitwise "
                             "gmm_wgmma")
        ms = cuda_ms(wfn, iters=iters, warmup=1)
        dev_ms, src = kernel_device_ms(wfn, "gmm_", md, calls=max(2, iters // 4),
                                       kernels_per_launch=2)
    return {"kernel": "gmm_wgmma", "bitwise": True, "ms": ms, "device_ms": dev_ms,
            "device_ms_source": src}


def check_grouped_matmul(dev, rates, bf16_rate) -> list:
    """K5 against its plain version on the card at dbrx-132b's and
    arctic-480b's full-width expert shapes (decode and prefill; gate/up and
    down), with K-folded strided weights, and at the reference's edge
    tables (``gmm_case``)."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def case(label, x, w, sizes_np, iters, want_kernel=None, tiles_beside=False):
        gmm_case(rows, label, x, w, sizes_np, iters, rates, bf16_rate, want_kernel,
                 tiles_beside)

    def randn(shape, dt=F32, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale).to(dt)

    # every weight at the model's init scale, Kd^-0.5 (moe.py:58-61), so the
    # outputs are O(1) as in the MoE layer and the tolerances are those of it

    # dbrx-132b: 16 experts, top-4, d 6144, d_ff 10752, fp32 (the model's
    # dtype: gmm_tf32x3 at the prefill's ~512 rows per expert, with
    # gmm_tiles — the FFMA kernel it replaced there — on the same values
    # beside it), then its prefill shape in bf16: ~512 rows per expert, where
    # the tensor cores and not the weight bytes bound the call
    # (gmm_wgmma_m128, gmm_wgmma on the same values beside it)
    d, ff, E = 6144, 10752, 16
    w_up, w_down = randn((E, d, ff), scale=d ** -0.5), randn((E, ff, d), scale=ff ** -0.5)
    for label, T, iters, kern in (("dbrx_decode", 4, 20, "gmm_rows"),
                                  ("dbrx_prefill", 2048, 3, "gmm_tf32x3")):
        sizes = routed_sizes(1, T, E, 4)
        beside = kern == "gmm_tf32x3"
        case(f"{label}_gate", randn((T * 4, d)), w_up, sizes, iters, kern, beside)
        case(f"{label}_down", randn((T * 4, ff)), w_down, sizes, iters, kern, beside)
    w_up, w_down = w_up.to(BF16), w_down.to(BF16)
    case("dbrx_prefill_gate_bf16", randn((8192, d), BF16), w_up, routed_sizes(1, 2048, E, 4),
         5, "gmm_wgmma_m128")
    case("dbrx_prefill_down_bf16", randn((8192, ff), BF16), w_down,
         routed_sizes(1, 2048, E, 4), 5, "gmm_wgmma_m128")
    # the bf16 serving path: every serve step, prefill ticks' included,
    # feeds one token a slot, so 4 slots × top-4 = 16 rows, 1-4 an expert
    case("dbrx_decode_gate_bf16", randn((16, d), BF16), w_up, routed_sizes(1, 4, E, 4), 20,
         "gmm_wgmma")
    case("dbrx_decode_down_bf16", randn((16, ff), BF16), w_down, routed_sizes(1, 4, E, 4), 20,
         "gmm_wgmma")
    del w_up, w_down
    torch.cuda.empty_cache()
    # arctic-480b: 128 experts, top-2, d 7168, d_ff 4864, bf16 (8.9 GB a stack):
    # gate/up [T·2, 7168] → 4864 and down [T·2, 4864] → 7168, at the serving
    # path's decode (4 slots: T = 4, 8 rows over 128 experts) and the
    # prefill path's [2, 1024] (T = 2048: ~32 rows an expert)
    d, ff, E = 7168, 4864, 128
    w, w_down = randn((E, d, ff), BF16, d ** -0.5), randn((E, ff, d), BF16, ff ** -0.5)
    for label, T, iters in (("arctic_decode", 4, 20), ("arctic_prefill", 2048, 5)):
        case(f"{label}_bf16", randn((T * 2, d), BF16), w, routed_sizes(2, T, E, 2), iters,
             "gmm_wgmma")
        case(f"{label}_down_bf16", randn((T * 2, ff), BF16), w_down, routed_sizes(2, T, E, 2),
             iters, "gmm_wgmma")
    del w, w_down
    torch.cuda.empty_cache()
    # K-folded groups: 4 replicas × 16 experts, a strided layer slice of a
    # [4, 2, 16, d, ff] stack at dbrx's smoke width, in both dtypes (through
    # the TMA maps), and in fp32 at d = 126, whose x rows TMA cannot read
    sizes = routed_sizes(3, 64, 16, 4, R=4)
    for dt, kern, dd, tag in ((F32, "gmm_tf32x3", 128, ""), (BF16, "gmm_wgmma", 128, ""),
                              (F32, "gmm_tiles", 126, "_d126")):
        stack = randn((4, 2, 16, dd, 256), dt, dd ** -0.5)
        case(f"kfold_4x16_strided_{str(dt)[6:]}{tag}", randn((int(sizes.sum()), dd), dt),
             stack[:, 1], sizes, 20, kern)
    # the same stack in bf16 at 128-200 rows a group: gmm_wgmma_m128
    stack = randn((4, 2, 16, 128, 512), BF16, 128 ** -0.5)
    ks = np.random.default_rng(29).integers(128, 200, 64)
    case("kfold_4x16_strided_bfloat16_m128", randn((int(ks.sum()), 128), BF16), stack[:, 1],
         ks, 20, "gmm_wgmma_m128")
    del stack
    # edges: the reference's group tables with Kd and F off the tiles, N = 1,
    # the 128-row kernels on ragged segments; gmm_wgmma on aligned ragged
    # groups with empty ones (Kd 136, F 520) and at N = 1
    for i, gs in enumerate(([3, 0, 6, 1], [0, 0, 10, 0], [10, 0, 0, 0], [1, 2, 3, 4])):
        case(f"table{i}_{'_'.join(map(str, gs))}", randn((sum(gs), 130)),
             randn((4, 130, 515), scale=130 ** -0.5), gs, 10, "gmm_rows")
    case("n1", randn((1, 6144)), randn((4, 6144, 1000), scale=6144 ** -0.5), [0, 1, 0, 0], 10,
         "gmm_rows")
    case("n1_bf16", randn((1, 6144), BF16), randn((4, 6144, 1000), BF16, 6144 ** -0.5),
         [0, 1, 0, 0], 10, "gmm_wgmma")
    # gmm_tiles on what TMA cannot read: bf16 F off 8, fp32 Kd off 4 (its
    # 16-byte w copies) and F off 4 (its 4-byte copies); gmm_tf32x3 on
    # ragged groups with empty ones, a 3-row tail, Kd and F off its tiles
    case("tiles_ragged_bfloat16", randn((273, 96), BF16), randn((4, 96, 300), BF16, 96 ** -0.5),
         [70, 0, 200, 3], 10, "gmm_tiles")
    case("tiles_ragged_float32", randn((273, 98)), randn((4, 98, 300), scale=98 ** -0.5),
         [70, 0, 200, 3], 10, "gmm_tiles")
    case("tiles_f302_float32", randn((273, 96)), randn((4, 96, 302), scale=96 ** -0.5),
         [70, 0, 200, 3], 10, "gmm_tiles")
    gs = [70, 0, 200, 3, 0]
    case("tf32x3_ragged", randn((sum(gs), 100)), randn((5, 100, 300), scale=100 ** -0.5), gs, 10,
         "gmm_tf32x3")
    case("aligned_ragged_bf16", randn((sum(gs), 136), BF16), randn((5, 136, 520), BF16,
                                                                    136 ** -0.5), gs, 10,
         "gmm_wgmma")
    # gmm_wgmma_m128 on ragged groups: 1-, 127-, 128- and 129-row groups, a
    # 385-row one (a 1-row tail), empty ones, Kd off 64, F off 256; and at
    # dbrx's d (96 stages through the ring)
    gs = [1, 0, 127, 128, 129, 385, 640]
    case("m128_ragged_bf16", randn((sum(gs), 136), BF16), randn((7, 136, 520), BF16,
                                                                 136 ** -0.5), gs, 10,
         "gmm_wgmma_m128")
    gs = [300, 0, 260]
    case("m128_ragged_d6144_bf16", randn((sum(gs), 6144), BF16),
         randn((3, 6144, 1000), BF16, 6144 ** -0.5), gs, 10, "gmm_wgmma_m128")
    return rows


SERVE_KW = dict(slots=4, max_len=64, prefill_chunk=8)
SERVE_TRACE = dict(kind="batch", n_requests=8, prompt_len=(8, 33), max_new=(8, 9), seed=0)
SERVE_SCORE_ATOL = 1e-4          # score-head logits after 2 fp32 layers
SERVE_GAP_TOL = 1e-4             # top-2 logit gap below which a token may flip


def peak_txt(peak: int) -> str:
    """A peak of device memory beside the card's capacity."""
    cap = torch.cuda.get_device_properties(0).total_memory
    return f"{peak / 2**30:.2f} GiB of the card's {cap / 2**30:.2f} GiB"


def tree_dtype(params):
    """The dtype of a transformer's weights (its embedding table's)."""
    return params["embed"]["table"].dtype


def read_variants() -> dict:
    """Launches of each kernel variant since the counters were last set to
    0: {kernel: {variant: launches}} for the kernels that have variants,
    and K4's flash_fill_no_key launches (counted apart from its variants)
    under "flash_fill_no_key"."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    return {k: dict(mod.variant_launches) for k, mod in train.KERNELS.items()
            if hasattr(mod, "variant_launches")} | {"flash_fill_no_key": fa.no_key_fills}


def _top2_gap(cfg, params, prompt, generated, j):
    """The impl='ref' top-2 logit gap at generated step j of one request,
    served alone (rows are independent through the model), and the logits
    it was read from."""
    from repro_torch.serving import decode as D
    seq = list(prompt) + list(generated[:j])
    dev = params["lm_head"].device
    toks = torch.tensor([seq], dtype=torch.int64, device=dev)
    cache = D.init_cache(cfg, 1, len(seq), dtype=torch.float32, device=dev)
    with torch.no_grad():
        _, logits = D.prefill(cfg, params, cache, toks, impl="ref")
    top = torch.topk(logits[0], 2).values
    return float(top[0] - top[1]), logits[0]


def _serve(cfg, params, impl, tick_log=None):
    """One engine over SERVE_TRACE; ``tick_log`` receives (serve steps, host
    ms) per tick — each tick ends in the engine's read of its tokens."""
    from repro_torch.serving import ServingEngine
    from repro_torch.serving import loadgen as LG
    eng = ServingEngine(cfg, params, impl=impl, **SERVE_KW)
    on_step = None
    if tick_log is not None:
        last = [time.perf_counter(), 0]

        def on_step(e):
            now = time.perf_counter()
            tick_log.append((e.steps - last[1], (now - last[0]) * 1e3))
            last[:] = [now, e.steps]
    trace = LG.make_trace(LG.TraceConfig(**SERVE_TRACE), cfg.vocab_size)
    reqs, wall = LG.run_trace(eng, trace, on_step=on_step)
    return eng, reqs, wall


def run_engine_serve(rates, cfg, params, k5_checked: set, label: str = "dbrx_serve",
                     k5_inputs: list | None = None) -> dict:
    """A model's parameters (full width, ``cfg.n_layers`` layers: dbrx-132b's,
    hymba-1.5b's) through the continuous-batching engine: a batch trace of 8 requests with
    impl='auto', then a second engine with impl='ref'; tokens equal, a flip
    allowed only where the ref run's top-2 logit gap is under the noise
    (fp32 weights: SERVE_GAP_TOL; bf16: the bf16 rule's limit for those
    logits against fp32), printed; scores within SERVE_SCORE_ATOL (bf16: the
    bf16 rule against each request's score logit in fp32); exactly 3 × layers K5
    launches per serve step of an moe model (the variant the counters show
    printed; with bf16 weights every one gmm_wgmma), at shapes in
    ``k5_checked``, and no launch of any other kernel
    (decode attention and the SSM step are plain tensor code); ms per
    prefill and per decode tick, tokens/s, TTFT and latency; one profiled
    decode tick (its idle share; an moe model's K5 time against its
    bound).  ``k5_inputs`` gets the first moe layer's K5 inputs of the
    counted run's first tick (``recorded``)."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import loadgen as LG
    layers = cfg.n_layers
    moe_layers = layers if cfg.family == "moe" else 0
    dname = str(tree_dtype(params)).replace("torch.", "")
    print(f"{label}: the {label.replace('serve', 'prefill')} parameters ({dname}, {layers} "
          f"layers); engine {SERVE_KW}; trace {SERVE_TRACE}")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        warm = ServingEngine(cfg, params, **SERVE_KW)          # allocator warm-up
        warm.add_request(Request(uid=-1, prompt=list(range(1, 12)), max_new_tokens=2))
        warm.run()
        torch.cuda.synchronize()
        zero_counts()
        ticks = []
        (eng, reqs, wall), k5_shapes, _ = recorded(lambda: _serve(cfg, params, "auto", ticks),
                                                   keep=k5_inputs)
        counts, variants = read_counts(), read_variants()
        want = dict.fromkeys(counts, 0) | {"grouped_matmul": 3 * moe_layers * eng.steps}
        if counts != want:
            raise SystemExit(f"{label}: launch counts {counts}, expected {want} (3 × "
                             f"{moe_layers} moe layers × {eng.steps} serve steps)")
        print(f"{label}: K5 variants by the wrapper's counters: "
              f"{variants['grouped_matmul']}")
        if (moe_layers and tree_dtype(params) == BF16
                and variants["grouped_matmul"]["gmm_wgmma"] != want["grouped_matmul"]):
            raise SystemExit(f"{label}: not every bf16 K5 launch was gmm_wgmma")
        require_k5_checked(label, k5_shapes, k5_checked)
        summary = LG.summarize(reqs, wall, eng)
        _, rreqs, _ = _serve(cfg, params, "ref")
    bf16 = tree_dtype(params) == BF16
    flips = []
    for r, rr in zip(reqs, rreqs, strict=True):
        if r.status != "done" or rr.status != "done":
            raise SystemExit(f"{label}: request {r.uid} ended {r.status}/{rr.status}")
        if r.generated != rr.generated:
            j = next(i for i, (a, b) in enumerate(zip(r.generated, rr.generated)) if a != b)
            gap, rlog = _top2_gap(cfg, params, r.prompt_used, rr.generated, j)
            lim = SERVE_GAP_TOL
            if bf16:
                # the bf16 noise of the ref run's logits at that position: the
                # bf16 rule's limit against the same logits in fp32
                with torch.no_grad():
                    f32, _ = last_fp32(cfg, params, [list(r.prompt_used) + rr.generated[:j]])
                lim = (BF16_NOISE_FACTOR * float((rlog.float() - f32[0]).abs().max())
                       + BF16_ULP * float(f32[0].abs().max()))
            flips.append({"uid": r.uid, "step": j, "gap": gap, "limit": lim})
            print(f"{label}: request {r.uid} differs from impl='ref' first at generated "
                  f"step {j} ({r.generated[j]} vs {rr.generated[j]}); the ref run's top-2 "
                  f"logit gap there is {gap:.3g} (limit {lim:.3g})")
            if not gap < lim:
                raise SystemExit(f"{label}: tokens differ from impl='ref' away from a tie")
    score_err = max(abs(r.score - rr.score) for r, rr in zip(reqs, rreqs))
    score_atol = SERVE_SCORE_ATOL
    if bf16:
        # the score-head logits under the bf16 rule, against each request's
        # last prompt position in fp32
        with torch.no_grad():
            _, s32 = last_fp32(cfg, params, [list(r.prompt_used) for r in reqs])
        as_t = lambda rs: torch.tensor([x.score for x in rs], device=s32.device)
        rule = bf16_noise_check(label, {"score_logits": as_t(reqs)},
                                {"score_logits": as_t(rreqs)}, {"score_logits": s32})
        score_atol = rule["score_logits"]["limit"]
    elif not score_err <= score_atol:
        raise SystemExit(f"{label}: scores differ from impl='ref' by {score_err} "
                         f"(limit {score_atol:.3g})")
    pre = [ms for c, ms in ticks if c == SERVE_KW["prefill_chunk"]]
    dec = [ms for c, ms in ticks if c == 1]
    print(f"{label}: {len(reqs)} requests, {eng.ticks} ticks ({len(pre)} prefill, "
          f"{len(dec)} decode), {eng.steps} serve steps; tokens equal to impl='ref' in "
          f"{len(reqs) - len(flips)} of {len(reqs)} requests, scores max_abs_err "
          f"{score_err:.3g} (limit {score_atol:.3g}); launches {counts}")
    print(f"{label}: {statistics.median(pre):.2f} ms per prefill tick (median), "
          f"{statistics.median(dec):.2f} ms per decode tick (median), "
          f"{summary['tokens_per_s']:.1f} tokens/s, TTFT p50/p99 {summary['ttft_p50_ms']:.1f}/"
          f"{summary['ttft_p99_ms']:.1f} ms, latency p50/p99 {summary['latency_p50_ms']:.1f}/"
          f"{summary['latency_p99_ms']:.1f} ms")
    # one decode tick under the profiler: 4 requests past their one-tick
    # prefill; K5's calls are recorded to bound them by the experts they hit
    seen = []
    real = md.grouped_matmul

    def recording(x, w, sizes):
        seen.append((tuple(x.shape), w.shape[-1], x.element_size(), sizes.clone()))
        return real(x, w, sizes)

    with torch.no_grad():
        peng = ServingEngine(cfg, params, **SERVE_KW)
        for i in range(4):
            peng.add_request(Request(uid=i, prompt=[7 + i] * 8, max_new_tokens=4))
        peng.step()
        torch.cuda.synchronize()
        md.grouped_matmul = recording
        try:
            wall_t, busy_t, per = device_profile(peng.step)
        finally:
            md.grouped_matmul = real
    k5 = sum(v for k, v in per.items() if "gmm_" in k)
    bound = 0.0
    for (N, Kd), F, es, sizes in seen:
        hit = int((sizes > 0).sum())
        bound += bound_ms(es * (N * Kd + hit * Kd * F + N * F), 2 * N * Kd * F, rates)[0]
    total = sum(per.values())
    prof = {"wall_ms": wall_t, "device_busy_ms": busy_t, "idle_share": 1.0 - busy_t / wall_t,
            "kernel_sum_ms": total, "grouped_matmul_ms": k5,
            "grouped_matmul_calls": len(seen), "grouped_matmul_bound_ms": bound,
            "grouped_matmul_share": k5 / total,
            "top_kernels_ms": {k[:90]: v for k, v in
                               sorted(per.items(), key=lambda kv: -kv[1])[:6]}}
    print(f"profile {label} decode tick: wall {wall_t:.2f} ms, device busy {busy_t:.2f} "
          f"ms (idle share {1.0 - busy_t / wall_t:.3f}), kernel time {total:.3f} ms"
          + (f"; grouped_matmul {k5:.3f} ms over {len(seen)} calls against a bound of "
             f"{bound:.3f} ms (bytes of the hit experts), {100 * k5 / total:.1f} % of kernel "
             "time" if moe_layers else ""))
    print(json.dumps({"profile": prof | {"path": f"{label}_decode_tick"}}))
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: peak memory {peak_txt(peak)} (both engines, the fp32 checks and the "
          "profiled tick)")
    return {"path": label, "launches": counts, "variant_launches": variants,
            "peak_bytes": peak,
            "steps": eng.steps, "ticks": eng.ticks,
            "ms_per_prefill_tick": statistics.median(pre),
            "ms_per_decode_tick": statistics.median(dec), "flips": flips,
            "score_max_abs_err": score_err, "profile": prof,
            **{k: summary[k] for k in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                                       "latency_p50_ms", "latency_p99_ms",
                                       "generated_tokens", "wall_s")}}


SERVE_SMOKE = ("dbrx_serve_smoke", ["--arch", "dbrx-132b", "--labeled", "--metrics",
                                    "sketch"])


def run_serve_smoke() -> tuple[dict, dict, str]:
    """``launch/serve.py --arch dbrx-132b --labeled --metrics sketch`` on the
    card, every counter set to 0 just before: exactly 3 × 2 K5 launches per
    serve step and no other kernel."""
    from repro_torch.launch import serve
    label, args = SERVE_SMOKE
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve.main(args)
    text = buf.getvalue()
    print(text, end="")
    counts = read_counts()
    out["variant_launches"] = read_variants()
    steps = out["engine"].steps
    want = dict.fromkeys(counts, 0) | {"grouped_matmul": 3 * 2 * steps}
    print(f"main path {label}: {out['completed']} requests, {steps} serve steps, "
          f"launches {counts}")
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts}, expected {want}")
    return out, counts, text


def serve_lines(text: str):
    """The ``req …`` lines and the final streaming AUC of serve.py's output."""
    reqs = re.findall(r"^req \d+: .*$", text, re.M)
    auc = re.search(r"^\[serve\] final .*streaming auc=(\d\.\d+)", text, re.M)
    return reqs, float(auc.group(1)) if auc else None


# --------------------------------------------------------------------------
# arctic-480b (128 experts top-2 beside a dense residual MLP) and
# phi3-medium-14b in bf16 at full width: prefill and the serving engine
# --------------------------------------------------------------------------
def check_path_k5(label: str, kept: list, rows: list, rates, bf16_rate, iters: int) -> list:
    """K5 at the inputs a path gave it: the first moe layer's gate and down
    calls ``recorded`` kept — its rows, its expert stacks and the group
    sizes its own router chose — held against the plain version and timed
    (``gmm_case``; records appended to ``rows``)."""
    out = []
    for name, (x, w, sizes) in zip(("gate", "up", "down"), kept, strict=True):
        if name == "up":                     # the gate's shape and routing
            continue
        if w.dim() == 4 and w.shape[0] == 1:  # K = 1: the layer's [E, Kd, F] stack
            w = w[0]
        with torch.no_grad():
            out.append(gmm_case(rows, f"{label}_{name}_routed", x, w, sizes, iters, rates,
                                bf16_rate, "gmm_wgmma"))
    return out


def run_bf16_big(dev, rates, bf16_rate, k5_checked: set, gmm_rows: list, prefills: dict,
                 counts: dict) -> dict:
    """arctic-480b (2 of 35 layers) and phi3-medium-14b (all 40) in bf16 at
    full width: each prefill (``run_prefill``: every K4 launch
    flash_fwd_pingpong, every K5 launch gmm_wgmma, against impl="ref" and
    under the bf16 rule against fp32, whose baseline widens arctic's
    experts one block at a time) and the same weights through the engine
    (``run_engine_serve``); arctic's K5 also at the inputs its own router
    gives it in both (``check_path_k5``)."""
    out = {}
    for path in (BF16_ARCTIC_PREFILL, BF16_PHI3_PREFILL):
        label, kept, serve_kept = path.label, [], []
        prefills[label], cfg, params = run_prefill(dev, path, k5_checked, kept)
        counts[label] = prefills[label]["launches"]
        serve = label.replace("prefill", "serve")
        rec = {"prefill": prefills[label]}
        rec["serve"] = run_engine_serve(rates, cfg, params, k5_checked, serve, serve_kept)
        counts[serve] = rec["serve"]["launches"]
        if cfg.family == "moe":
            rec["k5_routed"] = (
                check_path_k5(label, kept, gmm_rows, rates, bf16_rate, 5)
                + check_path_k5(serve, serve_kept, gmm_rows, rates, bf16_rate, 20))
        del kept, serve_kept
        out[serve] = rec["serve"]
        out[label] = rec
        del params
        torch.cuda.empty_cache()
        stamp(f"{label} and {serve} done")
    print(json.dumps({"bf16_big": {k: {kk: vv for kk, vv in v.items() if kk != "profile"}
                                   for k, v in out.items()}}, default=str))
    return out


# stablelm-1.6b CoDA with bf16 parameters: full width, 2 of 24 layers, as
# stablelm_train.  The launchers have no parameter-dtype flag (the
# reference's have none), so the path is driven through coda.init_state and
# coda.fit, which is how the reference reaches CoDAConfig.param_dtype.
BF16_CODA = dict(K=4, B=32, I=8, T0=16, n_data=1024)
# the sharded bf16 fit and its batched twin: 6 windows of 8 local steps, so
# the ms per local step is a median over 5 steady windows
BF16_SHARD_T0 = 48


def run_bf16_coda(dev) -> tuple[dict, dict]:
    """``bf16_stablelm_coda``: one local step's losses and every gradient
    leaf with the kernels and with impl='ref' held to the same step in fp32
    (the bf16 rule); then ``coda.fit`` (one stage, 16 local steps) with
    every counter set to 0 just before and read just after: auc_loss once a
    local step, prox_update once a local step (step_launches), flash_attention once a
    layer a forward, every K4 launch flash_fwd_pingpong; the test AUC of the
    held-out split; one profiled window."""
    from repro_torch.configs import get_config
    from repro_torch.core import coda, objective, schedules
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    label, c = "bf16_stablelm_coda", BF16_CODA
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    print(f"main path {label}: reduced: {TRAIN_LAYERS} of 24 layers (full width), K={c['K']}, "
          f"B={c['B']}, S=64, one stage of {c['T0']} local steps; param_dtype bfloat16 "
          "through coda.init_state and coda.fit")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ds = ShardedDataset(train.data_config_for(cfg, 0.71), c["n_data"], c["K"], seed=0,
                        target_p=0.71, device=dev)
    ccfg = coda.CoDAConfig(n_workers=c["K"], p_pos=ds.p_pos, param_dtype=BF16)
    state = coda.init_state(cfg, ccfg, generator=torch.Generator().manual_seed(0),
                            device=dev)
    leaves = tree_leaves(state["params"])
    p = state["params"]
    weights = [p["embed"]["table"], p["lm_head"], p["score_head"]["w"],
               *tree_leaves(p["layers"]["attn"]), *tree_leaves(p["layers"]["mlp"])]
    if {l.dtype for l in weights} != {BF16}:
        raise SystemExit(f"{label}: the weight leaves are not all bf16")
    # one local step's losses and gradients: the kernels, impl='ref', fp32
    batch = ds.sample_alpha_batch(c["B"])
    step = {}
    for name, kw in (("kernels", {}), ("ref", {"impl": "ref"}),
                     ("fp32", {"impl": "ref", "param_dtype": F32})):
        st = state if name != "fp32" else dict(
            state, params=tree_map(lambda x: x.to(F32), state["params"]))
        losses, (gp, _), _ = coda.grad_step_scores(
            cfg, dataclasses.replace(ccfg, **kw), st, batch)
        step[name] = {"losses": losses, **{f"grad{i}": g
                                           for i, g in enumerate(tree_leaves(gp))}}
        del st, gp
    torch.cuda.synchronize()
    rule = bf16_noise_check(f"main path {label} local step", *step.values())
    if not all(bool(torch.isfinite(t.float()).all()) for t in step["kernels"].values()):
        raise SystemExit(f"{label}: a non-finite loss or gradient")
    del step
    torch.cuda.empty_cache()
    sched = schedules.ScheduleConfig(n_workers=c["K"], eta0=0.5, T0=c["T0"], I0=c["I"],
                                     p_pos=ds.p_pos)
    torch.cuda.synchronize()
    check_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()      # the fit's own peak from here
    zero_counts()
    res = coda.fit(state, cfg, ccfg, sched, 1,
                   sample_window=lambda i: ds.sample_window(i, c["B"]),
                   sample_alpha_batch=ds.sample_alpha_batch)
    torch.cuda.synchronize()
    counts, variants = read_counts(), read_variants()
    steps, stages = res.iterations, 1
    want = dict.fromkeys(counts, 0) | {
        "auc_loss": steps, "prox_update": steps * step_launches("prox_update", res.state),
        "flash_attention": TRAIN_LAYERS * (steps + stages)}
    k4 = variants["flash_attention"]
    print(f"main path {label}: {steps} local steps, launches {counts}, K4 variants {k4}")
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts} ({variants}), expected {want}")
    require_k4_variant(label, {"variant_launches": variants}, "flash_fwd_pingpong",
                       "bf16, head_dim 64")
    losses = [h[2] for h in res.history]
    ms = 1e3 * statistics.median(res.step_seconds[1:] or res.step_seconds)
    test = ds.full(2048)
    params0 = tree_map(lambda x: x[:1], res.state["params"])
    with torch.no_grad():
        h = torch.cat([M.score(cfg, params0, {"tokens": test["tokens"][i:i + 512][None]})[0][0]
                       for i in range(0, test["labels"].shape[0], 512)])
    auc = objective.roc_auc(h, test["labels"])
    peak = torch.cuda.max_memory_allocated()
    print(f"main path {label}: {ms:.3f} ms per local step (steady median), peak memory "
          f"{peak / 2**30:.3f} GiB (the local-step check before the fit: "
          f"{check_peak / 2**30:.3f} GiB), window losses {[round(x, 5) for x in losses]}, "
          f"test AUC {auc:.4f}")
    if not (all(math.isfinite(x) for x in losses) and bool(torch.isfinite(h).all())):
        raise SystemExit(f"{label}: a non-finite loss or test score")
    prof = profile_window(label, cfg, res.state, dev, consume=True, param_dtype=BF16)
    return ({"auc": auc, "ms_per_local_step": ms, "peak_bytes": peak,
             "check_peak_bytes": check_peak, "losses": losses, "bf16_rule": rule,
             "variant_launches": variants, "profile": prof}, counts)


# the crash-resume on the card: path (b)'s configuration (mlp_codasca_faults:
# CODASCA on Dirichlet shards with dropout, stragglers and the sketch)
# through coda.fit; the mlp's kernels are deterministic (K1's fixed-order
# ticket, elementwise K2, cuBLAS at fixed shapes), so a resumed run must be
# bitwise the uninterrupted one
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
CRASH_AFTER, CKPT_EVERY = 5, 2


def run_crash_resume(dev) -> tuple[dict, dict]:
    """``mlp_crash_resume``: the uninterrupted ``coda.fit`` (every counter
    set to 0 just before: auc_loss once a local step, prox_update once a
    local step: step_launches), then the same run whose window sampler raises after
    window 5 with a checkpoint every 2 windows, then ``resume=True``: the
    final state, history, rounds and bytes bitwise the uninterrupted run's."""
    import shutil
    from repro_torch.checkpoint import checkpoint
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda, schedules
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    label, mcfg = "mlp_crash_resume", mlp_config()

    class Crash(RuntimeError):
        pass

    def run(crash_after=None, **kw):
        ds = ShardedDataset(train.data_config_for(mcfg, 0.71), 8192, 4, seed=0, target_p=0.71,
                            dirichlet_alpha=0.1, device=dev)
        ccfg = coda.CoDAConfig(n_workers=4, p_pos=ds.p_pos, algorithm="codasca",
                               participation=0.75, straggler_prob=0.2, straggler_windows=2,
                               max_staleness=2, fault_seed=3, stream_bins=2048)
        sched = schedules.ScheduleConfig(n_workers=4, eta0=0.5, T0=60, I0=8, p_pos=ds.p_pos)
        drawn = [0]

        def sample_window(i):
            if crash_after is not None and drawn[0] >= crash_after:
                raise Crash(f"window draw {drawn[0]}")
            drawn[0] += 1
            return ds.sample_window(i, 32)

        st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0), device=dev)
        return coda.fit(st, mcfg, ccfg, sched, 3, sample_window, ds.sample_alpha_batch,
                        rng=ds.draw_rng, **kw)

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    zero_counts()
    want = run()
    torch.cuda.synchronize()
    counts, variants = read_counts(), read_variants()
    steps = want.iterations
    expect = dict.fromkeys(counts, 0) | {
        "auc_loss": steps, "prox_update": steps * step_launches("prox_update", want.state)}
    if counts != expect:
        raise SystemExit(f"{label}: launch counts {counts}, expected {expect}")
    try:
        run(CRASH_AFTER, ckpt_dir=CKPT_DIR, ckpt_every=CKPT_EVERY)
        raise SystemExit(f"{label}: the crashing sampler did not crash")
    except Crash:
        pass
    last = checkpoint.latest_step(CKPT_DIR)
    got = run(ckpt_dir=CKPT_DIR, ckpt_every=CKPT_EVERY, resume=True)
    torch.cuda.synchronize()
    a, b = tree_leaves(want.state), tree_leaves(got.state)
    same_state = len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                          for x, y in zip(a, b))
    same = {"state": same_state, "history": want.history == got.history,
            "rounds": want.comm_rounds == got.comm_rounds,
            "iterations": want.iterations == got.iterations,
            "bytes": (want.exposed_bytes, want.overlapped_bytes)
            == (got.exposed_bytes, got.overlapped_bytes)}
    print(f"main path {label}: {steps} local steps, {want.comm_rounds} rounds, "
          f"{want.exposed_bytes:,} bytes a worker (masked payload "
          f"{coda.window_payload_bytes(want.state, masked=True):,} a window); crashed after "
          f"window {CRASH_AFTER}, resumed from checkpoint {last} ({len(got.step_seconds)} "
          f"windows run again); bitwise the uninterrupted run: {same}; launches {counts}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if last != CRASH_AFTER - CRASH_AFTER % CKPT_EVERY or not all(same.values()):
        raise SystemExit(f"{label}: the resumed run is not the uninterrupted run ({same}, "
                         f"latest checkpoint {last})")
    if not all(math.isfinite(h[2]) for h in want.history):
        raise SystemExit(f"{label}: a non-finite loss")
    return {"same": same, "steps": steps, "resumed_from": last, "variant_launches": variants,
            "ms_per_local_step": 1e3 * statistics.median(want.step_seconds[1:])}, counts


# stablelm-1.6b CODASCA under faults at full width with 2 layers and bf16
# parameters (the bf16 CoDA path's cut), through coda.init_state / coda.fit
BF16_CODASCA_FAULTS = dict(algorithm="codasca", participation=0.75, straggler_prob=0.2,
                           max_staleness=1)


def run_bf16_codasca(dev) -> tuple[dict, dict]:
    """``bf16_stablelm_codasca``: from a state that has taken one window
    (nonzero, unequal variates), one local step's losses and one masked
    window's merged state (parameters, duals, and the refreshed ``cv`` and
    ``cg``) with the kernels and with impl='ref', held to the same in fp32
    under the bf16 rule; then ``coda.fit`` (one stage, 16
    local steps) with every counter set to 0 just before and read just
    after: auc_loss once a local step, prox_update once a local step,
    flash_attention once a layer a forward, every K4 launch
    flash_fwd_pingpong; peak memory, ms per local step, the mixed bf16/f32
    buckets, the test AUC, one profiled window."""
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, coda, objective, schedules
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    label, c = "bf16_stablelm_codasca", BF16_CODA
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    print(f"main path {label}: reduced: {TRAIN_LAYERS} of 24 layers (full width), K={c['K']}, "
          f"B={c['B']}, S=64, one stage of {c['T0']} local steps; param_dtype bfloat16 "
          f"through coda.init_state and coda.fit; {BF16_CODASCA_FAULTS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ds = ShardedDataset(train.data_config_for(cfg, 0.71), c["n_data"], c["K"], seed=0,
                        target_p=0.71, device=dev)
    ccfg = coda.CoDAConfig(n_workers=c["K"], p_pos=ds.p_pos, param_dtype=BF16,
                           **BF16_CODASCA_FAULTS)
    plan = FaultPlan.from_config(ccfg)

    def window_faults(w):
        return {k: torch.from_numpy(v).to(dev) for k, v in zip(("weights", "resync"),
                                                                 plan.window(w))}

    # the checked window: the first after window 0 with an absent worker, so
    # its merge is a masked one
    w0 = next(w for w in range(1, 64) if plan.window(w)[0].min() == 0.0)

    def fresh():
        return coda.init_state(cfg, ccfg, generator=torch.Generator().manual_seed(0),
                               device=dev)

    state = fresh()
    n_leaves = len(tree_leaves(state["params"]))
    k2_step = step_launches("prox_update", state)
    buckets = bucketing.bucket_layout(state, masked=True)
    print(f"main path {label}: window buckets (bytes a worker) "
          f"{ {t: b['bytes'] for t, b in buckets.items()} }, payload "
          f"{coda.window_payload_bytes(state, masked=True):,} = 2 × model_bytes "
          f"{coda.model_bytes(state):,} + {coda.mask_payload_bytes(state)} B of lanes")
    if set(buckets) != {"bf16", "f32"} or coda.window_payload_bytes(state, masked=True) != \
            2 * coda.model_bytes(state) + 8:
        raise SystemExit(f"{label}: the window payload is not the mixed bf16/f32 buckets "
                         "of 2 × model_bytes + 8")
    # window 0 with the kernels: afterwards each participant holds its own
    # variate c_k and cg their mean, so the checked window's correction
    # g + (cg − c_k) is not the raw gradient
    state, _ = coda.make_executor(cfg, ccfg).window_step(
        state, ds.sample_window(c["I"], c["B"]), 0.5, faults=window_faults(0))
    cv, cg = tree_leaves(state["cv_params"]), tree_leaves(state["cg_params"])
    corrected = sum(bool((v != g).any()) for v, g in zip(cv, cg))
    reached = sum(bool(g.any()) for g in cg)
    print(f"main path {label}: after window 0, {corrected} of {n_leaves} parameter leaves "
          f"carry a nonzero correction cg − c_k ({reached} leaves with a nonzero cg)")
    if corrected == 0 or corrected < reached:
        raise SystemExit(f"{label}: window 0 left equal variates on a leaf the loss reaches")
    del cv, cg
    # one local step's losses and window w0's merged state (params, duals and
    # both variate trees): the kernels, impl='ref', and the same window in
    # fp32 (impl='ref'; the replicated ref_params and cg widened from one row)
    batch = ds.sample_alpha_batch(c["B"])
    wb = ds.sample_window(c["I"], c["B"])
    fl = window_faults(w0)
    merged_keys = ("params", "duals", "cv_params", "cv_duals", "cg_params", "cg_duals")

    def window(st, run_cfg, keep, donate=False):
        lo, _, _ = coda.grad_step_scores(cfg, run_cfg, st, batch)
        # the kernels' and ref's windows run out of place (no donation) from
        # one state; the fp32 one consumes its widened copy
        new, _ = coda.make_executor(cfg, run_cfg, donate=donate).window_step(st, wb, 0.5,
                                                                             faults=fl)
        # cg is replicated: one row of it
        out = {k: {f"{k}{i}": (x[:1] if k.startswith("cg_") else x).to(keep)
                   for i, x in enumerate(tree_leaves(new[k]))} for k in merged_keys}
        del new
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return lo, out

    losses, merged = {}, {}
    for name, kw in (("kernels", {}), ("ref", {"impl": "ref"})):   # held on the host
        losses[name], merged[name] = window(state, dataclasses.replace(ccfg, **kw), "cpu")

    def widen(key, x):
        if key not in ("ref_params", "cg_params"):
            return x.to(F32)
        if not torch.equal(x, x[:1].expand(x.shape)):
            raise SystemExit(f"{label}: {key} is not replicated over the workers")
        return x[:1].to(F32).expand(x.shape)

    st32 = {k: tree_map(lambda x, k=k: widen(k, x), v) for k, v in state.items()}
    del state
    torch.cuda.empty_cache()
    losses["fp32"], merged["fp32"] = window(
        st32, dataclasses.replace(ccfg, impl="ref", param_dtype=F32), dev, donate=True)
    del st32
    cmp_peak = torch.cuda.max_memory_allocated()
    rule = {"losses": bf16_noise_check(f"main path {label} local step",
                                       *({"losses": l} for l in losses.values()))}
    for key in merged_keys:
        rule[key] = bf16_noise_check(
            f"main path {label} window {w0} merged {key}",
            *({n: t.to(dev) for n, t in merged[run][key].items()} for run in ("kernels", "ref")),
            merged["fp32"][key], quiet=True)
    if not all(bool(torch.isfinite(t.float()).all())
               for group in merged["kernels"].values() for t in group.values()):
        raise SystemExit(f"{label}: a non-finite merged leaf")
    del merged, losses
    torch.cuda.empty_cache()
    state = fresh()
    sched = schedules.ScheduleConfig(n_workers=c["K"], eta0=0.5, T0=c["T0"], I0=c["I"],
                                     p_pos=ds.p_pos)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = coda.fit(state, cfg, ccfg, sched, 1,
                   sample_window=lambda i: ds.sample_window(i, c["B"]),
                   sample_alpha_batch=ds.sample_alpha_batch)
    torch.cuda.synchronize()
    counts, variants = read_counts(), read_variants()
    peak = torch.cuda.max_memory_allocated()
    del state
    steps, stages = res.iterations, 1
    want = dict.fromkeys(counts, 0) | {
        "auc_loss": steps, "prox_update": steps * k2_step,
        "flash_attention": TRAIN_LAYERS * (steps + stages)}
    k4 = variants["flash_attention"]
    print(f"main path {label}: {steps} local steps, launches {counts}, K4 variants {k4}")
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts} ({variants}), expected {want}")
    require_k4_variant(label, {"variant_launches": variants}, "flash_fwd_pingpong",
                       "bf16, head_dim 64")
    losses = [h[2] for h in res.history]
    ms = 1e3 * statistics.median(res.step_seconds[1:] or res.step_seconds)
    test = ds.full(2048)
    params0 = tree_map(lambda x: x[:1], res.state["params"])
    with torch.no_grad():
        h = torch.cat([M.score(cfg, params0, {"tokens": test["tokens"][i:i + 512][None]})[0][0]
                       for i in range(0, test["labels"].shape[0], 512)])
    auc = objective.roc_auc(h, test["labels"])
    print(f"main path {label}: {ms:.3f} ms per local step (steady median), peak memory "
          f"{peak / 2**30:.3f} GiB (the three-way window check: {cmp_peak / 2**30:.3f} GiB), "
          f"window losses {[round(x, 5) for x in losses]}, rounds {res.comm_rounds}, "
          f"bytes a worker {res.exposed_bytes:,}, test AUC {auc:.4f}")
    if not (all(math.isfinite(x) for x in losses) and bool(torch.isfinite(h).all())):
        raise SystemExit(f"{label}: a non-finite loss or test score")
    prof = profile_window(label, cfg, res.state, dev, consume=True, param_dtype=BF16,
                          **BF16_CODASCA_FAULTS)
    return ({"auc": auc, "ms_per_local_step": ms, "peak_bytes": peak,
             "check_peak_bytes": cmp_peak, "losses": losses, "bf16_rule": rule,
             "variant_launches": variants, "profile": prof,
             "payload_by_dtype": {t: b["bytes"] for t, b in buckets.items()}}, counts)


def collective_contract(argv: list, out: dict) -> tuple[dict, dict]:
    """The collectives ``fit`` made on a launcher path (the summary's
    ``collectives``) and what the reference's contract gives for the same
    flags, schedule and state: a window one all_reduce per dtype bucket of
    ``window_payload_by_dtype`` bytes (int8: the s8 and f32 all_gather
    pair), each window of an overlapped pair ``ring_hop_count`` hops (none
    at R = 1) and no all_reduce, a stage end one all_reduce of its 4-byte
    α, and one loss read-out per window step.  Returns (got, want)."""
    from repro_torch.core import bucketing, coda, schedules
    from repro_torch.launch import train
    a = train.build_parser().parse_args(argv)
    sched = schedules.ScheduleConfig(n_workers=a.workers, eta0=a.eta0, T0=a.t0, I0=a.interval)
    n = [-(-st.T // st.I) for st in schedules.stages(sched, a.stages)]
    pairs = sum(x // 2 for x in n) if a.overlap else 0
    single = sum(n) - 2 * pairs
    st, R = out["state"], math.prod(out["mesh"].values())
    masked = a.participation < 1.0 or a.straggler_prob > 0.0
    want = {k: {"calls": 0, "bytes": 0} for k in ("all_reduce", "all_gather", "p2p")}
    if a.compress == "int8":
        leaves = coda._payload_leaves(st)
        per_worker = sum(l.numel() // l.shape[0] for l in leaves) + 4 * len(leaves) \
            + (4 if masked else 0)
        want["all_gather"] = {"calls": 2 * single, "bytes": single * a.workers // R * per_worker}
    else:
        by = coda.window_payload_by_dtype(st, masked=masked)
        want["all_reduce"] = {"calls": single * len(by), "bytes": single * sum(by.values())}
        layout = bucketing.bucket_layout(st, masked=masked)
        ring = bucketing.RingSpec(R, a.overlap_chunks)
        size = {"f32": 4, "bf16": 2}
        hop_bytes = sum(-(-(hi - lo) // R) * size[t] * 2 * (R - 1)
                        for t, b in layout.items()
                        for offs in [bucketing._chunk_offsets(
                            b["elements"], bucketing._n_chunks(b["elements"], ring))]
                        for lo, hi in zip(offs[:-1], offs[1:])) if R > 1 else 0
        hops = bucketing.ring_hop_count({t: b["elements"] for t, b in layout.items()}, ring)
        want["p2p"] = {"calls": 2 * pairs * hops, "bytes": 2 * pairs * hop_bytes}
    want["all_reduce"]["calls"] += a.stages
    want["all_reduce"]["bytes"] += 4 * a.stages
    got = {k: v for k, v in out["collectives"].items() if k in want}
    got["readout_calls"] = out["collectives"]["readout"]["calls"]
    want["readout_calls"] = single + pairs
    return got, want


def params_equal(a: dict, b: dict) -> bool:
    """Two launcher runs' final parameters bitwise equal."""
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(
        *(tree_leaves(r["state"]["params"]) for r in (a, b)), strict=True))


def run_sharded(runs: dict, counts: dict, label: str, argv: list, twin: str,
                per_leaf: str, bitwise: bool) -> dict:
    """One launcher path with ``--executor shard_map`` beside its vmap twin:
    the launch counts of ``run_main_path``, the collectives against the
    contract, test AUC within 0.01 of the twin's and, with ``bitwise``, the
    final parameters bitwise the twin's."""
    leaves = RN_LEAVES if "--arch" in argv else MLP_LEAVES
    runs[label], counts[label] = run_main_path(f"main path {label}", argv, leaves, per_leaf)
    r, v = runs[label], runs[twin]
    got, want = collective_contract(argv, r)
    same = params_equal(r, v)
    print(f"main path {label}: mesh {r['mesh']}, collectives {got} (contract {want}); "
          f"{r['ms_per_local_step']:.3f} ms per local step beside {twin}'s "
          f"{v['ms_per_local_step']:.3f}; test AUC {r['auc']:.4f} beside {v['auc']:.4f} "
          f"(limit 0.01); final parameters bitwise {twin}'s: {same}"
          + (" (held)" if bitwise else " (not held)"))
    if got != want:
        raise SystemExit(f"main path {label}: collectives {got}, the contract gives {want}")
    if not abs(r["auc"] - v["auc"]) <= 0.01:
        raise SystemExit(f"main path {label}: test AUC {r['auc']:.4f} against {twin}'s "
                         f"{v['auc']:.4f}")
    if bitwise and not same:
        raise SystemExit(f"main path {label}: final parameters differ from {twin}'s")
    return {"mesh": r["mesh"], "collectives": got, "ms_per_local_step":
            r["ms_per_local_step"], "vmap_ms_per_local_step": v["ms_per_local_step"],
            "auc": r["auc"], "vmap_auc": v["auc"], "params_equal_vmap": same}


def run_sharded_paths(runs: dict, counts: dict) -> dict:
    """The launcher paths with ``--executor shard_map`` (NCCL, one rank a
    card), each beside the --executor vmap path with the same flags (run
    here when no earlier phase ran it): every counter set to 0 just before
    and read just after (``run_sharded``), ms per local step beside the
    twin's."""
    for label, args in SHARD_VMAP_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", args, MLP_LEAVES)
    return {label: run_sharded(runs, counts, label, argv, twin, per_leaf, bitwise)
            for label, argv, twin, per_leaf, bitwise in SHARDED_PATHS}


def run_resnet50_determinism(runs: dict, counts: dict) -> dict:
    """Why the sharded and vmap ResNet50 fits end apart: the vmap fit run
    again with the same flags (bitwise the first or not: cuDNN's default
    algorithms may add in a different order from call to call), then both
    fits again under ``torch.backends.cudnn.deterministic``, which must end
    bitwise equal."""
    runs["resnet50_repeat"], counts["resnet50_repeat"] = run_main_path(
        "main path resnet50_repeat", RN_ARGS, RN_LEAVES)
    repeat = params_equal(runs["resnet50_repeat"], runs["resnet50"])
    print(f"main path resnet50_repeat: the vmap fit again, final parameters bitwise the "
          f"first's: {repeat}")
    torch.backends.cudnn.deterministic = True
    try:
        runs["resnet50_det"], counts["resnet50_det"] = run_main_path(
            "main path resnet50_det", RN_ARGS, RN_LEAVES)
        out = run_sharded(runs, counts, *RN_SHARD_DET, "resnet50_det", "prox_update", True)
        out["overlap"] = run_resnet50_overlap(runs, counts)
    finally:
        torch.backends.cudnn.deterministic = False
    out["vmap_repeat_bitwise"] = repeat
    for label in ("resnet50_repeat", "resnet50_det", "resnet50_shard_map_det", RN_OVERLAP[0]):
        runs[label].pop("state")
    return out


def run_resnet50_overlap(runs: dict, counts: dict) -> dict:
    """The overlapped pair at full width, under deterministic cuDNN: the
    launcher path (``RN_OVERLAP``) with the launch counts of phase 5 and the
    collectives of the contract, its ms per local step beside the
    non-overlapped sharded path's (its test AUC printed, not held: a pair
    draws its two windows in one call, as the reference's ``fit`` does, so
    its data are not the other path's); then, from the sharded path's final
    state, one pair against the same two windows one after the other
    (bitwise) and a profiled pair (``profile_overlap_pair``)."""
    label, argv = RN_OVERLAP
    det = runs[RN_SHARD_DET[0]]
    runs[label], counts[label] = run_main_path(f"main path {label}", argv, RN_LEAVES)
    ov = runs[label]
    got, want = collective_contract(argv, ov)
    print(f"main path {label}: mesh {ov['mesh']}, collectives {got} (contract {want}); "
          f"{ov['ms_per_local_step']:.3f} ms per local step (steady median) against the "
          f"non-overlapped sharded path's {det['ms_per_local_step']:.3f}; test AUC "
          f"{ov['auc']:.4f} beside its {det['auc']:.4f} (not held: other draws)")
    if got != want:
        raise SystemExit(f"main path {label}: collectives {got}, the contract gives {want}")
    for name, r in ((RN_SHARD_DET[0], det), (label, ov)):
        a = r["allocator"]
        print(f"main path {name}: allocator: {a['alloc_retries']} cudaMalloc retries, reserved "
              f"{a['reserved_before'] / 2**30:.3f} GiB before, {a['reserved_after'] / 2**30:.3f} "
              f"after, peak {a['reserved_peak'] / 2**30:.3f}; allocated peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB")
    return {"mesh": ov["mesh"], "collectives": got,
            "allocator": {RN_SHARD_DET[0]: det["allocator"], label: ov["allocator"]},
            "ms_per_local_step": ov["ms_per_local_step"],
            "sharded_ms_per_local_step": det["ms_per_local_step"], "auc": ov["auc"],
            "pair": profile_overlap_pair(label, det["state"], det["ms_per_local_step"])}


def stream_spans(fn, mark: str) -> tuple[float, dict, set]:
    """Run ``fn`` once under torch.profiler: (host wall ms, {CUDA stream id:
    [(start ns, end ns), ...] of its kernels}, the ids of the streams whose
    kernels ran inside the profiler range ``mark``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans: dict = {}
    marked = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if e.is_user_annotation():
            if e.name() == mark:
                marked.add(e.device_resource_id())
        else:
            spans.setdefault(e.device_resource_id(), []).append((e.start_ns(), e.end_ns()))
    return wall, spans, marked


def _union(spans) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered_ns(spans, cover) -> int:
    """How much of ``spans`` lies inside ``cover`` (both sorted unions)."""
    total, j = 0, 0
    for a, b in spans:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total += min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total


PAIR_I = 4           # the profiled pair: window_batch's 8 steps as two windows of 4


def profile_overlap_pair(label: str, state, det_ms: float) -> dict:
    """ResNet50 at full width on a one-rank NCCL group, from ``state``: one
    overlapped window pair, which must end bitwise the same two windows
    run one after the other (``_one_window`` twice; the caller holds cuDNN
    deterministic); then a pair under torch.profiler: the kernel time of
    the side stream the first averaging runs on
    (``bucketing.PendingAverage``: the per-row means, the division and the
    broadcasts into the averaged leaves), how much of it lies under
    compute-stream kernels (the second window's first local step), and the
    pair's ms per local step beside the sequential windows', timed alike.
    The side stream must have run kernels."""
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, coda
    from repro_torch.launch import mesh as mesh_mod
    mcfg = get_config("resnet50")
    dev = torch.device("cuda:0")
    wb = window_batch(mcfg, dev)
    wb2 = {k: v.reshape((2, PAIR_I) + v.shape[1:]) for k, v in wb.items()}

    def body(rank):
        ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, overlap_chunks=4)
        exe = coda.make_executor(mcfg, ccfg, "shard_map", mesh=mesh_mod.make_worker_mesh())
        st = exe.place(state)
        ring = exe._ring_spec()

        # each run consumes a copy of st, made before it starts
        def pair(s):
            return exe.window_pair_step(s, wb2, 0.5)

        def sequential(s):
            for i in range(2):
                s, _ = exe._one_window(s, {k: v[i] for k, v in wb2.items()}, 0.5,
                                       communicate=True, ring=ring, fl=None)
            return s

        cudnn = torch.backends.cudnn.deterministic

        a, la = pair(copied(st))
        b = sequential(copied(st))
        diff = compare_states(a, b)
        del a, b
        bucketing.zero_collectives()
        s = copied(st)
        wall, spans, side_ids = stream_spans(lambda: pair(s), bucketing.SIDE_STREAM_RANGE)
        del s
        log = list(bucketing.overlap_log)
        # the side stream: where the kernels enqueued inside PendingAverage's
        # profiler range ran; every other stream (cuDNN's among them) computes
        compute = _union([x for k, v in spans.items() if k not in side_ids for x in v])
        side = _union([x for k, v in spans.items() if k in side_ids for x in v])
        side_ns = sum(b - a for a, b in side)
        under = _covered_ns(side, compute)
        walls = {}
        for name, fn in (("pair", pair), ("sequential", sequential),
                         ("sequential", sequential), ("pair", pair)):
            s = copied(st)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(s)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return {"bitwise_sequential": not diff, "differs": {k: v for k, v in
                                                             list(diff.items())[:4]},
                "deterministic_cudnn": cudnn, "side_stream_ms": side_ns / 1e6, "under_compute_ms": under / 1e6,
                "under_compute_share": under / side_ns if side_ns else 0.0,
                "side_kernels": sum(len(v) for k, v in spans.items() if k in side_ids),
                "side_streams": len(side_ids), "streams": len(spans),
                "profiled_wall_ms": wall,
                "pair_ms_per_local_step": [w / (2 * PAIR_I) for w in walls["pair"]],
                "sequential_ms_per_local_step": [w / (2 * PAIR_I)
                                                 for w in walls["sequential"]],
                "waits": sum(1 for e in log if e[0] == "wait"),
                "waits_in_window_2": sum(1 for e in log if e[0] == "wait"
                                         and e[2] > next(t for ev, _, t in log if ev == "step")),
                "summary": dict(exe.overlap_summary)}

    out = mesh_mod.run_ranks(body, 1, backend="nccl")
    print(f"main path {label}: one pair from the sharded path's final state, bitwise the same "
          f"two windows one after the other: {out['bitwise_sequential']} (deterministic cuDNN "
          f"{out['deterministic_cudnn']})" + ("" if out["bitwise_sequential"] else
                                               f"; differing leaves {out['differs']}"))
    print(f"profile {label} pair (two windows of {PAIR_I} local steps, one NCCL rank): side "
          f"stream {out['side_stream_ms']:.4f} ms of kernel time in {out['side_kernels']} "
          f"kernels, {out['under_compute_ms']:.4f} ms of it ({out['under_compute_share']:.3f})"
          f" under compute-stream kernels; {out['side_streams']} side and "
          f"{out['streams'] - out['side_streams']} compute streams; ms per local step: "
          f"pair {[round(x, 3) for x in out['pair_ms_per_local_step']]}, the same windows "
          f"one after the other {[round(x, 3) for x in out['sequential_ms_per_local_step']]}"
          f" (launcher medians: overlapped path beside the non-overlapped sharded path's "
          f"{det_ms:.3f}, deterministic cuDNN); {out['waits']} unit waits, "
          f"{out['waits_in_window_2']} after the second window began; "
          f"summary {out['summary']}")
    print(json.dumps({"profile": {"path": label + "_pair", **out}}))
    if not out["bitwise_sequential"]:
        raise SystemExit(f"{label}: the overlapped pair is not the sequential windows bitwise")
    if not out["side_kernels"] or out["side_streams"] != 1:
        raise SystemExit(f"{label}: {out['side_kernels']} kernels on {out['side_streams']} "
                         "streams for the overlapped averaging, expected one side stream")
    return out


SHAMPOO_STEP_ATOL = 1e-5         # params after one step, kernels vs plain versions


def check_shampoo_step(label: str, state, dev) -> dict:
    """One ResNet50 local step of blocked Shampoo from the path's final
    state (the path's K), with the kernels and with the plain versions: the new
    parameters within SHAMPOO_STEP_ATOL (K2 is bitwise; the rest is the same
    tensor code on the same inputs); then timed with CUDA events as a
    refresh step (``precond_every = 1``) and as a step that keeps its
    preconditioners (``precond_every = 2`` at an odd step count): their
    difference is the ms of one refresh (the inverse roots of every block)."""
    from repro_torch.configs import get_config
    from repro_torch.core import coda, optimizer
    from repro_torch.tree import tree_leaves
    mcfg = get_config("resnet50")
    K = tree_leaves(state["params"])[0].shape[0]
    batch = {k: v[0, :K] for k, v in window_batch(mcfg, dev).items()}
    got = {}
    for impl in ("kernel", "ref"):
        ccfg = coda.CoDAConfig(n_workers=K, p_pos=0.71, impl=impl, optimizer="shampoo_blocked")
        new, _ = coda.local_step(mcfg, ccfg, state, batch, 0.5)
        got[impl] = tree_leaves(new["params"])
        del new
    err = max(float((a - b).abs().max()) for a, b in zip(got["kernel"], got["ref"], strict=True))
    del got
    t = state["opt"]["t"]
    odd = dict(state, opt=dict(state["opt"], t=t + (1 - optimizer.host_count(t) % 2)))
    optimizer.read_host_count(odd["opt"])
    ms = {}
    for name, every, st in (("refresh", 1, state), ("keep", 2, odd), ("refresh", 1, state),
                            ("keep", 2, odd)):
        ccfg = coda.CoDAConfig(n_workers=K, p_pos=0.71, optimizer="shampoo_blocked",
                               precond_every=every)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        new, _ = coda.local_step(mcfg, ccfg, st, batch, 0.5)
        end.record()
        torch.cuda.synchronize()
        del new
        ms.setdefault(name, []).append(start.elapsed_time(end))
    refresh = min(ms["refresh"]) - min(ms["keep"])
    print(f"main path {label}: one local step, kernels vs plain versions: params "
          f"max_abs_err {err:.3g} (atol {SHAMPOO_STEP_ATOL}); a refresh step "
          f"{[round(x, 2) for x in ms['refresh']]} ms, a step that keeps its "
          f"preconditioners {[round(x, 2) for x in ms['keep']]} ms: {refresh:.2f} ms a "
          f"refresh (CUDA events, K = {K})")
    if not err <= SHAMPOO_STEP_ATOL:
        raise SystemExit(f"{label}: the Shampoo step with kernels disagrees with the plain "
                         "versions")
    return {"params_max_abs_err": err, "step_ms": ms, "ms_per_refresh": refresh}


def compare_states(a: dict, b: dict) -> dict:
    """Each leaf where two states differ: (max |a − b|, that over max |b|);
    empty when they are bitwise equal."""
    from repro_torch.tree import tree_leaves, tree_paths
    diff = {}
    for p, x, y in zip(tree_paths(a), tree_leaves(a), tree_leaves(b), strict=True):
        if not torch.equal(x, y):
            d = float((x.float() - y.float()).abs().max())
            diff[p] = (d, d / max(float(y.float().abs().max()), 1e-30))
    return diff


# a sharded window's state against the batched executor's from the same state:
# bitwise expected at R = 1; where not, each leaf within this relative tolerance
SHARD_WINDOW_RTOL = 1e-6


def sharded_window(label: str, mcfg, state, wb, dev, *, profile: bool = False, **ccfg_kw):
    """One window from ``state`` through the sharded executor on a one-rank
    NCCL group and through the batched executor, twice (so a difference
    between the two executors can be told from run-to-run noise): bitwise,
    or where the arithmetic differs and by how much (held to
    SHARD_WINDOW_RTOL of each leaf's largest value); the window's
    collectives; with ``profile``, one profiled window of each executor:
    wall and device busy time, idle share, the NCCL kernels' device time,
    and the kernels the sharded window runs that the batched one does not
    (what the wire adds)."""
    from repro_torch.core import bucketing, coda
    from repro_torch.launch import mesh as mesh_mod

    def body(rank):
        ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, **ccfg_kw)
        exe = coda.make_executor(mcfg, ccfg, "shard_map", mesh=mesh_mod.make_worker_mesh())
        batched = coda.make_executor(mcfg, ccfg)
        bucketing.zero_collectives()
        a, _ = exe.window_step(exe.place(copied(state)), wb, 0.5)
        torch.cuda.synchronize()
        comms = {k: dict(v) for k, v in bucketing.collectives.items()}
        b, _ = batched.window_step(copied(state), wb, 0.5)
        diff = compare_states(a, b)
        del a
        b2, _ = batched.window_step(copied(state), wb, 0.5)
        repeat = not compare_states(b2, b)
        del b, b2
        res = {"bitwise": not diff, "differs": diff, "collectives": comms,
               "batched_repeat_bitwise": repeat,
               "worst_rel": max((rel for _, rel in diff.values()), default=0.0)}
        if profile:
            prof = {}
            for name, ex in (("sharded", exe), ("batched", batched)):
                ex.window_step(copied(state), wb, 0.5)          # warm-up
                st = copied(state)
                wall, busy, per = device_profile(lambda ex=ex: ex.window_step(st, wb, 0.5))
                del st
                prof[name] = {"wall_ms": wall, "device_busy_ms": busy,
                              "idle_share": 1.0 - busy / wall, "kernels": per}
            sh, bt = prof["sharded"], prof["batched"]
            res["profile"] = {
                **{k: sh[k] for k in ("wall_ms", "device_busy_ms", "idle_share")},
                "batched": {k: bt[k] for k in ("wall_ms", "device_busy_ms", "idle_share")},
                "nccl_ms": sum(v for k, v in sh["kernels"].items() if "nccl" in k.lower()),
                "sharded_only_ms": {k[:80]: v for k, v in sh["kernels"].items()
                                    if k not in bt["kernels"]}}
        return res

    out = mesh_mod.run_ranks(body, 1, backend="nccl")
    print(f"main path {label}: one window through the sharded executor (NCCL, one rank) "
          f"against the batched executor from the same state: bitwise {out['bitwise']}"
          + ("" if out["bitwise"] else f"; differing leaves {out['differs']} (largest "
             f"relative {out['worst_rel']:.3g}, limit {SHARD_WINDOW_RTOL})")
          + f"; the batched window twice bitwise: {out['batched_repeat_bitwise']}"
          + f"; collectives {out['collectives']}")
    if "profile" in out:
        pr = out["profile"]
        print(f"profile {label} sharded window: wall {pr['wall_ms']:.3f} ms, device busy "
              f"{pr['device_busy_ms']:.3f} ms (idle share {pr['idle_share']:.3f}); batched "
              f"window wall {pr['batched']['wall_ms']:.3f} ms, busy "
              f"{pr['batched']['device_busy_ms']:.3f} ms; NCCL kernels {pr['nccl_ms']:.4f} ms; "
              f"kernels only in the sharded window (ms) {pr['sharded_only_ms']}")
        print(json.dumps({"profile": {"path": label + "_sharded", **pr}}))
    if not out["bitwise"] and not out["worst_rel"] <= SHARD_WINDOW_RTOL:
        raise SystemExit(f"{label}: the sharded window is not the batched executor's")
    return out


def run_bf16_sharded(dev) -> tuple[dict, dict]:
    """``bf16_stablelm_shard_map``: the bf16 CoDA path (full width, 2
    layers) through ``coda.fit`` on the sharded executor, NCCL at one rank:
    one window against the batched executor from the same state (bitwise,
    or the stated tolerance), then the fit with every counter set to 0 just
    before and read just after: auc_loss once a local step, prox_update
    once a local step, flash_attention once a layer a forward, every
    K4 launch flash_fwd_pingpong; two all_reduces a window (the bf16 and the
    f32 bucket) of ``window_payload_by_dtype`` bytes and one a stage end;
    then the same fit on the batched executor, for its ms per local step
    and peak memory beside them.  The fits run one stage of BF16_SHARD_T0
    local steps (the median over every window after the first), and each
    draws from its own dataset made from the same seed, so both see the
    same windows."""
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, coda, schedules
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    label, c = "bf16_stablelm_shard_map", dict(BF16_CODA, T0=BF16_SHARD_T0)
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    print(f"main path {label}: reduced: {TRAIN_LAYERS} of 24 layers (full width), K={c['K']}, "
          f"B={c['B']}, S=64, one stage of {c['T0']} local steps; param_dtype bfloat16, "
          "through coda.fit on the sharded executor (NCCL, one rank)")
    torch.cuda.empty_cache()

    def dataset():
        return ShardedDataset(train.data_config_for(cfg, 0.71), c["n_data"], c["K"], seed=0,
                              target_p=0.71, device=dev)

    ds = dataset()
    ccfg = coda.CoDAConfig(n_workers=c["K"], p_pos=ds.p_pos, param_dtype=BF16)

    def fresh():
        return coda.init_state(cfg, ccfg, generator=torch.Generator().manual_seed(0),
                               device=dev)

    state = fresh()
    by_dtype = coda.window_payload_by_dtype(state)
    check = sharded_window(label, cfg, state, ds.sample_window(c["I"], c["B"]), dev,
                           param_dtype=BF16)
    k2_step = step_launches("prox_update", state)
    del state                      # each fit below consumes a fresh one
    torch.cuda.empty_cache()
    sched = schedules.ScheduleConfig(n_workers=c["K"], eta0=0.5, T0=c["T0"], I0=c["I"],
                                     p_pos=ds.p_pos)

    def body(rank):
        exe = coda.make_executor(cfg, ccfg, "shard_map", mesh=mesh_mod.make_worker_mesh())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = coda.fit(fresh(), cfg, ccfg, sched, 1,
                       sample_window=lambda i: ds.sample_window(i, c["B"]),
                       sample_alpha_batch=ds.sample_alpha_batch, executor=exe)
        torch.cuda.synchronize()
        return (res, read_counts(), read_variants(),
                {k: dict(v) for k, v in bucketing.collectives.items()})

    ds = dataset()
    res, counts, variants, comms = mesh_mod.run_ranks(body, 1, backend="nccl")
    peak = torch.cuda.max_memory_allocated()
    del res.state
    torch.cuda.empty_cache()
    # the same fit on the batched executor, for its peak and ms beside these
    torch.cuda.reset_peak_memory_stats()
    ds = dataset()
    twin = coda.fit(fresh(), cfg, ccfg, sched, 1,
                    sample_window=lambda i: ds.sample_window(i, c["B"]),
                    sample_alpha_batch=ds.sample_alpha_batch)
    torch.cuda.synchronize()
    twin_peak = torch.cuda.max_memory_allocated()
    twin_ms = 1e3 * statistics.median(twin.step_seconds[1:])
    twin_losses = [h[2] for h in twin.history]
    del twin
    steps, windows = res.iterations, res.comm_rounds - 1
    want = dict.fromkeys(counts, 0) | {
        "auc_loss": steps, "prox_update": steps * k2_step,
        "flash_attention": TRAIN_LAYERS * (steps + 1)}
    want_ar = {"calls": windows * len(by_dtype) + 1,
               "bytes": windows * sum(by_dtype.values()) + 4}
    k4 = variants["flash_attention"]
    ms = 1e3 * statistics.median(res.step_seconds[1:])
    losses = [h[2] for h in res.history]
    print(f"main path {label}: {steps} local steps, {windows} windows, buckets {by_dtype} B a "
          f"worker, collectives {comms}, launches {counts}, K4 variants {k4}; {ms:.3f} ms per "
          f"local step (median of {windows - 1} steady windows; the batched executor's fit "
          f"{twin_ms:.3f}), peak memory {peak / 2**30:.3f} GiB (batched "
          f"{twin_peak / 2**30:.3f}), window losses {[round(x, 5) for x in losses]}, "
          f"bitwise the batched fit's: {losses == twin_losses}")
    if counts != want:
        raise SystemExit(f"{label}: launch counts {counts} ({variants}), expected {want}")
    require_k4_variant(label, {"variant_launches": variants}, "flash_fwd_pingpong",
                       "bf16, head_dim 64")
    if set(by_dtype) != {"bf16", "f32"} or comms["all_reduce"] != want_ar \
            or comms["all_gather"]["calls"] or comms["p2p"]["calls"]:
        raise SystemExit(f"{label}: collectives {comms}, expected all_reduce {want_ar} over "
                         "the bf16 and f32 buckets and nothing else")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: a non-finite loss")
    return ({"window_check": check, "collectives": comms, "payload_by_dtype": by_dtype,
             "ms_per_local_step": ms, "peak_bytes": peak, "losses": losses,
             "batched_ms_per_local_step": twin_ms, "batched_peak_bytes": twin_peak,
             "losses_equal_batched": losses == twin_losses,
             "variant_launches": variants}, counts)


def run_quickstart() -> tuple[dict, dict]:
    """``python -m repro_torch.quickstart`` on the card (its own AUC > 0.85
    assert), every counter set to 0 just before: auc_loss once a local
    step, prox_update once a local step, nothing else."""
    from repro_torch import quickstart
    zero_counts()
    out = quickstart.main([])
    counts = read_counts()
    out["variant_launches"] = read_variants()
    steps = out["iterations"]
    want = dict.fromkeys(counts, 0) | {
        "auc_loss": steps, "prox_update": steps * step_launches("prox_update", out["state"])}
    print(f"main path quickstart: {steps} local steps, {out['comm_rounds']} comm rounds, "
          f"test AUC {out['auc']:.4f}, launches {counts}")
    if counts != want:
        raise SystemExit(f"quickstart: launch counts {counts}, expected {want}")
    return out, counts


# one local step of a full-width path with the kernels and with impl='ref'
# from the same state: the per-worker losses within atol 1e-5, and every
# gradient leaf within 1e-4 of its largest magnitude (fp32: K4's split-TF32
# products are within 3·2^-22 of fp32's, and the sums run in another order)
STEP_LOSS_ATOL, STEP_GRAD_RTOL = 1e-5, 1e-4


def check_local_step(label: str, mcfg, state, dev) -> dict:
    """One local step's losses and gradients with the kernels (K1, and K4 in
    every attention layer) against impl='ref', from the path's final state,
    on a seeded window of the launcher's shapes (K=4, B=32, 64 tokens before
    the modality stubs)."""
    from repro_torch.core import coda
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    g = torch.Generator().manual_seed(4)
    K, B = 4, 32
    batch = train.make_batch_adapters(mcfg, 0, dev)(
        {"tokens": torch.randint(0, mcfg.vocab_size, (K, B, 64), generator=g).to(dev)})
    batch["labels"] = (torch.rand((K, B), generator=g) < 0.71).float().to(dev)
    got = {}
    for impl in ("auto", "ref"):
        ccfg = coda.CoDAConfig(n_workers=K, p_pos=0.71, impl=impl)
        loss, (gp, _), _ = coda.grad_step_scores(mcfg, ccfg, state, batch)
        got[impl] = (loss, tree_leaves(gp))
        del gp
    loss_err = float((got["auto"][0] - got["ref"][0]).abs().max())
    worst = 0.0
    for a, b in zip(got["auto"][1], got["ref"][1], strict=True):
        scale = float(b.abs().max())
        if scale:
            worst = max(worst, float((a - b).abs().max()) / scale)
        elif a.any():
            worst = math.inf
    print(f"main path {label}: one local step, kernels vs impl='ref': losses max_abs_err "
          f"{loss_err:.3g} (atol {STEP_LOSS_ATOL}), gradients max |Δ| / max |g| over "
          f"{len(got['ref'][1])} leaves {worst:.3g} (limit {STEP_GRAD_RTOL})")
    if not (loss_err <= STEP_LOSS_ATOL and worst <= STEP_GRAD_RTOL):
        raise SystemExit(f"{label}: the local step with kernels disagrees with impl='ref'")
    return {"loss_max_abs_err": loss_err, "grad_max_rel_err": worst}


def run_zoo_train(label: str, argv: list, leaves: int, n_attn: int, dev, *,
                  step_check: bool, k4: str | None = "flash_fwd_tf32x3") -> tuple[dict, dict]:
    """A vlm, hybrid, audio or ssm path through ``train.main``
    (run_main_path: exact K1, K2 and K4 launches, every K4 launch ``k4``;
    the ssm family has no attention) and, at full width, one local step held
    to impl='ref'."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model as M
    out, counts = run_main_path(f"main path {label}", argv, leaves, attn_layers=n_attn)
    if k4 is not None:
        require_k4_variant(label, out, k4, "fp32")
    arch = argv[argv.index("--arch") + 1]
    mcfg = get_smoke_config(arch) if "--smoke" in argv else get_config(arch)
    if "--n-layers" in argv:
        n = int(argv[argv.index("--n-layers") + 1])
        mcfg = dataclasses.replace(mcfg, n_layers=n, **(
            {"encoder_layers": n} if mcfg.is_encoder_decoder else {}))
    want = (M.count_params(mcfg) + 3) * 4             # the parameters and the 3 fp32 duals
    if out["bytes_per_round"] != want:
        raise SystemExit(f"{label}: bytes/round/worker {out['bytes_per_round']:,}, "
                         f"count_params gives {want:,}")
    if step_check:
        out["local_step"] = check_local_step(label, mcfg, out["state"], dev)
    out.pop("state")
    torch.cuda.empty_cache()
    return out, counts


SEAMLESS_DECODE_STEPS = 64
DECODE_TOL = 2e-3          # atol = rtol, tests/test_decode_consistency.py's


def run_seamless_decode(cfg, params, dev) -> dict:
    """seamless-m4t-medium served as the reference serves it:
    ``encode_for_decode`` over the prefill's frames [4, 2048, 1024] (K4
    once an encoder layer, nothing else), then SEAMLESS_DECODE_STEPS
    ``serve_step``s (no kernel: decode and cross attention are plain), the
    last logits within DECODE_TOL of the parallel forward on the same 64
    tokens; ms for the encoding and per serve step."""
    from repro_torch.models import model as M
    from repro_torch.serving import decode as D
    batch = prefill_batch(cfg, 4, 2048, dev)
    frames, tokens = batch["frames"][0], batch["tokens"][0, :, :SEAMLESS_DECODE_STEPS]
    B, T = tokens.shape
    with torch.no_grad():
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cache = D.init_cache(cfg, B, frames.shape[1], use_window=False, dtype=torch.float32,
                             device=dev)
        cache = D.encode_for_decode(cfg, params, cache, frames)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        enc_counts = read_counts()
        steps = []
        for t in range(T):
            t0 = time.perf_counter()
            logits, _, cache = D.serve_step(cfg, params, cache, tokens[:, t:t + 1],
                                            torch.full((B,), t, dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
        counts, variants = read_counts(), read_variants()
        h, _ = M.backbone(cfg, params, {"frames": frames[None], "tokens": tokens[None]})
        want = M.lm_logits(cfg, params, h[:, :, -1])[0]
    err = float((logits - want).abs().max())
    ok = bool(((logits - want).abs() <= DECODE_TOL + DECODE_TOL * want.abs()).all())
    expect = dict.fromkeys(counts, 0) | {"flash_attention": cfg.encoder_layers}
    print(f"seamless_decode: encode_for_decode over frames {list(frames.shape)} in "
          f"{enc_ms:.2f} ms, then {T} serve_steps at {statistics.median(steps):.2f} ms each "
          f"(median); launches {counts} (after the encoding {enc_counts}); the last logits "
          f"[{B}, {cfg.vocab_size}] vs the parallel forward on the {T} tokens: max_abs_err "
          f"{err:.3g} (atol = rtol = {DECODE_TOL})")
    if counts != expect or enc_counts != expect:
        raise SystemExit(f"seamless_decode: launch counts {counts}, expected {expect}")
    if not (ok and bool(torch.isfinite(logits).all())):
        raise SystemExit("seamless_decode: incremental logits disagree with the parallel "
                         "forward")
    return {"path": "seamless_decode", "encode_ms": enc_ms,
            "ms_per_serve_step": statistics.median(steps), "steps": T,
            "logits_max_abs_err": err, "launches": counts, "variant_launches": variants}


def run_zoo(dev, rates, k5_checked: set, runs: dict, counts: dict, prefills: dict) -> dict:
    """The vlm, hybrid and audio families on the card: the full-width
    prefills (internvl2-2b and hymba-1.5b in fp32 and bf16, seamless
    fp32), hymba's weights through the engine, seamless's
    encode-then-decode against its parallel forward, and the three CoDA
    paths at full width through the launcher.  Returns the summary printed
    as the ``{"zoo": ...}`` line."""
    zoo = {}
    for path in ZOO_PREFILLS:
        prefills[path.label], cfg, params = run_prefill(dev, path, k5_checked)
        counts[path.label] = prefills[path.label]["launches"]
        zoo[path.label] = {k: prefills[path.label][k] for k in (
            "ms_per_prefill", "ref_ms_per_prefill", "tokens_per_s", "peak_bytes", "launches",
            "variant_launches", "errs", "ssm", "profile")}
        if path is HYMBA_PREFILL:
            serve = run_engine_serve(rates, cfg, params, k5_checked, "hymba_serve")
            counts["hymba_serve"] = serve["launches"]
            zoo["hymba_serve"] = serve
        if path is SEAMLESS_PREFILL:
            zoo["seamless_decode"] = run_seamless_decode(cfg, params, dev)
            counts["seamless_decode"] = zoo["seamless_decode"]["launches"]
        del params
        torch.cuda.empty_cache()
    for label, args, leaves, n_attn in ZOO_TRAIN:
        runs[label], counts[label] = run_zoo_train(label, args, leaves, n_attn, dev,
                                                   step_check=True)
        zoo[label] = {k: runs[label][k] for k in (
            "ms_per_local_step", "peak_bytes", "launches", "auc", "bytes_per_round",
            "local_step")}
    return zoo


# --------------------------------------------------------------------------
# phase 16: the ssm family (xlstm-350m: mLSTM and sLSTM layers, no attention)
# --------------------------------------------------------------------------
XLSTM = "xlstm-350m"
XLSTM_PARAMS = 342_334_633
XLSTM_PREFILL_REDUCED = (
    PREFILL_32K + ", one replica (K=1); full width and depth (24 layers: d=1024, 4 heads; "
    "mLSTM d_inner 2048 in heads of 512, chunk 256; sLSTM at layers 7, 15 and 23; vocab "
    "50,304, untied LM head)")
XLSTM_B, XLSTM_S = 4, 2048
XLSTM_DECODE = (2, 256)            # the decode-vs-parallel prompt [B, S]
# the depth the decode check is held at: fp32 rounding alone grows through
# random xLSTM layers (two parallel forms of the 24-layer model, chunk 64
# and 256, differ far past the check's 2e-3), so it is held, as the
# reference holds it, on a short stack, here at full width with each kind
XLSTM_DECODE_CUT = {"n_layers": 3, "slstm_every": 2}
MLSTM_CHUNK_TOL = (2e-4, 2e-3)     # (atol, rtol), tests/test_decode_consistency.py:102-110
# CoDA at full width through the launcher: (label, arguments, the kernel
# of the optimizer step, one launch a step).  sgd at the launcher's eta0 = 0.5 drives
# full-width xLSTM to NaN within a few steps in both packages (the first
# mLSTM's input-gate pre-activations grow until a row's exp(-m) overflows;
# scripts/xlstm_stability.py shows it on the CPU); at 24 layers the random
# model's backward is so steep that one step at any eta0 tried overflows the
# next step's gradients (``xlstm_depth_probe`` prints it).  So the path runs
# 8 layers (one sLSTM, layer 7; well under the card's memory) at eta0 0.002.
XLSTM_TRAIN_LAYERS = 8
XLSTM_ETA0 = 0.002
XLSTM_TRAIN = ("xlstm_train", ["--arch", XLSTM, "--eta0", str(XLSTM_ETA0),
                               "--n-layers", str(XLSTM_TRAIN_LAYERS)] + ZOO_TRAIN_ARGS,
               "prox_update")


def n_leaves(cfg) -> int:
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves
    return len(tree_leaves(M.init_params(cfg, device="meta")))


def xlstm_layer_shares(cfg, params, batch, busy_ms: float, wall_ms: float) -> dict:
    """The mLSTM's and the sLSTM's shares of a prefill's device time: one
    layer of each kind under torch.profiler on the prefill's input shape
    (its device busy time, and the host wall of the sLSTM's step loop),
    times the layers of that kind, over the prefill's busy time (and, for
    the sLSTM's host loop, over the prefill's wall)."""
    from repro_torch.models import blocks
    from repro_torch.models import xlstm as X
    from repro_torch.models.embeddings import embed
    kinds = blocks.xlstm_layer_kinds(cfg)
    x = embed(params["embed"], batch["tokens"])                 # [1, B, S, d]
    out = {}
    with torch.no_grad():
        for kind, fn in (("mlstm", X.apply_mlstm), ("slstm", X.apply_slstm)):
            lp = params["layers"][kinds.index(kind)]["core"]   # warm from the prefills
            wall, busy, per = device_profile(lambda: fn(cfg, lp, x))
            n = kinds.count(kind)
            out[kind] = {"layers": n, "device_busy_ms_per_layer": busy,
                         "wall_ms_per_layer": wall, "kernels_per_layer": len(per),
                         "device_share": n * busy / busy_ms, "wall_share": n * wall / wall_ms}
    print(f"xlstm layer shares: mLSTM {out['mlstm']['device_busy_ms_per_layer']:.2f} ms "
          f"device a layer × {out['mlstm']['layers']} = "
          f"{100 * out['mlstm']['device_share']:.1f} % of the prefill's device busy time; "
          f"sLSTM {out['slstm']['device_busy_ms_per_layer']:.2f} ms device, "
          f"{out['slstm']['wall_ms_per_layer']:.1f} ms host wall a layer (its {x.shape[2]}-step "
          f"loop) × {out['slstm']['layers']} = {100 * out['slstm']['device_share']:.1f} % of "
          f"the device busy time and {100 * out['slstm']['wall_share']:.1f} % of the "
          "prefill's wall")
    return out


def run_xlstm_prefill(dev, dtype) -> tuple[dict, object, dict]:
    """xlstm-350m's ``prefill_step`` at full width and depth on [B=4,
    S=2048] (one replica): no kernel of ours on this path (every launch
    counter 0), ``kv=None``; ms per prefill, tokens/s, peak memory, a
    profile (busy and idle share) and the mLSTM and sLSTM shares.  bf16:
    the scores and last logits with ``impl="auto"`` and ``"ref"`` under the
    bf16 rule against the same prefill on the weights widened to fp32.
    Returns (the record, cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map
    dname = str(dtype).replace("torch.", "")
    label = "xlstm_prefill" if dtype == torch.float32 else "bf16_xlstm_prefill"
    cfg, B, S = get_config(XLSTM), XLSTM_B, XLSTM_S
    print(f"{label}: reduced: {XLSTM_PREFILL_REDUCED.format(B=B, S=S)}"
          + ("" if dtype == torch.float32 else "; bf16 weights (norms, gate biases fp32)"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=dtype, device=dev)
    n = sum(l.numel() for l in tree_leaves(params))
    if n != XLSTM_PARAMS:
        raise SystemExit(f"{label}: {n:,} parameters, expected {XLSTM_PARAMS:,}")
    params = tree_map(lambda x: x[None], params)               # K = 1 (views)
    batch = prefill_batch(cfg, B, S, dev)
    prefill = lambda impl="auto", p=params: M.prefill_step(cfg, p, batch, impl=impl)
    with torch.no_grad():
        zero_counts()
        s, logits, kv = prefill()                               # also the warm-up
        torch.cuda.synchronize()
        counts = read_counts()
        if any(counts.values()) or kv is not None:
            raise SystemExit(f"{label}: launches {counts}, kv {type(kv)}: expected none")
        times = []
        for _ in range(2):
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        ms = min(times)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(s).all()) and bool(torch.isfinite(logits).all())
        shapes_ok = (tuple(s.shape) == (1, B) and s.dtype == torch.float32
                     and tuple(logits.shape) == (1, B, cfg.vocab_size))
        if not (finite and shapes_ok):
            raise SystemExit(f"{label}: outputs finite {finite}, shapes ok {shapes_ok}")
        noise = None
        if dtype != torch.float32:
            rs, rlogits, _ = prefill("ref")
            fs, flog, _ = prefill("ref", _f32(params))
            noise = bf16_noise_check(label, {"scores": s, "logits": logits},
                                     {"scores": rs, "logits": rlogits},
                                     {"scores": fs, "logits": flog})
            del rs, rlogits, fs, flog
            torch.cuda.empty_cache()
        wall, busy, per = device_profile(prefill)
    shares = xlstm_layer_shares(cfg, params, batch, busy, wall)
    total = sum(per.values())
    top = sorted(per.items(), key=lambda kv_: -kv_[1])[:6]
    prof = {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_sum_ms": total, "distinct_kernels": len(per),
            "mlstm_share": shares["mlstm"]["device_share"],
            "slstm_share": shares["slstm"]["device_share"],
            "slstm_wall_share": shares["slstm"]["wall_share"],
            "top_kernels_ms": {k[:90]: v for k, v in top}}
    out = {"path": label, "dtype": dname, "ms_per_prefill": ms, "ms_runs": times,
           "tokens_per_s": B * S / ms * 1e3, "peak_bytes": peak, "launches": counts,
           "variant_launches": read_variants(), "bf16_rule": noise, "layers": shares,
           "profile": prof}
    print(f"{label}: {ms:.2f} ms per prefill (the faster of {[round(t, 2) for t in times]}), "
          f"{B * S / ms * 1e3:,.0f} tokens/s, peak memory {peak / 2**30:.2f} GiB; launches "
          f"{counts}; profile: wall {wall:.2f} ms, device busy {busy:.2f} ms (idle share "
          f"{1.0 - busy / wall:.3f})")
    print(json.dumps({"profile": prof | {"path": label}}))
    del batch, s, logits
    return out, cfg, params


def _decode_vs_parallel(cfg, params, tokens, chunk: int = 256) -> dict:
    """The last logits of ``tokens`` [B, T] through ``prefill_step`` (mLSTM
    chunk ``chunk``) and through T ``serve_step``s: their max |difference|
    and its largest share of the reference's tolerance (atol = rtol =
    DECODE_TOL), and the ms per serve step."""
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as X
    from repro_torch.serving import decode as D
    B, T = tokens.shape
    with torch.no_grad():
        X.apply_mlstm.__defaults__ = (chunk,)
        try:
            _, want, _ = M.prefill_step(cfg, params, {"tokens": tokens[None]})
        finally:
            X.apply_mlstm.__defaults__ = (256,)
        cache = D.init_cache(cfg, B, T, dtype=torch.float32, device=tokens.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(T):
            logits, _, cache = D.serve_step(cfg, params, cache, tokens[:, t:t + 1],
                                            torch.full((B,), t, dtype=torch.int32,
                                                       device=tokens.device))
        torch.cuda.synchronize()
    d = (logits - want[0]).abs()
    return {"max_abs_err": float(d.max()), "logits": logits, "parallel": want[0],
            "share_of_tol": float((d / (DECODE_TOL + DECODE_TOL * want[0].abs())).max()),
            "ms_per_serve_step": (time.perf_counter() - t0) * 1e3 / T,
            "finite": bool(torch.isfinite(logits).all())}


def check_xlstm_decode(cfg, params, dev) -> dict:
    """Decode against the parallel form at full width (the reference's own
    check, tests/test_decode_consistency.py:41: the last logits of a
    [2, 256] prompt through ``prefill_step`` against ``serve_step`` token by
    token, atol = rtol = DECODE_TOL), held on XLSTM_DECODE_CUT (mLSTM,
    sLSTM, mLSTM: each kind and the sLSTM's fp32 hand-off); at full depth
    the same two numbers are printed beside the spread of two parallel
    forms (mLSTM chunk 64 against 256: the same function summed in another
    order), which measures how far fp32 rounding alone carries 24 random
    layers.  And ``apply_mlstm`` at chunk 256 against chunk 64 on one
    layer's weights, x ~ 0.5·N(0, 1) of the prefill's shape
    (MLSTM_CHUNK_TOL)."""
    from repro_torch.models import model as M
    from repro_torch.models import xlstm as X
    from repro_torch.tree import tree_map
    B, T = XLSTM_DECODE
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device=dev)
    cut_cfg = dataclasses.replace(cfg, **XLSTM_DECODE_CUT)
    cut = tree_map(lambda x: x[None], M.init_params(
        cut_cfg, generator=torch.Generator(device=dev).manual_seed(6), device=dev))
    held = _decode_vs_parallel(cut_cfg, cut, tokens)
    del cut
    full = _decode_vs_parallel(cfg, params, tokens)
    spread = _decode_vs_parallel(cfg, params, tokens, chunk=64)
    spread = float((spread["parallel"] - full["parallel"]).abs().max())
    with torch.no_grad():
        lp = params["layers"][0]["core"]
        x = 0.5 * torch.randn((1, XLSTM_B, XLSTM_S, cfg.d_model), generator=g, device=dev)
        a, b = X.apply_mlstm(cfg, lp, x, chunk=256), X.apply_mlstm(cfg, lp, x, chunk=64)
        atol, rtol = MLSTM_CHUNK_TOL
        chunk_err = float((a - b).abs().max())
        chunk_ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
    print(f"xlstm_decode: reduced: {XLSTM_DECODE_CUT} at full width for the held check; "
          f"the last logits of a [{B}, {T}] prompt, {T} serve_steps vs prefill_step: "
          f"max_abs_err {held['max_abs_err']:.3g}, {held['share_of_tol']:.3g} of the "
          f"tolerance (atol = rtol = {DECODE_TOL}; held); at full depth (24 layers, "
          f"{full['ms_per_serve_step']:.2f} ms a serve_step) {full['max_abs_err']:.3g} "
          f"({full['share_of_tol']:.3g} of it), where two parallel forms (chunk 64 vs "
          f"256) are {spread:.3g} apart (printed, not held); apply_mlstm chunk 256 vs 64 on "
          f"[{XLSTM_B}, {XLSTM_S}, {cfg.d_model}]: max_abs_err {chunk_err:.3g} (atol {atol}, "
          f"rtol {rtol}; held)")
    if not (held["share_of_tol"] <= 1.0 and held["finite"] and full["finite"] and chunk_ok):
        raise SystemExit("xlstm_decode: decode or chunk size disagrees with the parallel form")
    return {"decode_max_abs_err": held["max_abs_err"], "decode_share_of_tol":
            held["share_of_tol"], "full_depth_decode_max_abs_err": full["max_abs_err"],
            "full_depth_parallel_spread": spread,
            "ms_per_serve_step_full_depth": full["ms_per_serve_step"],
            "chunk_max_abs_err": chunk_err}


def xlstm_depth_probe(dev) -> dict:
    """Why the CoDA path is cut: two sgd steps (``coda.grad_step_scores``,
    then ``apply_grads`` at XLSTM_ETA0) of the full 24 layers on K=4 seeded
    [32, 64] token batches: each step's largest gradient and whether every
    gradient leaf is finite.  Printed, not held (the reference's model does
    this, not the port)."""
    from repro_torch.configs import get_config
    from repro_torch.core import coda
    from repro_torch.tree import tree_leaves
    cfg = get_config(XLSTM)
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71)
    st = coda.init_state(cfg, ccfg, generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    g = torch.Generator().manual_seed(4)
    steps = []
    for _ in range(2):
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32, 64), generator=g).to(dev),
                 "labels": (torch.rand((4, 32), generator=g) < 0.71).float().to(dev)}
        loss, grads, _ = coda.grad_step_scores(cfg, ccfg, st, batch)
        leaves = tree_leaves(grads[0])
        steps.append({"loss": float(loss.mean()),
                      "max_abs_grad": max(float(l.abs().max()) for l in leaves),
                      "finite": all(bool(torch.isfinite(l).all()) for l in leaves)})
        st = coda.apply_grads(ccfg, st, grads, XLSTM_ETA0)
        del grads, leaves
    del st
    torch.cuda.empty_cache()
    print(f"xlstm_depth_probe: 24 layers, K=4, B=32, S=64, sgd at eta0 {XLSTM_ETA0}: "
          + "; ".join(f"step {i}: loss {x['loss']:.4f}, max |gradient| {x['max_abs_grad']:.3g}, "
                      f"finite {x['finite']}" for i, x in enumerate(steps)))
    return {"steps": steps}


def run_xlstm(dev, rates, k5_checked: set, runs: dict, counts: dict) -> dict:
    """Phase 16: xlstm-350m's fp32 and bf16 prefills, the decode and
    chunk-size checks, its fp32 weights through the engine, the CoDA path at
    full width through the launcher (exact K1/K2 launches, one local step
    held to impl='ref'), the smoke twins (xlstm with sm3: K3; dbrx with
    shampoo_blocked: K2, K4, K5) and ``serve_load_report``.  Returns the
    ``{"ssm": ...}`` summary."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.serving import loadgen as LG
    ssm = {}
    for dtype in (torch.float32, BF16):
        rec, cfg, params = run_xlstm_prefill(dev, dtype)
        ssm[rec["path"]] = rec
        counts[rec["path"]] = rec["launches"]
        if dtype == torch.float32:
            ssm["xlstm_decode"] = check_xlstm_decode(cfg, params, dev)
            serve = run_engine_serve(rates, cfg, params, k5_checked, "xlstm_serve")
            counts["xlstm_serve"] = serve["launches"]
            ssm["xlstm_serve"] = serve
        del params
        torch.cuda.empty_cache()
    ssm["xlstm_depth_probe"] = xlstm_depth_probe(dev)
    label, args, per_leaf = XLSTM_TRAIN
    tcfg = dataclasses.replace(get_config(XLSTM), n_layers=XLSTM_TRAIN_LAYERS)
    print(f"main path {label}: reduced: full width and {XLSTM_TRAIN_LAYERS} of 24 layers "
          f"(one sLSTM, layer 7), K=4, B=32, S=64, one stage of 16 local steps, sgd at eta0 "
          f"{XLSTM_ETA0}: at 24 layers the second step's gradients overflow (the probe above), "
          "and eta0 0.5 diverges in both packages (scripts/xlstm_stability.py)")
    runs[label], counts[label] = run_zoo_train(label, args, n_leaves(tcfg), 0, dev,
                                               step_check=True, k4=None)
    ssm[label] = {k: runs[label][k] for k in (
        "ms_per_local_step", "peak_bytes", "launches", "auc", "bytes_per_round", "local_step")}
    for label, args, per_leaf in SSM_TWINS:
        moe = "dbrx" in label
        leaves = MOE_LEAVES if moe else n_leaves(get_smoke_config(XLSTM))
        runs[label], counts[label] = run_main_path(
            f"main path {label}", args, leaves, per_leaf, attn_layers=2 if moe else 0,
            moe_layers=2 if moe else 0)
        if moe:
            require_k4_variant(label, runs[label], "flash_fwd_tf32x3", "fp32, head_dim 128")
        runs[label].pop("state")
        ssm[label] = {k: runs[label][k] for k in ("ms_per_local_step", "launches", "auc",
                                                  "opt_state_bytes")}
    torch.cuda.empty_cache()
    rep = LG.serve_load_report(XLSTM, device=dev)
    print(f"serve_load_report({XLSTM!r}): {json.dumps(rep)}")
    if rep["metrics"]["completed"] != rep["metrics"]["n_requests"]:
        raise SystemExit("serve_load_report: not every request was served")
    ssm["serve_load_report"] = rep
    return ssm


T_START = time.perf_counter()


def dryrun_param_check(cfg, params) -> dict:
    """The dry run's parameter bytes a device on a 1 × 1 mesh for ``cfg``
    in bf16 (``launch/dryrun.py``, the meta device) against the bytes of
    the parameters' storage on the card; they must be equal."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.tree import tree_leaves
    rec = DR.param_record(cfg.name, abstract_mesh((1, 1), ("data", "model")),
                          n_layers=cfg.n_layers)
    seen, held = set(), 0
    for t in tree_leaves(params):
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            held += t.untyped_storage().nbytes()
    out = {"predicted_bytes_per_device": rec["param_bytes_per_device"], "card_bytes": held}
    print(f"dry run: {cfg.name} bf16 parameters {rec['param_bytes_per_device']:,} B a device "
          f"on a 1 × 1 mesh (predicted on the meta device); the card holds {held:,} B for them")
    if rec["param_bytes_per_device"] != held:
        raise SystemExit(f"dry run: predicted {rec['param_bytes_per_device']:,} B of "
                         f"parameters, the card holds {held:,} B")
    return out


def _audit_variants(rep) -> dict:
    """{variant: (calls, launched, every record's query equal)} of an audit
    report's launch records."""
    out: dict = {}
    for l in rep.details.get("launches", []):
        c, n, q = out.get(l["variant"], (0, 0, True))
        out[l["variant"]] = (c + l["calls"], n + (l["launched"] or 0), q and bool(l["query_equal"]))
    return out


def run_audit(dev, dbrx_cfg, dbrx_params, param_check: dict, prefill_ms: float) -> dict:
    """Phase 17: the audit matrix on the card, the two full-width legs, the
    dry run's FLOPs of the bf16 stablelm prefill.  A finding fails the run."""
    from repro_torch.analysis import audit as A
    from repro_torch.configs import get_config
    from repro_torch.core import coda
    from repro_torch.launch import audit as LA
    from repro_torch.launch import dryrun as DR
    t0 = time.perf_counter()
    art = LA.run_matrix(dev, n_devices=torch.cuda.device_count(), smoke=True)
    out = {"matrix_ok": art["ok"], "legs": {r["leg"]: r["ok"] for r in art["legs"]},
           "checks": sum(r["n_checked"] for r in art["legs"]),
           "matrix_s": time.perf_counter() - t0}
    if not art["ok"]:
        raise SystemExit("audit: the matrix failed: " + ", ".join(
            r["leg"] for r in art["legs"] if not r["ok"]))
    # R5 at the paths' shapes (analysis.audit.PATH_SHAPES): every kernel
    # variant's record equal to its kernel's own geometry query
    recs = [A.launch_record(k, shape) for k, shape in A.PATH_SHAPES]
    for rec in recs:
        rec.query = A.kernel_query(rec)
    rep = A.run_rules([], recs, check_dispatch=False)
    variants = sorted({r.variant for r in recs})
    print(f"audit R5 at the paths' shapes: {len(recs)} records, each the kernel's own "
          f"geometry query: {rep.ok}; variants {variants}")
    need = {"gmm_rows", "gmm_tiles", "gmm_wgmma", "gmm_tf32x3", "gmm_wgmma_m128",
            "flash_fwd", "flash_fwd_pingpong", "flash_fwd_tf32x3"}
    if not rep.ok or not need <= set(variants):
        raise SystemExit(f"audit R5 at the paths' shapes: {[str(f) for f in rep.findings]}, "
                         f"variants {variants}")
    out["r5_path_shapes"] = {"ok": rep.ok, "records": len(recs), "variants": variants}

    t1 = time.perf_counter()
    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, param_dtype=BF16)
    rep = A.run_rules(A.capture_vmap_programs(cfg, ccfg, I=2, B=32, S=64, device=dev,
                                              tag="full/bf16_stablelm_coda", query=True))
    LA.print_record(dict(rep.to_dict(), leg="full/bf16_stablelm_coda",
                         seconds=round(time.perf_counter() - t1, 3)))
    var = _audit_variants(rep)
    mem = {k.rsplit("/", 2)[-2]: v for k, v in rep.details.items() if k.endswith("/memory")}
    for prog, m in mem.items():
        print(f"audit full/bf16_stablelm_coda/{prog}: {m['allocated_after']:,} B allocated "
              f"after it, the caller's other tensors {m['held_by_caller']:,} B + the new "
              f"state and outputs {m['new_bytes']:,} B (excess {m['excess']:,} B, slack "
              f"{A.R2_SLACK_BYTES:,}); peak {m['peak_above_state']:,} B above the state")
    print(f"audit full/bf16_stablelm_coda: variants (calls, launches, query equal) {var}")
    need = {"auc_loss_kernel", "prox_update_multi_kernel", "flash_fwd_pingpong"}
    if not rep.ok or not need <= set(var) or not all(v[2] and v[0] == v[1] for v in var.values()):
        raise SystemExit(f"audit full/bf16_stablelm_coda: {[str(f) for f in rep.findings]}, "
                         f"variants {var}")
    out["bf16_stablelm_coda"] = {"ok": rep.ok, "checks": len(rep.checked), "variants": var,
                                 "memory": mem, "s": time.perf_counter() - t1}

    t1 = time.perf_counter()
    g = np.random.default_rng(5)
    prompts = [g.integers(0, dbrx_cfg.vocab_size, 12).tolist() for _ in range(5)]
    progs = A.capture_serving_programs(dbrx_cfg, params=dbrx_params, slots=4, max_len=64,
                                       prefill_chunk=8, device=dev, prompts=prompts,
                                       tag="full/bf16_dbrx_engine", query=True)
    rep = A.run_rules(progs)
    LA.print_record(dict(rep.to_dict(), leg="full/bf16_dbrx_engine",
                         seconds=round(time.perf_counter() - t1, 3)))
    var = _audit_variants(rep)
    shapes = sorted(next(p.chunk_shapes for p in progs if p.chunk_shapes is not None))
    print(f"audit full/bf16_dbrx_engine: chunk shapes {shapes}; variants (calls, launches, "
          f"query equal) {var}")
    if not rep.ok or "gmm_wgmma" not in var or not all(v[2] and v[0] == v[1]
                                                        for v in var.values()):
        raise SystemExit(f"audit full/bf16_dbrx_engine: {[str(f) for f in rep.findings]}, "
                         f"variants {var}")
    out["bf16_dbrx_engine"] = {"ok": rep.ok, "checks": len(rep.checked), "variants": var,
                               "chunk_shapes": shapes, "s": time.perf_counter() - t1}

    lm = get_config("stablelm-1.6b")
    flops = DR.prefill_flops(lm, B=4, S=2048)
    share = flops / (prefill_ms * 1e-3) / 989e12
    print(f"dry run: the bf16 stablelm-1.6b prefill [4, 2048] is {flops:.4e} FLOPs (meta "
          f"FlopCounterMode); at this run's {prefill_ms:.2f} ms that is {share:.3f} of 989 "
          "TFLOP/s")
    out["dryrun"] = dict(param_check, prefill_flops=flops, prefill_ms=prefill_ms,
                         share_of_989=share)
    out["phase_s"] = time.perf_counter() - t0
    print(f"audit phase: {out['phase_s']:.1f} s on {nvidia_smi()}")
    return out


def stamp(what: str) -> None:
    """A phase boundary with the seconds since the script started, so a
    log shows where the run's time went."""
    print(f"[t={time.perf_counter() - T_START:.1f} s] {what}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    name = torch.cuda.get_device_name(0)
    rates, bf16_rate = card_rates(name), bf16_peak(name)
    dev = torch.device("cuda:0")
    disable_tf32()

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)        # one nvcc per source, then the link
    print(f"build: {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")

    twins = CpuTwins(TWIN_PATHS).start()
    try:
        return run_phases(dev, rates, bf16_rate, twins)
    finally:
        twins.stop()


def run_phases(dev, rates, bf16_rate, twins) -> int:
    from repro_torch.configs import get_config, mlp_config
    from repro_torch.core import coda
    gen = torch.Generator().manual_seed(0)
    auc_rows = check_auc_loss(dev, rates, gen)
    prox_rows = check_prox_update(dev, rates, gen)
    opt_rows = check_opt_update(dev, rates, gen)
    inplace_rows = check_inplace_updates(dev, rates, gen)
    prox_rows += [r for r in inplace_rows if r["kernel"] == "prox_update"]
    opt_rows += [r for r in inplace_rows if r["kernel"] == "opt_update"]
    attn_rows, attn_bwd = check_flash_attention(dev, rates, bf16_rate, gen)
    no_key = check_no_key_rows(dev, rates, gen)
    gmm_rows = check_grouped_matmul(dev, rates, bf16_rate)
    stamp("kernel checks done")
    k5_checked = {(r["N"], r["Kd"], r["F"], r["dtype"]) for r in gmm_rows}
    check_step(dev)

    runs, counts = {}, {}
    print("main path mlp_shampoo: reduced: one stage of the launcher's three (its CPU twin "
          "takes ~0.3 s a step)")
    for label, args, per_leaf in MLP_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", args,
                                                   MLP_LEAVES, per_leaf)
        if label not in MLP_STATES_READ_LATER:
            runs[label].pop("state")           # free the card for the later paths
    if not runs["mlp"]["auc"] > 0.9:
        raise SystemExit(f"main path mlp: test AUC {runs['mlp']['auc']:.4f} <= 0.9")
    sk = runs["mlp_sketch"]["state"]["sk_acc"]
    n_scored = int(sk["pos"][0].sum() + sk["neg"][0].sum())
    want = runs["mlp_sketch"]["iterations"] * 4 * 32
    print(f"main path mlp_sketch: the merged sketch counts {n_scored:,} scores "
          f"(local steps × K × B = {want:,})")
    if n_scored != want:
        raise SystemExit("main path mlp_sketch: sketch count disagrees")
    stamp("mlp paths done")
    profile_window("mlp", mlp_config(), runs["mlp"]["state"], dev)
    profile_window("mlp_codasca_faults", mlp_config(), runs["mlp_codasca_faults"]["state"], dev,
                   algorithm="codasca", participation=0.75, straggler_prob=0.2,
                   straggler_windows=2, max_staleness=2, fault_seed=3, stream_bins=2048)
    for label in ("mlp_sketch", "mlp_codasca_faults"):
        runs[label].pop("state")
    runs["mlp_crash_resume"], counts["mlp_crash_resume"] = run_crash_resume(dev)
    runs["quickstart"], counts["quickstart"] = run_quickstart()
    runs["quickstart"].pop("state")
    for label, args, per_leaf in RN_PATHS:
        runs[label], counts[label] = run_main_path(f"main path {label}", RN_ARGS + args,
                                                   RN_LEAVES, per_leaf)
    shampoo = check_shampoo_step("resnet50_shampoo", runs["resnet50_shampoo"].pop("state"), dev)
    shampoo.update(peak_bytes=runs["resnet50_shampoo"]["peak_bytes"],
                   ms_per_local_step=runs["resnet50_shampoo"]["ms_per_local_step"],
                   opt_state_bytes=runs["resnet50_shampoo"]["opt_state_bytes"],
                   workers=4)
    print(f"main path resnet50_shampoo: K=4 (the launcher's default), peak memory "
          f"{shampoo['peak_bytes'] / 2**30:.3f} GiB, optimizer state "
          f"{shampoo['opt_state_bytes']:,} B/worker, {shampoo['ms_per_local_step']:.3f} ms per "
          f"local step, {shampoo['ms_per_refresh']:.2f} ms a refresh")
    print(json.dumps({"resnet50_shampoo": shampoo}))
    torch.cuda.empty_cache()
    profile_window("resnet50", get_config("resnet50"), runs["resnet50"]["state"], dev)
    prof = profile_window("resnet50_momentum", get_config("resnet50"),
                          runs["resnet50_momentum"]["state"], dev, optimizer="momentum",
                          opt_dtype=torch.bfloat16)
    label = "resnet50_codasca_masked"
    st = runs[label]["state"]
    masked = coda.window_payload_bytes(st, masked=True)
    print(f"main path {label}: masked window payload {masked:,} B a worker = 2 × the CoDA "
          f"path's model_bytes {coda.model_bytes(st):,} + 8")
    if masked != 2 * (23494721 + 3) * 4 + 8:
        raise SystemExit(f"{label}: masked payload {masked:,}")
    profile_window(label, get_config("resnet50"), st, dev, algorithm="codasca",
                   participation=0.75, fault_seed=1)
    del st
    for label in ("resnet50_momentum", "resnet50_sm3", "resnet50_codasca_masked"):
        runs[label].pop("state")                # no later phase reads them
    n_step = 4 * sum(resnet_leaf_sizes())
    k3_bound, _ = bound_ms(20 * n_step, OPT_OPS_PER_ELEMENT["momentum"] * n_step, rates)
    print(f"profile resnet50_momentum: opt_update {prof['hand_written_ms']['opt_update'] / 8:.4f} "
          f"ms of device time per local step ({runs['resnet50_momentum']['step_launches']} "
          f"launch a step over {RN_LEAVES} leaves) against a bound of "
          f"{k3_bound:.4f} ms (20 B per element, bf16 buffer)")

    stamp("resnet50 paths done")
    # the distributed executor: NCCL at R = torch.cuda.device_count(); one
    # ResNet50 window against the batched executor's, and a profiled one
    sharded = run_sharded_paths(runs, counts)
    sharded["resnet50_shard_map_det"] = run_resnet50_determinism(runs, counts)
    rn_cfg = get_config("resnet50")
    sharded["resnet50_window"] = sharded_window(
        "resnet50_shard_map", rn_cfg, runs["resnet50"]["state"], window_batch(rn_cfg, dev), dev,
        profile=True)

    for run in runs.values():                   # no later phase reads a finished
        run.pop("state", None)                  # path's state: free the card
    stamp("distributed executor paths done")

    # full-depth fp32 prefills: stablelm-1.6b (head_dim 64) and chatglm3-6b
    # (head_dim 128), every K4 launch flash_fwd_tf32x3
    # and the bf16 prefills: stablelm-1.6b beside its fp32 twin, qwen2.5-14b at
    # full depth (a model no fp32 path could hold), every K4 launch
    # flash_fwd_pingpong
    prefills = {}
    for path in (STABLELM_PREFILL, CHATGLM_PREFILL, BF16_STABLELM_PREFILL,
                 BF16_QWEN_PREFILL):
        prefills[path.label], cfg, params = run_prefill(dev, path, k5_checked)
        counts[path.label] = prefills[path.label]["launches"]
        if path is BF16_STABLELM_PREFILL:
            param_check = dryrun_param_check(cfg, params)
        del params
        torch.cuda.empty_cache()
    stamp("dense prefills done")
    # stablelm-1.6b CoDA training at full width, 2 layers; the smoke config
    # (its CPU twin runs in the background)
    print(f"main path stablelm_train: reduced: {TRAIN_LAYERS} of 24 layers (full width "
          "d=2048, 32 heads, d_ff 5632, vocab 100,352), K=4, B=32, S=64, one stage of 16 "
          "local steps")
    label = "stablelm_train"
    runs[label], counts[label] = run_main_path(f"main path {label}", LM_TRAIN_ARGS,
                                               DENSE_LEAVES, attn_layers=TRAIN_LAYERS)
    require_k4_variant(label, runs[label], "flash_fwd_tf32x3", "fp32, head_dim 64")
    lm_cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=TRAIN_LAYERS)
    profile_window(label, lm_cfg, runs[label].pop("state"), dev, consume=True)
    torch.cuda.empty_cache()
    runs["bf16_stablelm_coda"], counts["bf16_stablelm_coda"] = run_bf16_coda(dev)
    torch.cuda.empty_cache()
    runs["bf16_stablelm_codasca"], counts["bf16_stablelm_codasca"] = run_bf16_codasca(dev)
    torch.cuda.empty_cache()
    label = "bf16_stablelm_shard_map"
    runs[label], counts[label] = run_bf16_sharded(dev)
    sharded[label] = runs[label]
    torch.cuda.empty_cache()
    label, args, per_leaf = LM_SMOKE
    runs[label], counts[label] = run_main_path(f"main path {label}", args, DENSE_LEAVES,
                                               per_leaf, attn_layers=2)
    runs[label].pop("state")
    torch.cuda.empty_cache()

    stamp("stablelm CoDA paths done")
    # dbrx-132b: prefill and the serving engine at full width, 2 layers;
    # then the launchers' smoke configs (their CPU twins run in the background)
    dbrx_prefill, dbrx_cfg, dbrx_params = run_prefill(dev, DBRX_PREFILL, k5_checked)
    prefills[DBRX_PREFILL.label] = dbrx_prefill
    counts["dbrx_prefill"] = dbrx_prefill["launches"]
    dbrx_serve = run_engine_serve(rates, dbrx_cfg, dbrx_params, k5_checked)
    counts["dbrx_serve"] = dbrx_serve["launches"]
    del dbrx_params
    torch.cuda.empty_cache()
    # the same in bf16 at 4 layers: K5 gmm_wgmma in the prefill (~512 rows an
    # expert) and in the engine (1-4 rows an expert); the engine's scores and
    # token ties held to fp32 under the bf16 rule
    label = BF16_DBRX_PREFILL.label
    prefills[label], bdbrx_cfg, bdbrx_params = run_prefill(dev, BF16_DBRX_PREFILL, k5_checked)
    counts[label] = prefills[label]["launches"]
    bf16_serve = run_engine_serve(rates, bdbrx_cfg, bdbrx_params, k5_checked, "bf16_dbrx_serve")
    counts["bf16_dbrx_serve"] = bf16_serve["launches"]
    stamp("dbrx engine done")
    # the program audit (phase 17) on these weights and at full width
    audit = run_audit(dev, bdbrx_cfg, bdbrx_params, param_check,
                      prefills[BF16_STABLELM_PREFILL.label]["ms_per_prefill"])
    stamp("audit done")
    del bdbrx_params
    torch.cuda.empty_cache()
    label, args, per_leaf = MOE_SMOKE
    runs[label], counts[label] = run_main_path(f"main path {label}", args, MOE_LEAVES,
                                               per_leaf, attn_layers=2, moe_layers=2)
    runs[label].pop("state")
    require_k4_variant(label, runs[label], "flash_fwd_tf32x3", "fp32, head_dim 128")
    serve_out, counts["dbrx_serve_smoke"], serve_text = run_serve_smoke()

    stamp("dbrx paths done")
    # arctic-480b (2 layers) and phi3-medium-14b (40 layers) in bf16 at full
    # width: prefill and serving
    big = run_bf16_big(dev, rates, bf16_rate, k5_checked, gmm_rows, prefills, counts)
    # the vlm, hybrid and audio families: full-width prefills, hymba's engine,
    # seamless's decode, the CoDA paths at full width and the smoke configs
    # (their CPU twins run in the background)
    zoo = run_zoo(dev, rates, k5_checked, runs, counts, prefills)
    stamp("zoo paths done")
    for label, args, leaves, n_attn in ZOO_SMOKE:
        runs[label], counts[label] = run_zoo_train(label, args, leaves, n_attn, dev,
                                                   step_check=False)
    stamp("zoo smoke paths done")
    # the ssm family: xlstm-350m's prefills, decode checks, engine and CoDA
    # path at full width, its smoke config with sm3 and dbrx's with
    # shampoo_blocked (their CPU twins run in the background)
    ssm = run_xlstm(dev, rates, k5_checked, runs, counts)
    stamp("ssm paths done")

    # the same commands on the CPU: test AUC within 0.01; the served tokens
    # equal and the served AUC within 0.01
    stamp("card phases done")
    twins.wait()
    card_reqs, card_auc = serve_lines(serve_text)
    cpu_reqs, cpu_auc = serve_lines(twins.out["dbrx_serve_smoke"])
    print(f"main path dbrx_serve_smoke: {len(card_reqs)} printed requests, equal to "
          f"--device cpu: {card_reqs == cpu_reqs}; served AUC {card_auc} on the card, "
          f"{cpu_auc} with --device cpu (limit 0.01)")
    if not (card_reqs and card_reqs == cpu_reqs and card_auc is not None
            and cpu_auc is not None and abs(card_auc - cpu_auc) <= 0.01):
        raise SystemExit("main path dbrx_serve_smoke: the card and the CPU served "
                         f"differently:\n{card_reqs}\n{cpu_reqs}")
    chaotic = {label for label, _, _ in SSM_TWINS}
    for label, module, _ in TWIN_PATHS:
        if module not in DONE_RE or label in chaotic:
            continue
        pairs = [("test AUC", runs[label]["auc"], twins.auc[label])]
        if runs[label].get("metric") is not None or label in twins.pauc:
            pairs.append(("test pAUC", runs[label]["metric"], twins.pauc[label]))
        for what, card, cpu in pairs:
            print(f"main path {label}: {what} {card:.4f} on the card, {cpu:.4f} with "
                  f"--device cpu (|diff| {abs(card - cpu):.4f}, limit 0.01)")
            if not abs(card - cpu) <= 0.01:
                raise SystemExit(f"main path {label}: card and CPU {what} differ by more "
                                 "than 0.01")

    for label in sorted(chaotic):
        hist = runs[label]["history"]
        evals = [h[2] for i, h in enumerate(hist) if i and hist[i - 1][:2] == h[:2]]
        cpu = float(re.search(EVAL_1_RE, twins.out[label], re.M)[1])
        print(f"main path {label}: test AUC after the first local step {evals[0]:.4f} on the "
              f"card, {cpu:.4f} with --device cpu (|diff| {abs(evals[0] - cpu):.4f}, limit "
              f"0.01); after the last, {runs[label]['auc']:.4f} and {twins.auc[label]:.4f} "
              "(not held: the optimizer amplifies rounding)")
        if not abs(evals[0] - cpu) <= 0.01:
            raise SystemExit(f"main path {label}: card and CPU differ after one local step")

    def row(name, replaces, rows, head, tol, inplace=None):
        h = rows[head]
        by_path = {label: c[name] for label, c in counts.items()}
        err = max(r.get("max_abs_err", 0.0) for r in rows)
        # the in-place form at the headline's shape and dtypes (the donating
        # executors' steps launch it)
        hi = {} if inplace is None else {
            "inplace_ms": rows[inplace]["ms"], "inplace_device_ms": rows[inplace]["device_ms"],
            "inplace_device_ms_source": rows[inplace]["device_ms_source"]}
        step = {} if "per_leaf_ms" not in h else {
            "variant": h["variant"], "leaves": h["leaves"],
            "out_of_place_ms": h["out_of_place_ms"],
            "out_of_place_device_ms": h["out_of_place_device_ms"],
            "one_leaf_tables_ms": h["per_leaf_ms"],
            "one_leaf_tables_device_ms": h["per_leaf_device_ms"]}
        return {"name": name, "route": "cuda", **hi, **step,
                "source": "src/repro_torch/kernels/csrc/coda_kernels.cu",
                "wrapper": f"src/repro_torch/kernels/{name}.py",
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "tol": tol,
                "shape": h["shape"], "ms": h["ms"], "device_ms": h["device_ms"],
                "device_ms_source": h["device_ms_source"],
                "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": None, "max_err": err, "kernel_us": h["ms"] * 1e3,
                "plain_us": h["plain_ms"] * 1e3, "bound_us": h["bound_ms"] * 1e3,
                "shapes": rows}

    # headline shapes: auc_loss at the launcher's [K, B] = [4, 32]; prox_update
    # over a ResNet50 local step's 153 leaves × K in fp32, one launch in place
    # (ms; the same leaves as one-leaf tables beside it); opt_update there
    # too, momentum with the bf16 buffer the launcher paths use
    auc_head = next(i for i, r in enumerate(auc_rows) if r["shape"] == [4, 32])
    prox_head = next(i for i, r in enumerate(prox_rows) if r.get("what") == "resnet50 step")
    opt_head = next(i for i, r in enumerate(opt_rows)
                    if r.get("what") == "resnet50 step" and r["mode"] == "momentum"
                    and r["dtypes"] == ["float32/bfloat16"])
    prox_in = next(i for i, r in enumerate(prox_rows)
                   if r.get("form") == "inplace" and r["dtype"] == "float32")
    opt_in = next(i for i, r in enumerate(opt_rows)
                  if r.get("form") == "inplace" and r["mode"] == "momentum"
                  and r["dtype"] == "float32" and r["buf_dtype"] == "bfloat16")
    kernels = [
        row("auc_loss", "src/repro/kernels/auc_loss.py:61", auc_rows, auc_head,
            "atol 1e-5 + rtol 1e-4"),
        row("prox_update", "src/repro/kernels/prox_update.py:39", prox_rows, prox_head,
            "bitwise (0) in f32 and bf16; the in-place form bitwise the out-of-place one",
            prox_in),
        row("opt_update", "src/repro/kernels/opt_update.py:72", opt_rows, opt_head,
            "bitwise (0): v and buffer in every mode and dtype, bf16 rounding bits "
            "included; coef=0 equals prox_update bitwise; the in-place form bitwise the "
            "out-of-place one", opt_in),
    ]
    # launches of each K4/K5 variant on each path (counters set to 0 just
    # before each path, read just after), and each variant's headline case
    variants = {label: r["variant_launches"] for label, r in runs.items()}
    variants.update({label: r["variant_launches"] for label, r in prefills.items()},
                    hymba_serve=zoo["hymba_serve"]["variant_launches"],
                    seamless_decode=zoo["seamless_decode"]["variant_launches"],
                    xlstm_serve=ssm["xlstm_serve"]["variant_launches"],
                    **{k: ssm[k]["variant_launches"] for k in ("xlstm_prefill",
                                                                "bf16_xlstm_prefill")},
                    dbrx_serve=dbrx_serve["variant_launches"],
                    bf16_dbrx_serve=bf16_serve["variant_launches"],
                    **{k: big[k]["variant_launches"] for k in ("bf16_arctic_serve",
                                                               "bf16_phi3_serve")},
                    dbrx_serve_smoke=serve_out["variant_launches"])

    def variant_rows(name, rows, heads):
        """Each variant's launches by path, its cases and largest error, and
        its headline cases' numbers (the first is ``head``)."""
        keys = ("ms", "device_ms", "device_ms_source", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_ffma_ms", "bound_tf32x3_ms", "err_vs_f64", "tiles",
                "wgmma", "shape")
        out = {}
        for variant, cases in heads.items():
            by_path = {label: v[name][variant] for label, v in variants.items()}
            at = {c: {k: r[k] for k in keys if k in r}
                  for r in rows for c in cases if r["case"] == c}
            out[variant] = {
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "cases": [r["case"] for r in rows if r["kernel"] == variant],
                "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == variant),
                "head": cases[0], **at[cases[0]], "heads": at}
        return out

    # flash_attention: headline at stablelm-1.6b's prefill shape in fp32, the
    # shape where the prefill path spends its attention time (flash_fwd_tf32x3,
    # so its bound is 3xTF32's)
    h = next(r for r in attn_rows if r["case"] == "stablelm_prefill")
    by_path = {label: c["flash_attention"] for label, c in counts.items()}
    f32_err = max(r["max_abs_err"] for r in attn_rows if r["dtype"] == "float32")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "wrapper": "src/repro_torch/kernels/flash_attention.py",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": f32_err,
        "max_abs_err_bf16": max(r["max_abs_err"] for r in attn_rows
                                if r["dtype"] == "bfloat16"),
        "tol": (f"(atol, rtol) fp32 {ATTN_TOL[F32]}, bf16 {ATTN_TOL[BF16]}; "
                f"lse atol {LSE_ATOL}"),
        "shape": h["shape"], "ms": h["ms"], "device_ms": h["device_ms"],
                "device_ms_source": h["device_ms_source"],
        "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
        "library_ms": h["library_ms"], "library": "torch.nn.functional."
        "scaled_dot_product_attention", "max_err": f32_err,
        "kernel_us": h["ms"] * 1e3, "plain_us": h["plain_ms"] * 1e3,
        "bound_us": h["bound_ms"] * 1e3, "shapes": attn_rows, "backward": attn_bwd,
        "variants": variant_rows("flash_attention", attn_rows,
                                 {"flash_fwd": ["smoke_hd32"],
                                  "flash_fwd_pingpong": ["stablelm_prefill_bf16",
                                                      "qwen_prefill_bf16", "dbrx_prefill_bf16",
                                                      "stablelm_train_bf16",
                                                      "internvl_prefill_bf16",
                                                      "hymba_prefill_bf16",
                                                      "arctic_prefill_bf16",
                                                      "phi3_prefill_bf16"],
                                  "flash_fwd_tf32x3": ["stablelm_prefill", "chatglm_prefill",
                                                       "qwen_gqa", "dbrx_prefill",
                                                       "internvl_prefill", "internvl_train",
                                                       "hymba_prefill", "hymba_train",
                                                       "seamless_encoder", "seamless_cross"]}),
        "prefills": {label: {k: prefills[label][k] for k in (
            "ms_per_prefill", "ref_ms_per_prefill", "tokens_per_s", "peak_bytes", "errs")}
            for label in (STABLELM_PREFILL.label, CHATGLM_PREFILL.label,
                          BF16_STABLELM_PREFILL.label, BF16_QWEN_PREFILL.label,
                          BF16_ARCTIC_PREFILL.label, BF16_PHI3_PREFILL.label)
            + tuple(p.label for p in ZOO_PREFILLS)}})
    # flash_fill_no_key: K4's rows with no valid key, after any variant; no
    # path has such rows, so 0 launches on every path (checked), and its
    # headline is the fill alone at FILL_TIMED
    fills_by_path = {label: v["flash_fill_no_key"] for label, v in variants.items()}
    if any(fills_by_path.values()):
        raise SystemExit(f"flash_fill_no_key launched on a path: {fills_by_path}")
    print(f"flash_fill_no_key: 0 launches on each of {len(fills_by_path)} paths, "
          f"{no_key['fills']} in the K4 check")
    h = no_key["timed"]
    kernels.append({
        "name": "flash_fill_no_key", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "wrapper": "src/repro_torch/kernels/flash_attention.py",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": sum(fills_by_path.values()), "launches_by_path": fills_by_path,
        "launches_in_check": no_key["fills"],
        "max_abs_err": max(max(r[k]["max_abs_err_keyless"] for k in r
                               if isinstance(r[k], dict)) for r in no_key["rows"]),
        "tol": "each variant's flash_attention tolerance at every row; keyless lse "
               "-1e30f bitwise",
        "shape": h["shape"], "ms": h["ms"], "device_ms": h["device_ms"],
        "device_ms_source": h["device_ms_source"], "plain_ms": h["plain_ms"],
        "bound_ms": h["bound_ms"], "bound_by": h["bound_by"], "library_ms": None,
        "cases": no_key["rows"], "backward": no_key["backward"], "timed": h})
    # grouped_matmul: headline at dbrx-132b's decode gate/up shape in fp32,
    # the call every moe layer of every served token makes twice
    h = next(r for r in gmm_rows if r["case"] == "dbrx_decode_gate")
    by_path = {label: c["grouped_matmul"] for label, c in counts.items()}
    kernels.append({
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_dispatch.cu",
        "wrapper": "src/repro_torch/kernels/moe_dispatch.py",
        "replaces": "src/repro/kernels/moe_dispatch.py:71",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in gmm_rows if r["dtype"] == "float32"),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in gmm_rows
                                if r["dtype"] == "bfloat16"),
        "tol": f"(atol, rtol) fp32 {GMM_TOL[F32]}, bf16 {GMM_TOL[BF16]}",
        "shape": [h["N"], h["Kd"], h["F"], h["groups"]], "ms": h["ms"],
        "device_ms": h["device_ms"], "device_ms_source": h["device_ms_source"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
        "bound_by": h["bound_by"], "library_ms": h["library_ms"],
        "library": "torch._grouped_mm", "library_note": h["library_note"],
        "max_err": h["max_abs_err"], "kernel_us": h["ms"] * 1e3,
        "plain_us": h["plain_ms"] * 1e3, "bound_us": h["bound_ms"] * 1e3, "shapes": gmm_rows,
        "variants": variant_rows("grouped_matmul", gmm_rows,
                                 {"gmm_rows": ["dbrx_decode_gate"],
                                  "gmm_tf32x3": ["dbrx_prefill_gate", "dbrx_prefill_down",
                                                 "kfold_4x16_strided_float32",
                                                 "tf32x3_ragged"],
                                  "gmm_tiles": ["tiles_ragged_float32", "tiles_f302_float32",
                                                "kfold_4x16_strided_float32_d126",
                                                "tiles_ragged_bfloat16"],
                                  "gmm_wgmma_m128": ["dbrx_prefill_gate_bf16",
                                                     "dbrx_prefill_down_bf16",
                                                     "kfold_4x16_strided_bfloat16_m128",
                                                     "m128_ragged_bf16",
                                                     "m128_ragged_d6144_bf16"],
                                  "gmm_wgmma": ["dbrx_decode_gate_bf16",
                                                "dbrx_decode_down_bf16",
                                                "arctic_prefill_bf16",
                                                "arctic_prefill_down_bf16",
                                                "arctic_decode_bf16",
                                                "arctic_decode_down_bf16",
                                                "bf16_arctic_prefill_gate_routed",
                                                "bf16_arctic_prefill_down_routed",
                                                "bf16_arctic_serve_gate_routed",
                                                "bf16_arctic_serve_down_routed"]}),
        "prefill": {k: dbrx_prefill[k] for k in ("ms_per_prefill", "ref_ms_per_prefill",
                                                 "tokens_per_s", "peak_bytes", "errs")},
        "prefill_bf16": {k: prefills[BF16_DBRX_PREFILL.label][k] for k in (
            "ms_per_prefill", "ref_ms_per_prefill", "tokens_per_s", "peak_bytes", "errs",
            "bf16_rule")},
        "serve": {k: v for k, v in dbrx_serve.items() if k != "profile"},
        "serve_bf16": {k: v for k, v in bf16_serve.items() if k != "profile"},
        "prefill_bf16_arctic": {k: prefills[BF16_ARCTIC_PREFILL.label][k] for k in (
            "ms_per_prefill", "ref_ms_per_prefill", "tokens_per_s", "peak_bytes", "errs",
            "bf16_rule")},
        "serve_bf16_arctic": {k: v for k, v in big["bf16_arctic_serve"].items()
                              if k != "profile"}})
    print(json.dumps({"sharded": sharded}, default=str))
    print(json.dumps({"zoo": zoo}, default=str))
    print(json.dumps({"ssm": ssm}, default=str))
    print(json.dumps({"audit": audit}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
