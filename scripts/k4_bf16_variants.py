"""Compare K4's bf16 ``flash_fwd_pingpong`` with its candidates on the card,
beside ``flash_fwd_wgmma`` and ``scaled_dot_product_attention`` on the same
values.

    python3 scripts/k4_bf16_variants.py [--variants shipped,no_trim,diag_no_exp]
        [--rounds 5] [--iters 20] [--out build/k4_bf16_variants/results.json]
    python3 scripts/k4_bf16_variants.py --prefill stablelm-1.6b [--prefill-pairs 10]

The shipped kernel runs consumer warpgroups that share each K/V stage in
phase (three at head_dim 64, a block an item, with a causal warpgroup's
products stopped at the last tile its rows reach; two at 128 and when
packed, with persistent blocks), one ex2 a score, and two heads an item
where S, Skv <= 64.  The candidates it was chosen over: ``turns`` (the
consumer warpgroups taking turns on the tensor cores at named barriers,
FA3's ping-pong), ``two_wg_hd64`` (two consumer warpgroups at head_dim 64),
``one_item_a_block`` (no persistent blocks), ``persistent_hd64``
(persistent blocks at head_dim 64 too), ``no_trim`` (every warpgroup's
products over every tile of the item), ``three_wg_hd128`` and
``three_wg_hd128_blocks`` (three warpgroups over 64-key tiles at head_dim
128, persistent or not), ``bk64_hd128`` (two warpgroups over 64-key
tiles in 5 stages at head_dim 128), ``stages6_hd64`` and ``stages3_hd128``
(the ring 6 deep at head_dim 64, 3 at 128), ``tree`` (the softmax's row max and sum as four
partial chains), ``rescale_early`` (O rescaled between the two products'
issue, as FA3 orders it), ``regs240`` (24 / 240 registers at two
warpgroups).  The diagnostics, timed and not checked: ``diag_no_exp``
(each ex2 of the softmax replaced by a move: what the SFU costs) and
``diag_no_v_load`` (V's tiles not loaded: what
the L2 → shared-memory bytes cost).

Each variant is a patched copy of ``src/repro_torch/kernels/csrc`` (a list
of source substitutions below) built with nvcc into its own library under
``build/k4_bf16_variants/<name>/``, so ``csrc/`` itself is never touched.
For each it prints ptxas's register and spill report and any C75xx
"wgmma serialized" note of ``flash_fwd_pingpong``; checks each candidate
against the plain version (``ref.attention_full``) on the same bf16 values
at the path shapes and the packed and ragged edges, under the bf16
tensor-core tolerance (rtol 2^-7, atol 2^-9·max|v| + 1e-4; lse atol 1e-4)
at every row: the C entry point follows each variant with flash_fill_no_key,
so a row with no valid key (S ≥ Skv + window) gets the reference's mean
of V and lse = −1e30f, which is held bitwise;
then times every path shape with CUDA events in turns — flash_fwd_wgmma
(variant id 1 of the shipped library), the variants' flash_fwd_pingpong
(variant id 3), the variants reversed, SDPA — ``rounds`` times (2·rounds
pairs a variant) and counts the turns each variant beats flash_fwd_wgmma
and the shipped kernel in.

``--prefill ARCH`` (a dense bf16 model: stablelm-1.6b, phi3-medium-14b)
instead runs ``prefill_step`` at full width and depth on [B=4, S=2048]
tokens (one replica, bf16 weights from seed 0) with every bf16 K4 call on
flash_fwd_wgmma ("before": the wrapper's pick replaced by
``wgmma_geometry``) and as the wrapper routes them ("after"), in
alternating turns (before, after, after, before, ...) for
``--prefill-pairs`` pairs, and prints ms per prefill (CUDA events, the
median of 3 a turn), tokens/s, the turns "after" won and the largest
difference between the two prefills' scores and last logits.  Needs a
CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402

_SRC = open(os.path.join(_build.CSRC, "flash_attention.cu")).read()


def _block(start: str, end: str) -> str:
    """The shipped source from ``start`` up to (not including) ``end``."""
    a = _SRC.index(start)
    return _SRC[a:_SRC.index(end, a)]


_PERSISTENT = "  return !(hd == 64 && !packed);"
_NO_ROWS = _block("    if (wg >= it.n_wg) {", "    // this thread's head and two rows")
_ROWS = _block("  const float c = w.scale_log2;", "// P rounded to bf16 as wgmma's A fragments")
_RESCALE_LOOP = (
    "#pragma unroll\n      for (int c = 0; c < HD / 8; ++c) {\n"
    "        oacc[4 * c] *= corr[0];\n        oacc[4 * c + 1] *= corr[0];\n"
    "        oacc[4 * c + 2] *= corr[1];\n        oacc[4 * c + 3] *= corr[1];\n      }\n"
    "      pp_pack<BK>(sacc, pa);\n    }\n")
_SCORES_THEN_PV = ("      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s1 * kStageBytes);\n"
                  "      hopper::fence_regs(oacc);\n")
_RESCALE_EARLY_LOOP = (
    "      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s1 * kStageBytes);\n"
    "#pragma unroll\n      for (int c = 0; c < HD / 8; ++c) {\n"
    "        oacc[4 * c] *= corr[0];\n        oacc[4 * c + 1] *= corr[0];\n"
    "        oacc[4 * c + 2] *= corr[1];\n        oacc[4 * c + 3] *= corr[1];\n      }\n"
    "      hopper::fence_regs(oacc);\n")
_LAST_PV = ("      hopper::mbar_wait(&vfull[s], (j / NST) & 1);\n"
            "      hopper::fence_regs(oacc);\n")
_RESCALE_EARLY_LAST = (
    "      hopper::mbar_wait(&vfull[s], (j / NST) & 1);\n"
    "#pragma unroll\n      for (int c = 0; c < HD / 8; ++c) {\n"
    "        oacc[4 * c] *= corr[0];\n        oacc[4 * c + 1] *= corr[0];\n"
    "        oacc[4 * c + 2] *= corr[1];\n        oacc[4 * c + 3] *= corr[1];\n      }\n"
    "      hopper::fence_regs(oacc);\n")
# FA3's ping-pong: the consumer warpgroups take turns on the tensor cores.
# Warpgroup w waits at named barrier 1 + w until the warpgroup before it has
# issued its products, issues its own, then passes the turn on (w → w + 1,
# the last to 0; warpgroup 0 starts).  The last warpgroup's pass after an
# item's last products is dropped, so every barrier completes as often as
# it is waited at; a warpgroup with no rows (or head) keeps the item's
# turns, one past its causal rows keeps its tail's, and an item with no
# K/V tile takes no turn at all.
_NAMED_BARRIER_ARRIVE = r"""__device__ __forceinline__ void named_barrier_arrive(int id, int threads, bool pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.u32 p, %2, 0;\n@p bar.arrive %0, %1;\n}\n" ::"r"(id),
               "r"(threads), "r"(static_cast<uint32_t>(pred)) : "memory");
}

"""
_TURN_FNS = """template <int NC>
__device__ __forceinline__ void pp_turn_wait(int wg) {
  hopper::named_barrier_sync(1 + wg, 256);
}
template <int NC>
__device__ __forceinline__ void pp_turn_pass(int wg, bool pred = true) {
  hopper::named_barrier_arrive(1 + (wg + 1) % NC, 256, pred);
}

"""
_NO_ROWS_TURNS = """    if (wg >= it.n_wg) {  // no rows (or no head) in this item: keep the turns
      if (ntiles > 0 && last_wg) pp_turn_pass<NC>(wg);  // warpgroup 0 takes the first turn
      for (int i = 0; ntiles > 0 && i <= ntiles; ++i) {
        if (!Packed && i < ntiles) {  // unpacked, release the item's stages too
          const int g = base + i, s = g % NST;
          hopper::mbar_wait(&kfull[s], (g / NST) & 1);
          hopper::mbar_arrive(&kempty[s]);
        }
        if (!Packed && i > 0) {
          const int g = base + i - 1, s = g % NST;
          hopper::mbar_wait(&vfull[s], (g / NST) & 1);
          hopper::mbar_arrive(&vempty[s]);
        }
        pp_turn_wait<NC>(wg);
        pp_turn_pass<NC>(wg, !(last_wg && i == ntiles));
      }
      base += ntiles * heads;
      return;
    }

"""
_HOST_SIDE = "// ------------------------------------------------------------------ host side"
_TAIL = "      hopper::mbar_arrive(&vempty[s]);\n    }\n    base += ntiles * heads;\n"
_TURNS = [
    ("hopper.cuh", _HOST_SIDE, _NAMED_BARRIER_ARRIVE + _HOST_SIDE),
    ("// issue S = q·kᵀ for a BK-key tile", _TURN_FNS + "// issue S = q·kᵀ for a BK-key tile"),
    (_NO_ROWS, _NO_ROWS_TURNS),
    ("    hopper::mbar_wait(&qfull[wg], qwaits & 1);\n",
     "    if (ntiles > 0 && last_wg) pp_turn_pass<NC>(wg);  // warpgroup 0 takes the first turn\n"
     "    hopper::mbar_wait(&qfull[wg], qwaits & 1);\n"),
    ("      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s * kStageBytes);\n",
     "      pp_turn_wait<NC>(wg);\n      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s * kStageBytes);\n"
     "      pp_turn_pass<NC>(wg);\n"),
    ("      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s1 * kStageBytes);\n",
     "      pp_turn_wait<NC>(wg);\n      pp_issue_scores<HD, BK>(sacc, qw_s, ks + s1 * kStageBytes);\n"),
    ("      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);\n      hopper::wgmma_wait<1>();",
     "      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);\n      pp_turn_pass<NC>(wg);\n"
     "      hopper::wgmma_wait<1>();"),
    (_LAST_PV + "      hopper::wgmma_fence();\n      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);\n",
     "      hopper::mbar_wait(&vfull[s], (j / NST) & 1);\n      pp_turn_wait<NC>(wg);\n"
     "      hopper::fence_regs(oacc);\n      hopper::wgmma_fence();\n"
     "      pp_issue_pv<HD, BK>(oacc, pa, vs + s * kStageBytes);\n"
     "      pp_turn_pass<NC>(wg, !last_wg);\n"),
    (_TAIL, _TAIL.replace("    }\n", "      pp_turn_wait<NC>(wg);\n      pp_turn_pass<NC>(wg);\n"
                                    "    }\n", 1)),
]
_THREE_WG_HD128 = [
    ("  return hd == 64 && !packed ? kPpConsumers64 : kPpConsumers128;",
     "  return !packed ? 3 : kPpConsumers128;"),
    ("  constexpr int BK = Packed ? kPpPackBK : kPpBK;",
     "  constexpr int BK = Packed || HD == 128 ? kPpPackBK : kPpBK;"),
    ("  constexpr int kStageBytes = kPpBK * HD * 2;",
     "  constexpr int kStageBytes = (HD == 128 ? kPpPackBK : kPpBK) * HD * 2;"),
    ("pp_stages<HD>() * 2 * kPpBK * HD * 2 +",
     "pp_stages<HD>() * 2 * (HD == 128 ? kPpPackBK : kPpBK) * HD * 2 +"),
    ("constexpr int pp_stages() { return HD == 64 ? 4 : 2; }",
     "constexpr int pp_stages() { return HD == 64 ? 4 : 5; }"),
    ("  const uint32_t* kbox = packed ? kPpPackKBox : kPpKBox;",
     "  const uint32_t* kbox = packed || HD == 128 ? kPpPackKBox : kPpKBox;"),
]
VARIANTS = {
    "shipped": [],
    # the consumer warpgroups taking turns on the tensor cores (FA3's
    # ping-pong; the shipped kernel's share each K/V stage in phase)
    "turns": _TURNS,
    # the candidates the shipped choices were measured against: two consumer
    # warpgroups (128-row items) at head_dim 64; no persistent blocks (a
    # block an item) anywhere; persistent blocks at head_dim 64 too (three
    # warpgroups at 160 registers)
    "two_wg_hd64": [("constexpr int kPpConsumers64 = 3;", "constexpr int kPpConsumers64 = 2;")],
    "one_item_a_block": [(_PERSISTENT, "  return false;")],
    "persistent_hd64": [(_PERSISTENT, "  return true;")],
    # the softmax's row max and row sum as four partial chains each (a
    # serial chain of BK / 8 dependent FMNMX or FADD otherwise)
    "tree": [(_ROWS, _ROWS.replace(
        "    float mx = kNegInf;\n#pragma unroll\n    for (int j = 0; j < BK / 8; ++j)\n"
        "      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));\n",
        "    float mxa[4] = {kNegInf, kNegInf, kNegInf, kNegInf};\n#pragma unroll\n"
        "    for (int j = 0; j < BK / 8; ++j)\n"
        "      mxa[j % 4] = fmaxf(mxa[j % 4], fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));\n"
        "    float mx = fmaxf(fmaxf(mxa[0], mxa[1]), fmaxf(mxa[2], mxa[3]));\n").replace(
        "    float sum = 0.f;\n", "    float sa[4] = {0.f, 0.f, 0.f, 0.f};\n").replace(
        "      sum += p0 + p1;\n    }\n",
        "      sa[j % 4] += p0 + p1;\n    }\n    float sum = (sa[0] + sa[1]) + (sa[2] + sa[3]);\n"))],
    # O's rescale between q·kᵀ_{i+1}'s and P·V_i's issue (while q·kᵀ runs,
    # as FA3 orders it) in place of after P·V_{i-1} completes
    "rescale_early": [(_RESCALE_LOOP, "      pp_pack<BK>(sacc, pa);\n    }\n"),
                      (_SCORES_THEN_PV, _RESCALE_EARLY_LOOP),
                      (_LAST_PV, _RESCALE_EARLY_LAST)],
    # 24 / 240 registers a thread at two consumer warpgroups (40 / 232)
    "regs240": [("  constexpr int kProducerRegs = NC == 3 ? 24 : 40;\n"
                 "  constexpr int kConsumerRegs = NC == 3 ? 160 : 232;",
                 "  constexpr int kProducerRegs = 24;\n"
                 "  constexpr int kConsumerRegs = NC == 3 ? 160 : 240;")],
    # every consumer warpgroup's products cover every tile of the item (the
    # shipped kernel stops a warpgroup's at the last tile its causal rows
    # reach)
    "no_trim": [("    if (!Packed && causal && !last_wg)\n"
                 "      ntw = min(ntiles, (min(min(S, qw + 64), Skv) - kv_lo + BK - 1) / BK);\n",
                 "")],
    # head_dim 128 with three consumer warpgroups (192-row items) over
    # 64-key tiles in 5 stages (registers 64 + 32 + 16 a consumer thread at
    # 160; 214,224 B), persistent or a block an item
    "three_wg_hd128": _THREE_WG_HD128,
    # head_dim 128 with two consumer warpgroups over 64-key tiles in 5 stages
    "bk64_hd128": _THREE_WG_HD128[1:4] + [
        _THREE_WG_HD128[4], _THREE_WG_HD128[5]],
    # ring depth: 6 stages at head_dim 64; 3 at head_dim 128
    "stages6_hd64": [("constexpr int pp_stages() { return HD == 64 ? 4 : 2; }",
                      "constexpr int pp_stages() { return HD == 64 ? 6 : 2; }")],
    "stages3_hd128": [("constexpr int pp_stages() { return HD == 64 ? 4 : 2; }",
                       "constexpr int pp_stages() { return HD == 64 ? 4 : 3; }")],
    "three_wg_hd128_blocks": _THREE_WG_HD128 + [(_PERSISTENT, "  return packed;")],
    # diagnostics, timed and not checked: each ex2 of the softmax a move; V's
    # tiles not loaded (each V stage's barrier completed by a plain arrival,
    # the products kept: what K/V's L2 → shared-memory bytes cost)
    "diag_no_exp": [("hopper.cuh", 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                     'asm("mov.b32 %0, %1;\\n" : "=f"(y) : "f"(x));')],
    "diag_no_v_load": [(
        "            hopper::mbar_expect_tx(&vfull[s], kTileBytes);\n#pragma unroll\n"
        "            for (int j = 0; j < NHB; ++j)\n"
        "              hopper::tma_load_4d(vs + s * kStageBytes + j * kKVRegion, &vmap, &vfull[s], "
        "64 * j,\n                                  kvh, k0, it.b);\n",
        "            hopper::mbar_arrive(&vfull[s]);\n")],
}

# the bf16 path shapes (PERF.md's K4 rows): label, B, S, H, KV, Skv, hd, causal, window
PATH_SHAPES = [
    ("stablelm_prefill", 4, 2048, 32, 32, 2048, 64, True, None),
    ("stablelm_train", 128, 64, 32, 32, 64, 64, True, None),
    ("hymba_prefill", 2, 4096, 25, 5, 4096, 64, True, None),
    ("hymba_window2048", 2, 4096, 25, 5, 4096, 64, True, 2048),
    ("hymba_train", 128, 64, 25, 5, 64, 64, True, None),
    ("qwen_prefill", 4, 2048, 40, 8, 2048, 128, True, None),
    ("phi3_prefill", 4, 2048, 40, 10, 2048, 128, True, None),
    ("internvl_prefill", 4, 2048, 16, 8, 2048, 128, True, None),
    ("arctic_prefill", 2, 1024, 56, 8, 1024, 128, True, None),
    ("dbrx_prefill", 2, 1024, 48, 8, 1024, 128, True, None),
]
# the edges, checked only
EDGES = [
    ("ragged_window_hd128", 2, 1000, 4, 4, 1000, 128, True, 256),
    ("mqa_ragged_hd128", 2, 1000, 8, 1, 1000, 128, True, None),
    ("one_wg_rows", 3, 64, 4, 2, 64, 64, True, None),
    ("skv_ne_s_ragged", 1, 200, 4, 4, 333, 64, False, None),
    ("window_no_causal", 2, 130, 2, 2, 130, 64, False, 50),
    ("packed_odd_h", 2, 64, 5, 5, 64, 64, True, None),
    ("packed_straddle_hd128", 2, 64, 6, 3, 64, 128, False, None),
    ("packed_s_lt_skv", 2, 40, 4, 2, 56, 64, False, None),
    ("packed_window_s64", 2, 64, 8, 8, 64, 64, True, 16),
    ("s193_three_tiles", 2, 193, 4, 4, 193, 64, True, None),
    # S > Skv + window: the last item has no K/V tile and fewer rows than
    # consumer warpgroups (its rows have no valid key)
    ("no_key_rows_window", 1, 200, 2, 2, 64, 64, False, 16),
    ("no_key_rows_causal_hd128", 1, 300, 2, 2, 64, 128, True, 16),
]
WGMMA, PINGPONG = 1, 3   # the C entry point's variant ids


def start_build(name: str, subs):
    """Write the patched copy and start its nvcc (every source of the
    package's library, so a prefill could run on it too); returns (name,
    process, lib path).  A substitution (old, new) patches
    flash_attention.cu, (file, old, new) another file of csrc/."""
    d = os.path.join(ROOT, "build", "k4_bf16_variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for sub in subs:
        fname, old, new = sub if len(sub) == 3 else ("flash_attention.cu", *sub)
        src = open(os.path.join(d, fname)).read()
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {fname} holds {old[:80]!r} {src.count(old)} times, "
                             f"not once")
        open(os.path.join(d, fname), "w").write(src.replace(old, new))
    out = os.path.join(d, "lib.so")
    i = _build.NVCC_FLAGS.index("-I")
    flags = _build.NVCC_FLAGS[:i] + _build.NVCC_FLAGS[i + 2:]
    cmd = [_build.nvcc(), *flags, "-shared", "-I", d, "-Xptxas", "-v", "-o", out,
           *(os.path.join(d, src.name) for src in _build.sources())]
    return name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True), out


def finish_build(name: str, proc, out: str):
    """Wait for the build; print ptxas's report of flash_fwd_pingpong (and
    of flash_fwd_wgmma for the shipped library); the loaded library, or
    None if nvcc failed."""
    text = proc.communicate()[0]
    if proc.returncode:
        print(f"{name}: nvcc failed, skipped\n{text[-3000:]}")
        return None
    lines = text.splitlines()
    for j, line in enumerate(lines):
        if ("flash_fwd_pingpong" in line or (name == "shipped" and "flash_fwd_wgmma" in line)) \
                and "Function properties" in line:
            print(f"{name}: {line.split('for')[-1].strip()[:90]}: {lines[j + 1].strip()}; "
                  f"{lines[j + 2].strip()}")
        if ("flash_fwd_pingpong" in line or "flash_fwd_wgmma" in line) and (
                "C75" in line or "serialized" in line):
            print(f"{name}: ptxas: {line.strip()[:300]}")
    lib = ctypes.CDLL(out)
    for fn, (restype, argtypes) in _build._SIGNATURES.items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def run(lib, vid: int, q, k, v, causal, window):
    """One launch of variant ``vid`` of ``lib`` (uncounted); (o, lse)."""
    import torch
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = lib.flash_attention_forward(1, hd, vid, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      o.data_ptr(), lse.data_ptr(), B, S, H, Skv, KV,
                                      int(causal), -1 if window is None else window,
                                      hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"variant {vid}")
    return o, lse


def event_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa(q, k, v, causal, window):
    """One scaled_dot_product_attention call on the same values (timed
    only; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    if window is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=gqa)
    pos = lambda n: torch.arange(n, device=q.device)
    mask = ref._mask(pos(q.shape[1]), pos(k.shape[1]), causal, window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def median(v):
    return sorted(v)[len(v) // 2]


def compare(res: dict, name: str, base: str, key: str) -> None:
    """How often, turn by turn, ``name`` beat ``base`` at ``key``, and the
    median times and ratio."""
    a, b = res.get(f"{name}/{key}"), res.get(f"{base}/{key}")
    if a and b:
        wins = sum(x < y for x, y in zip(a, b))
        print(f"{name}/{key}: faster than {base} in {wins} of {len(a)} turns, median "
              f"{median(a):.4f} against {median(b):.4f} ms, median ratio "
              f"{median([x / y for x, y in zip(a, b)]):.3f}", flush=True)


def inputs(dev, B, S, H, KV, Skv, hd, seed: int):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((B, Skv, KV, hd), generator=g, device=dev).bfloat16()
            for _ in range(2))
    return q, k, v


def check(name, lib, case, dev, res) -> bool:
    """The variant's flash_fwd_pingpong, then flash_fill_no_key, against the
    plain version on the same bf16 values (rtol 2^-7, atol 2^-9·max|v| +
    1e-4) at every row; lse within 1e-4 on the rows with a valid key, and
    fp32(−1e30) bitwise on the rows with none."""
    import torch

    from repro_torch.kernels import ref
    label, B, S, H, KV, Skv, hd, causal, window = case
    q, k, v = inputs(dev, B, S, H, KV, Skv, hd, S + H + hd)
    o, lse = run(lib, PINGPONG, q, k, v, causal, window)
    want, want_lse = ref.attention_full(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    pos = lambda n: torch.arange(n, device=dev)
    keyed = ref._mask(pos(S), pos(Skv), causal, window).any(-1)
    atol = 2 ** -9 * float(v.float().abs().max()) + 1e-4
    d = (o.float() - want.float()).abs()
    lse_err = float((lse - want_lse).abs()[:, :, keyed].max())
    ok = bool((d <= atol + 2 ** -7 * want.float().abs()).all()) and lse_err <= 1e-4
    ok = ok and bool((lse[:, :, ~keyed] == torch.tensor(-1e30, dtype=torch.float32)).all())
    res[f"{name}/{label}/err"] = float(d.max())
    print(f"{name}: {label}: max_abs_err {float(d.max()):.3g} (atol {atol:.3g}), lse err "
          f"{lse_err:.3g}: {'ok' if ok else 'DISAGREES'}", flush=True)
    return ok


def prefill_ab(arch: str, pairs: int, res: dict) -> int:
    """The bf16 prefill of ``arch`` at full width and depth on [4, 2048],
    every bf16 K4 call on flash_fwd_wgmma (before) and as routed (after),
    in alternating turns."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    cfg = get_config(arch)
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.bfloat16, device=dev)
    params = tree_map(lambda x: x[None], params)
    g = torch.Generator(device=dev).manual_seed(1)
    B, S = 4, 2048
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, B, S), generator=g, device=dev)}
    routed = fa.launch_geometry

    def on_wgmma(B, S, H, KV, Skv, hd, dtype=torch.float32, aligned=True):
        geo = routed(B, S, H, KV, Skv, hd, dtype, aligned)
        return fa.wgmma_geometry(B, S, H, KV, Skv, hd) \
            if geo["kernel"] == "flash_fwd_pingpong" else geo

    def prefill(before: bool):
        fa.launch_geometry = on_wgmma if before else routed
        try:
            return M.prefill_step(cfg, params, batch)
        finally:
            fa.launch_geometry = routed

    def timed(before: bool) -> float:
        ms = []
        for _ in range(3):
            ms.append(event_ms(lambda: prefill(before), 1))
        return median(ms)

    with torch.no_grad():
        outs = {}
        for before in (True, False):
            prefill(before)                              # warm-up
            fa.zero_launches()
            outs[before] = prefill(before)
            torch.cuda.synchronize()
            res[f"{arch}/k4_launches/{'before' if before else 'after'}"] = \
                dict(fa.variant_launches)
        (s0, l0, _), (s1, l1, _) = outs[True], outs[False]
        d_s = float((s0.float() - s1.float()).abs().max())
        d_l = float((l0.float() - l1.float()).abs().max())
        del outs, s0, l0, s1, l1
        print(f"{arch} bf16 prefill [{B}, {S}], {cfg.n_layers} layers: K4 launches before "
              f"{res[f'{arch}/k4_launches/before']}, after {res[f'{arch}/k4_launches/after']}; "
              f"after vs before: scores {d_s:.3g}, last logits {d_l:.3g}", flush=True)
        nb, na = res[f"{arch}/k4_launches/before"], res[f"{arch}/k4_launches/after"]
        ok = nb["flash_fwd_wgmma"] == na["flash_fwd_pingpong"] == sum(nb.values()) \
            == sum(na.values()) > 0
        for i in range(pairs):
            for before in ((True, False) if i % 2 == 0 else (False, True)):
                key = f"{arch}/prefill/{'before' if before else 'after'}"
                res.setdefault(key, []).append(timed(before))
    tok = B * S
    b, a = res[f"{arch}/prefill/before"], res[f"{arch}/prefill/after"]
    print(f"{arch} prefill ms before (flash_fwd_wgmma): {[round(x, 3) for x in b]}")
    print(f"{arch} prefill ms after (as routed): {[round(x, 3) for x in a]}")
    wins = sum(x < y for x, y in zip(a, b))
    print(f"{arch} prefill: after faster in {wins} of {len(a)} pairs; median before "
          f"{median(b):.3f} ms ({tok / median(b) * 1e3:,.0f} tokens/s), after {median(a):.3f} "
          f"ms ({tok / median(a) * 1e3:,.0f} tokens/s), median difference "
          f"{median([x - y for x, y in zip(a, b)]):+.3f} ms", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--prefill", default="")
    ap.add_argument("--prefill-pairs", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "k4_bf16_variants",
                                                  "results.json"))
    args = ap.parse_args()
    import torch

    from repro_torch import disable_tf32
    if not torch.cuda.is_available():
        print("k4_bf16_variants: needs a CUDA card", file=sys.stderr)
        return 1
    disable_tf32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    res: dict = {"device": smi}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if args.prefill:
        rc = 0
        for arch in args.prefill.split(","):
            rc |= prefill_ab(arch, args.prefill_pairs, res)
        json.dump(res, open(args.out, "w"), indent=1)
        return rc
    names = args.variants.split(",")
    if "shipped" not in names:
        names.insert(0, "shipped")
    started = [start_build(name, VARIANTS[name]) for name in names]
    libs = {name: finish_build(name, proc, out) for name, proc, out in started}
    libs = {name: lib for name, lib in libs.items() if lib is not None}
    if "shipped" not in libs:
        return 1
    names = list(libs)
    dev = torch.device("cuda")
    bad = 0
    for name, lib in libs.items():
        if name.startswith("diag_"):
            continue
        for case in PATH_SHAPES + EDGES:
            bad += not check(name, lib, case, dev, res)
    for i, (label, B, S, H, KV, Skv, hd, causal, window) in enumerate(PATH_SHAPES):
        q, k, v = inputs(dev, B, S, H, KV, Skv, hd, i)
        ow = run(libs["shipped"], WGMMA, q, k, v, causal, window)[0]
        op = run(libs["shipped"], PINGPONG, q, k, v, causal, window)[0]
        res[f"{label}/wgmma_vs_pingpong_max_diff"] = float((ow.float() - op.float()).abs().max())
        lib_fn = sdpa(q, k, v, causal, window)
        timed = names
        for r in range(args.rounds):
            for order in (timed, timed[::-1]):
                res.setdefault(f"flash_fwd_wgmma/{label}", []).append(event_ms(
                    lambda: run(libs["shipped"], WGMMA, q, k, v, causal, window), args.iters))
                for name in order:
                    res.setdefault(f"{name}/{label}", []).append(event_ms(
                        lambda: run(libs[name], PINGPONG, q, k, v, causal, window), args.iters))
                res.setdefault(f"sdpa/{label}", []).append(event_ms(lib_fn, args.iters))
        print(f"{label} [{B}, {S}, {H}/{KV}, Skv {Skv}, hd {hd}] window={window}: "
              f"flash_fwd_wgmma vs flash_fwd_pingpong max |diff| "
              f"{res[f'{label}/wgmma_vs_pingpong_max_diff']:.3g}", flush=True)
        for name in timed:
            compare(res, name, "flash_fwd_wgmma", label)
            if name != "shipped":
                compare(res, name, "shipped", label)
        compare(res, "sdpa", "shipped", label)
        del q, k, v, ow, op
    json.dump(res, open(args.out, "w"), indent=1)
    print("all checked cases agree" if not bad else f"{bad} checked cases disagree")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
