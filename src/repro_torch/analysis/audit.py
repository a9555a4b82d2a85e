"""Program audit: the reference's contracts R1–R5 as a rule engine over the
port's executors, serving engine and kernels (counterpart of
``repro.analysis.audit``).

The reference captures each jitted program's jaxpr and optimized HLO and
runs rules over the text.  The port has no compiled artifact: a program is
the Python function the reference jits, run once under recorders, and the
rules read what the recorders saw.

  * **R1 collective placement** — from ``core/bucketing``'s wire log (every
    collective the averaging issues, with its kind, dtype and bytes),
    zeroed around the call.  A local-step body puts nothing on the wire; a
    window is exactly one ``all_reduce`` a dtype bucket of
    ``coda.window_payload_by_dtype`` (bytes in excess by exactly
    ``coda.opt_state_bytes`` are named as optimizer state on the wire);
    ``avg_compress="int8"`` is the s8 + f32 ``all_gather`` pair of
    ``window_payload_bytes(state, "int8")`` a row; ``overlap_chunks`` is
    2·``ring_hop_count`` point-to-point hops in 2·``ring_chain_count``
    independent chains of 2·(R−1) equal hops, grouped by the chain tag each
    hop carries (the chains may interleave), and no blocking collective; a
    stage is one ``all_reduce`` of ``stage_payload_bytes``; a replicated
    partition and the batched executor put nothing on the wire.  The
    reference's ring check also asks for compute between the hops: from
    the pair's host schedule (``bucketing.overlap_log``), every unit of the
    first averaging (a chunk's chain; at R = 1 a row's local mean) is
    issued before the second window's first local step, and the second
    window dispatches a matmul-bearing op after the unit's issue and before
    its wait on it — for every unit but those the first such op itself
    waits for, and for one unit at least.
  * **R2 buffer reuse** — the counterpart of the reference's donation
    audit (donated buffers aliased in the compiled output): once the caller
    holds only the program's outputs, no tensor of its consumed input (the
    old state, the old serving cache, a kernel's operands) may still be
    alive.  Weak references to the old leaves are read with the cyclic
    collector held off: a leaf alive then is either retained (a finding) or
    freed only when the collector runs (a finding too: a reference cycle
    kept it, as ``tree_unflatten``'s closure once kept whole parameter
    trees).  A donated program (``expect["donated"]``: a donating
    executor's window, pair and stage end) must also hand every state leaf
    back in the consumed input's storage, leaf for leaf by path, as XLA
    aliases a donated buffer in the output.  On the card the allocated
    bytes after the call must be within ``R2_SLACK_BYTES`` of the new
    state's, and for a donated program the transient peak (the peak above
    what the program leaves allocated) within ``R2_PEAK_STATE_RATIO`` times
    the new state's bytes plus that slack.
  * **R3 host-sync and dtype lint** — a ``TorchDispatchMode`` over the
    program's aten ops and a ``TorchFunctionMode`` over its tensor methods
    flag any float64 tensor, any host read (``_local_scalar_dense``:
    ``.item()``, ``float(t)``, ``int(t)``, ``bool(t)``; ``.tolist()``), any
    op whose output shape depends on data (``nonzero``, ``bincount``,
    ``unique``, boolean indexing, ``repeat_interleave`` by a tensor without
    its length), any copy to the host (``.cpu()``, ``.numpy()``,
    ``.to("cpu")``), any reduction given a sub-fp32 ``dtype=``, and
    cuBLAS's reduced-precision reductions left allowed
    (``allow_bf16_reduced_precision_reduction``,
    ``allow_fp16_reduced_precision_reduction``).  On the card a tensor on
    the device is what makes a read a sync; on the CPU every tensor is a
    host tensor, so a read counts when its tensor derives from the
    program's inputs (the recorders carry that taint through every op),
    and a Python constant turned tensor is not flagged.  A finding a
    program's ``expect["allow"]`` names by its ``file:line`` is waived with
    that name and listed as such.
  * **R4 recompile budget** — the port has no ``torch.compile``: nothing is
    traced, so a training window of any length compiles nothing.  What is
    built or loaded instead is budgeted: the kernel library is loaded at
    most once a process (``kernels/_build.load``), and a mixed
    prefill/decode engine workload dispatches exactly the two chunk shapes
    C ∈ {``prefill_chunk``, 1}.
  * **R5 static kernel checks** — one launch record a variant, built from
    the wrapper's own ``launch_geometry`` at the shape the path gave it:
    threads ≤ 1024, dynamic shared memory ≤ 232,448 B, grid.y and grid.z
    ≤ 65,535 (grid.x < 2³¹), the tiles the design needs (wgmma M a
    multiple of 64, N a multiple of 8 and at most 256), TMA boxes of at
    most 256 a dimension over 16-byte strides; on the card the record
    must equal the geometry the kernel's own launch code reports
    (``coda_kernels_geometry``, ``flash_attention_geometry``,
    ``grouped_matmul_launch_geometry``).  The dispatch seam
    (``kernels/ops.dispatch``): ``"auto"`` launches only for CUDA tensors
    and then exactly once a call (the wrapper's counter), ``"ref"``
    launches nothing, an unknown ``impl`` raises.

The second half is the registry: ``capture_vmap_programs``,
``capture_sharded_programs`` (on a rank of ``launch/mesh.run_ranks``),
``capture_training_programs``, ``capture_serving_programs`` and
``capture_kernel_launches``.  ``launch/audit.py`` drives them over the
reference's matrix and writes the JSON artifact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import traceback
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import bucketing
from repro_torch.tree import tree_leaves, tree_paths

# the H100's limits a launch is held to
MAX_THREADS = 1024
MAX_DYN_SMEM = 232_448          # opt-in dynamic shared memory a block
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65_535
MAX_TMA_BOX = 256
TMA_STRIDE_ALIGN = 16
# R2 on the card: allocated bytes after a program may exceed the caller's
# other tensors plus the outputs by at most this (the allocator's rounding,
# cuBLAS workspaces, the K1 tickets)
R2_SLACK_BYTES = 64 * 2 ** 20
# R2 on the card, for a donated program: the transient peak may be at most
# this many times the new state's bytes, plus R2_SLACK_BYTES.  A donated
# window holds one state plus one local step's temporaries: the gradients
# (one parameter stack, at most half the state, which also holds
# ``ref_params``), the activations of one batch and one leaf's optimizer
# temporaries (blocked Shampoo on ResNet50's largest leaf at K=4: about
# 10 GB of Newton-Schulz products beside a 24.1 GB state), so it stays
# below one state.  A window that keeps its input until it returns holds a
# whole second state on top of the gradients, above one state.
R2_PEAK_STATE_RATIO = 1.0

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_SELF = os.path.abspath(__file__)
_PKG = os.path.dirname(os.path.dirname(_SELF))           # .../repro_torch


# --------------------------------------------------------------------------
# records
# --------------------------------------------------------------------------
@dataclasses.dataclass
class KernelLaunch:
    """One kernel variant's launch at one shape (R5), the counterpart of
    ``PallasLaunch``.  ``grid`` is (x, y, z); ``tiles`` maps a label to
    (extent, multiple, maximum or None), the divisibility the design needs;
    ``boxes`` are TMA boxes and ``strides`` the global strides in bytes TMA
    reads with.  ``calls`` and ``launched``: how many calls the path made
    at this shape through ``impl`` on ``device`` and how many launches the
    wrapper counted for them (None for a static record, made without a
    call); ``query``: the kernel's own geometry on the card; ``per_call``:
    the launches one call through the kernel makes (K2/K3: one a
    ``MAX_LEAVES`` leaves of a step)."""
    kernel: str
    variant: str
    shape: dict
    grid: tuple
    threads: int
    smem_bytes: int
    tiles: dict = dataclasses.field(default_factory=dict)
    boxes: tuple = ()
    strides: tuple = ()
    impl: str = "auto"
    device: str = "cpu"
    calls: int = 0
    launched: int | None = None
    query: dict | None = None
    per_call: int = 1

    @property
    def name(self) -> str:
        return f"{self.kernel}/{self.variant}"

    def geometry(self) -> dict:
        """What the kernel's own query reports, from the wrapper's side."""
        g = {"grid": tuple(self.grid), "threads": self.threads, "smem_bytes": self.smem_bytes}
        g.update(self.shape.get("_query_keys", {}))
        return g


@dataclasses.dataclass
class Program:
    """One program as one run of it saw it (the counterpart of
    ``CompiledProgram``).  ``expect`` carries its rule parameters:
      * ``"collectives"`` (R1) — ``{"kind": "none"}`` | ``{"kind":
        "window", "expected_bytes", "by_dtype", "opt_bytes"?}`` | ``{"kind":
        "ring", "n_hops", "n_chains", "hop_len"}`` | ``{"kind":
        "gather_pair", "payload_bytes", "n_rows"}``;
      * ``"chunk_shapes"`` (R4) — the exact set of engine chunk shapes;
      * ``"allow"`` (R3) — ``{file:line: name}`` of waived findings.
      * ``"donated"`` (R2) — the program consumes its first argument, a
        state, and must return it (the first output, or the output) in the
        same storage leaf for leaf.
    ``wire``: the wire log of the run; ``lint``: R3 observations;
    ``retained``: R2 messages (None when the program consumes nothing);
    ``moved``: R2's paths of the donated state's leaves that came back in
    other storage (None when nothing is donated);
    ``memory``: R2's allocated bytes on the card; ``launches``: R5
    records of the kernel calls; ``chunk_shapes``: the engine's C values;
    ``library_loads``: loads of the kernel library in this process;
    ``schedule``: an overlapped pair's host schedule (R1)."""
    name: str
    expect: dict = dataclasses.field(default_factory=dict)
    wire: list = dataclasses.field(default_factory=list)
    schedule: list = dataclasses.field(default_factory=list)
    lint: list = dataclasses.field(default_factory=list)
    retained: list | None = None
    moved: list | None = None
    memory: dict | None = None
    launches: list = dataclasses.field(default_factory=list)
    chunk_shapes: set | None = None
    library_loads: int = 0


@dataclasses.dataclass
class Finding:
    rule: str
    program: str
    message: str

    def __str__(self):
        return f"[{self.rule}] {self.program}: {self.message}"


@dataclasses.dataclass
class AuditReport:
    """``findings`` fail the audit; ``checked`` are the (rule, program)
    pairs that ran; ``waived`` are (rule, program, site, name) findings an
    expectation names."""
    findings: list
    checked: list
    waived: list = dataclasses.field(default_factory=list)
    details: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def raise_if_failed(self) -> None:
        if self.findings:
            raise AssertionError("audit failed:\n" + "\n".join(str(f) for f in self.findings))

    def to_dict(self) -> dict:
        per_rule: dict = {}
        blank = lambda: {"checked": [], "findings": [], "waived": []}
        for rule, prog in self.checked:
            per_rule.setdefault(rule, blank())["checked"].append(prog)
        for f in self.findings:
            per_rule.setdefault(f.rule, blank())["findings"].append(
                {"program": f.program, "message": f.message})
        for rule, prog, site, name in self.waived:
            per_rule.setdefault(rule, blank())["waived"].append(
                {"program": prog, "site": site, "name": name})
        return {"ok": self.ok, "n_checked": len(self.checked),
                "n_findings": len(self.findings), "rules": per_rule, "details": self.details}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


# --------------------------------------------------------------------------
# R1 — collective placement
# --------------------------------------------------------------------------
def _fmt(entries) -> list:
    return [tuple(e[:3]) for e in entries]


def _chain(entry):
    """The ring chain a wire entry belongs to (None: not a chain hop)."""
    return entry[3] if len(entry) > 3 else None


def window_payload_problems(wire, expected_bytes: int, *, by_dtype: dict,
                            opt_bytes: int | None = None) -> list:
    """A window's wire against its payload: only ``all_reduce`` calls, one
    per dtype bucket carrying exactly that bucket's bytes, nothing more.
    Stray bytes (or a total excess) of exactly ``opt_bytes`` are named as
    optimizer state on the wire."""
    problems = []
    if sum(by_dtype.values()) != expected_bytes:
        problems.append(f"by_dtype buckets sum to {sum(by_dtype.values())}, expected_bytes "
                        f"says {expected_bytes}")
    stray = [e for e in wire if e[0] != "all_reduce"]
    if stray:
        problems.append(f"expected only all_reduce calls, found {_fmt(stray)}")
    ops = [e for e in wire if e[0] == "all_reduce"]
    unmatched = list(ops)
    for tag, b in sorted(by_dtype.items()):
        hit = next((e for e in unmatched if e[1] == tag and e[2] == b), None)
        if hit is None:
            problems.append(f"no all_reduce carries the {tag} bucket of {b} bytes "
                            f"(calls: {_fmt(ops)})")
            continue
        unmatched.remove(hit)
    total = sum(e[2] for e in ops)
    leak = (f" — the excess equals the per-worker optimizer state ({opt_bytes} B): "
            "optimizer state leaked onto the wire")
    if unmatched:
        msg = f"stray all_reduce beyond the accounted dtype buckets: {_fmt(unmatched)}"
        if opt_bytes and (sum(e[2] for e in unmatched) == opt_bytes
                          or total == expected_bytes + opt_bytes):
            msg += leak
        problems.append(msg)
    elif opt_bytes and total == expected_bytes + opt_bytes:
        problems.append(f"window ships {total} bytes, accounting says {expected_bytes}" + leak)
    return problems


def ring_problems(wire, *, n_hops: int, n_chains: int, hop_len: int) -> list:
    """An overlapped pair's wire: no blocking collective, ``n_hops``
    point-to-point hops forming ``n_chains`` independent chains (grouped by
    their chain tags, not by position) of ``hop_len`` = 2·(R−1) hops of one
    size each (a chunk's reduce-scatter and all-gather)."""
    problems = []
    stray = [e for e in wire if e[0] != "p2p"]
    if stray:
        problems.append(f"overlapped window must not contain blocking collectives, found "
                        f"{_fmt(stray)}")
    hops = [e for e in wire if e[0] == "p2p"]
    if len(hops) != n_hops:
        problems.append(f"expected {n_hops} ring hops, found {len(hops)}")
    elif hop_len and hops:
        chains: dict = {}
        for e in hops:
            chains.setdefault(_chain(e), []).append(e)
        untagged = chains.pop(None, [])
        if untagged:
            problems.append(f"{len(untagged)} ring hops carry no chain tag")
        ragged = [c for c in chains.values()
                  if len(c) != hop_len or len({(e[1], e[2]) for e in c}) != 1]
        if len(chains) != n_chains or ragged:
            problems.append(f"expected {n_chains} independent chains of {hop_len} equal hops, "
                            f"found {len(chains)} ({len(ragged)} ragged)")
    return problems


def compute_between_problems(schedule) -> list:
    """R1's compute-between half, from an overlapped pair's host schedule
    (``bucketing.overlap_log`` entries (event, unit or op, time)): every
    unit of the first averaging is issued before the second window's
    first local step; for each unit the second window dispatches a
    matmul-bearing op after the unit's issue and before its wait on it,
    except the units that its first such op itself waits for (the leaves
    that op reads: nothing of the window can run under them, in the
    reference's fused pair either); and one unit at least has such an op,
    or the pair ran one window after the other."""
    ev = [(e, w) for e, w, *_ in schedule]
    issued = {w: i for i, (e, w) in enumerate(ev) if e == "issue"}
    if not issued:
        return ["the pair's first averaging issued no unit beside the second window"]
    problems = []
    steps = [i for i, (e, _) in enumerate(ev) if e == "step"]
    if not steps:
        return ["the second window ran no local step while the first averaging was pending"]
    late = [w for w, i in issued.items() if i > steps[0]]
    if late:
        problems.append(f"units issued after the second window began (the host blocked): "
                        f"{late}")
    waits: dict = {}
    for i, (e, w) in enumerate(ev):
        if e == "wait":
            waits.setdefault(w, i)
    computes = [i for i, (e, _) in enumerate(ev) if e == "compute"]
    first = computes[0] if computes else len(ev)
    between = {w: sum(1 for c in computes if i < c < waits.get(w, len(ev)))
               for w, i in issued.items()}
    bare = [w for w in issued if not between[w] and waits.get(w, len(ev)) > first]
    if bare:
        problems.append(f"no compute between the issue of and the wait on {bare}")
    if not any(between.values()):
        problems.append(f"no unit of {sorted(issued)} has compute of the second window between "
                        "its issue and its wait: the windows ran one after the other")
    return problems


def gather_pair_problems(wire, *, payload_bytes: int, n_rows: int) -> list:
    """The int8 averaging's wire: ``all_gather`` only, an s8 payload and f32
    scales, ``n_rows`` (this rank's workers) × the compressed payload."""
    problems = []
    stray = [e for e in wire if e[0] != "all_gather"]
    if stray:
        problems.append(f"int8 averaging must ship all_gather only, found {_fmt(stray)}")
    ops = [e for e in wire if e[0] == "all_gather"]
    by: dict = {}
    for _, t, b, *_ in ops:
        by[t] = by.get(t, 0) + b
    if set(by) - {"s8", "f32"}:
        problems.append(f"int8 wire must be s8 payload + f32 scales, found dtypes {sorted(by)}")
    if ops and not by.get("s8"):
        problems.append(f"int8 wire ships no s8 bytes — the payload left the worker "
                        f"uncompressed (dtypes: {sorted(by)})")
    if len(ops) != 2:
        problems.append(f"expected the s8 and f32 all_gather pair, found {len(ops)} calls")
    total = sum(by.values())
    if total != n_rows * payload_bytes:
        problems.append(f"gathered bytes {total} != rows ({n_rows}) × compressed payload "
                        f"({payload_bytes})")
    return problems


def rule_collective_placement(prog: Program) -> list:
    """R1's findings."""
    spec = prog.expect.get("collectives")
    if spec is None:
        return []
    kind = spec["kind"]
    if kind == "none":
        return ([Finding("R1", prog.name, f"must be collective-free, found {_fmt(prog.wire)}")]
                if prog.wire else [])
    if kind == "window":
        problems = window_payload_problems(prog.wire, spec["expected_bytes"],
                                           by_dtype=spec["by_dtype"],
                                           opt_bytes=spec.get("opt_bytes"))
    elif kind == "ring":
        problems = ring_problems(prog.wire, n_hops=spec["n_hops"], n_chains=spec["n_chains"],
                                 hop_len=spec["hop_len"]) \
            + compute_between_problems(prog.schedule)
    elif kind == "gather_pair":
        problems = gather_pair_problems(prog.wire, payload_bytes=spec["payload_bytes"],
                                        n_rows=spec["n_rows"])
    else:
        raise ValueError(f"unknown R1 expectation kind {kind!r}")
    return [Finding("R1", prog.name, p) for p in problems]


# --------------------------------------------------------------------------
# R2 — buffer reuse
# --------------------------------------------------------------------------
def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    if t.device.type == "meta":
        return None
    return (str(t.device), t.untyped_storage().data_ptr())


def _unique_bytes(ts) -> int:
    seen, total = set(), 0
    for t in ts:
        k = _storage(t)
        if k is not None and k not in seen:
            seen.add(k)
            total += t.untyped_storage().nbytes()
    return total


class _Survivors:
    """Weak references to the consumed input's tensors, and what is left of
    them once the caller holds only ``out``."""

    def __init__(self, consumed):
        self.refs = []
        for i, tree in enumerate(consumed):
            for p, t in zip(tree_paths(tree), tree_leaves(tree)):
                if isinstance(t, torch.Tensor):
                    self.refs.append((f"arg{i}{p}", weakref.ref(t)))

    def _retained(self, out) -> list:
        keep_ids = {id(t) for t in _tensors(out)}
        keep_st = {_storage(t) for t in _tensors(out)} - {None}
        hits = []
        for p, r in self.refs:
            t = r()
            if t is not None and id(t) not in keep_ids and _storage(t) not in keep_st:
                hits.append((p, t.numel() * t.element_size()))
            del t
        return hits

    def problems(self, out) -> list:
        first = self._retained(out)
        if not first:
            return []
        gc.collect()
        still = self._retained(out)
        msgs = []
        if still:
            msgs.append(f"{len(still)} tensors of the consumed input ({sum(b for _, b in still)} "
                        f"B) are still alive once the caller holds only the outputs, e.g. "
                        f"{[p for p, _ in still[:3]]}")
        cyc = {p for p, _ in first} - {p for p, _ in still}
        if cyc:
            msgs.append(f"{len(cyc)} tensors of the consumed input stayed alive until the cyclic "
                        f"collector ran (a reference cycle held them), e.g. {sorted(cyc)[:3]}")
        return msgs


def storage_map(tree) -> dict:
    """Each tensor leaf's path → its storage (device, base pointer)."""
    return {p: _storage(t) for p, t in zip(tree_paths(tree), tree_leaves(tree))
            if isinstance(t, torch.Tensor)}


def moved_leaves(before: dict, out) -> list:
    """Paths of a donated state (``before``: its ``storage_map``) whose leaf
    the output state holds in other storage, or lacks."""
    st = out[0] if isinstance(out, tuple) else out
    after = storage_map(st)
    return [p for p, k in before.items() if after.get(p) != k]


def transient_peak_bound(new_bytes: int) -> float:
    """The most a donated program's transient peak may reach on the card."""
    return R2_PEAK_STATE_RATIO * new_bytes + R2_SLACK_BYTES


def rule_buffer_reuse(prog: Program) -> list:
    """R2: findings from the survivors, the donated state's storage and the
    card's allocated bytes."""
    out = [Finding("R2", prog.name, m) for m in (prog.retained or [])]
    if prog.moved:
        out.append(Finding("R2", prog.name,
                           f"{len(prog.moved)} leaves of the donated state came back in new "
                           f"storage (not written in place), e.g. {prog.moved[:3]}"))
    mem = prog.memory
    if mem is not None and mem["excess"] > R2_SLACK_BYTES:
        out.append(Finding("R2", prog.name,
                           f"{mem['excess']} B allocated beyond the caller's other tensors and "
                           f"the outputs ({mem['new_bytes']} B) after the program (slack "
                           f"{R2_SLACK_BYTES} B)"))
    if mem is not None and prog.expect.get("donated") \
            and mem["transient_peak"] > transient_peak_bound(mem["new_bytes"]):
        out.append(Finding("R2", prog.name,
                           f"the donated program peaked {mem['transient_peak']} B above what it "
                           f"left allocated, over {R2_PEAK_STATE_RATIO} x the new state's "
                           f"{mem['new_bytes']} B + {R2_SLACK_BYTES} B"))
    return out


# --------------------------------------------------------------------------
# R3 — host-sync and dtype lint
# --------------------------------------------------------------------------
_DATA_DEPENDENT = frozenset({
    "nonzero", "masked_select", "unique", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive", "bincount", "equal", "is_nonzero",
})
_REDUCTIONS = frozenset({"sum", "mean", "prod", "cumsum", "cumprod", "nansum", "nanmean",
                         "logsumexp", "norm", "linalg_vector_norm"})
_NARROW = (torch.bfloat16, torch.float16)
_HOST_READS = {"item": "host_sync", "__float__": "host_sync", "__int__": "host_sync",
               "__bool__": "host_sync", "__index__": "host_sync", "tolist": "host_sync",
               "numpy": "d2h", "cpu": "d2h"}


def _site_name(path: str, line: int) -> str:
    """``repro_torch/…/file.py:line`` inside the package, ``file.py:line``
    outside it."""
    f = os.path.abspath(path)
    if f.startswith(_PKG + os.sep):
        return f"{os.path.relpath(f, os.path.dirname(_PKG))}:{line}"
    return f"{os.path.basename(f)}:{line}"


def _site() -> str:
    """file:line of the innermost frame outside torch and this module."""
    for fr in reversed(traceback.extract_stack()[:-1]):
        f = os.path.abspath(fr.filename)
        if f == _SELF or f.startswith(_TORCH_DIR + os.sep) or f.endswith("contextlib.py"):
            continue
        return _site_name(f, fr.lineno)
    return "?"


def reduced_precision_allowed() -> list:
    """The cuBLAS reduced-precision reduction flags left on."""
    m = torch.backends.cuda.matmul
    return [n for n in ("allow_bf16_reduced_precision_reduction",
                        "allow_fp16_reduced_precision_reduction") if getattr(m, n)]


class _Lint:
    """R3's shared state: the taint of the program's inputs and the
    observations, one per (kind, site)."""

    def __init__(self, prog: Program, inputs):
        self.prog = prog
        self.taint = WeakIdKeyDictionary()
        for t in inputs:
            self.taint[t] = True
        self._seen = {(o["kind"], o["site"]) for o in prog.lint}

    def hot(self, t) -> bool:
        return isinstance(t, torch.Tensor) and (t.device.type == "cuda" or t in self.taint)

    def note(self, kind: str, op: str) -> None:
        site = _site()
        if (kind, site) not in self._seen:
            self._seen.add((kind, site))
            self.prog.lint.append({"kind": kind, "op": op, "site": site})


def _target_device(args, kwargs):
    if "device" in kwargs and kwargs["device"] is not None:
        return torch.device(kwargs["device"])
    for a in args[1:]:
        if isinstance(a, (str, torch.device)):
            return torch.device(a)
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class _FunctionLint(TorchFunctionMode):
    """Tensor methods that read a value to the host or copy to it."""

    def __init__(self, lint: _Lint):
        super().__init__()
        self.lint = lint

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        kind = _HOST_READS.get(name)
        if name == "to":
            dev = _target_device(args, kwargs)
            kind = "d2h" if dev is not None and dev.type == "cpu" else None
        if kind and args and self.lint.hot(args[0]):
            self.lint.note(kind, name)
        return func(*args, **kwargs)


class _DispatchLint(TorchDispatchMode):
    """The aten ops: float64, host reads, data-dependent shapes, copies to
    the host, narrow reductions; the taint carried to every output."""

    def __init__(self, lint: _Lint):
        super().__init__()
        self.lint = lint

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        lint = self.lint
        name = func.overloadpacket.__name__
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        hot = any(lint.hot(t) for t in ins)
        if hot:
            if name == "_local_scalar_dense":
                lint.note("host_sync", name)
            elif name in _DATA_DEPENDENT:
                lint.note("data_dependent", name)
            elif (name == "repeat_interleave" and func._overloadname != "self_int"
                  and kwargs.get("output_size") is None):
                lint.note("data_dependent", name)
            elif name == "index" and any(isinstance(i, torch.Tensor) and i.dtype in
                                         (torch.bool, torch.uint8) for i in args[1]):
                lint.note("data_dependent", "index[bool]")
        if name == "_to_copy" and ins and ins[0].device.type == "cuda" and \
                kwargs.get("device") is not None and torch.device(kwargs["device"]).type == "cpu":
            lint.note("d2h", name)
        elif name == "copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor) and \
                args[0].device.type == "cpu" and args[1].device.type == "cuda":
            lint.note("d2h", name)
        if name in _REDUCTIONS and kwargs.get("dtype") in _NARROW:
            lint.note("narrow_accumulation", f"{name}(dtype={kwargs['dtype']})")
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.dtype == torch.float64 for t in ins + outs):
            lint.note("f64", name)
        if hot:
            for t in outs:
                lint.taint[t] = True
        return out


_R3_TEXT = {
    "f64": "float64 value in a hot path (it doubles every buffer downstream)",
    "host_sync": "host read of a device value (a sync every step)",
    "data_dependent": "output shape depends on data (a device→host sync to size it)",
    "d2h": "copy to the host inside the program",
    "narrow_accumulation": "reduction accumulates below fp32",
    "reduced_precision": "cuBLAS reduced-precision reduction allowed while the program ran "
                         "(products must accumulate in fp32)",
}


def rule_host_sync(prog: Program):
    """R3: (findings, waived) — an observation whose site the program's
    ``expect["allow"]`` names is waived under that name."""
    allow = prog.expect.get("allow", {})
    findings, waived = [], []
    for o in prog.lint:
        name = allow.get(o["site"])
        if name:
            waived.append(("R3", prog.name, o["site"], name))
        else:
            findings.append(Finding("R3", prog.name,
                                    f"{_R3_TEXT[o['kind']]}: `{o['op']}` at {o['site']}"))
    return findings, waived


# --------------------------------------------------------------------------
# R4 — what is built or loaded
# --------------------------------------------------------------------------
def library_loads() -> int:
    """How many times this process has loaded the kernel library."""
    from repro_torch.kernels import _build
    return _build.load.cache_info().misses


def rule_recompile_budget(prog: Program) -> list:
    out = []
    if prog.library_loads > 1:
        out.append(Finding("R4", prog.name, f"the kernel library was loaded "
                           f"{prog.library_loads} times in this process (budget: once)"))
    want = prog.expect.get("chunk_shapes")
    if want is not None and set(prog.chunk_shapes or ()) != set(want):
        out.append(Finding("R4", prog.name,
                           f"the engine dispatched chunk shapes {sorted(prog.chunk_shapes or ())},"
                           f" budget says exactly {sorted(want)} — a shape leak re-plans the "
                           "hot path"))
    return out


# --------------------------------------------------------------------------
# R5 — static kernel checks
# --------------------------------------------------------------------------
def _k1():
    from repro_torch.kernels import auc_loss
    return auc_loss


def step_leaves(kernel: str, tree: str, K: int = 4) -> dict:
    """{sizes, codes} of one local step's K2 or K3 launch over a model's
    parameter leaves at K workers: ``tree`` is "arch", "arch:layers" or
    "arch:layers:bfloat16" (bf16 weights; fp32 norms and biases stay fp32;
    "mlp" is the launcher's default mlp), its leaves made on the meta
    device.  K3's buffers are fp32 (SM3's covers, an fp32 momentum) unless
    the tree ends in "+bf16buf"."""
    import dataclasses as dc

    from repro_torch.configs import get_config, mlp_config
    from repro_torch.kernels import opt_update, prox_update
    from repro_torch.models import model as M
    name, _, buf = tree.partition("+")
    arch, layers, dtype = (name.split(":") + ["", ""])[:3]
    cfg = mlp_config() if arch == "mlp" else get_config(arch)
    if layers:
        cfg = dc.replace(cfg, n_layers=int(layers))
    dt = getattr(torch, dtype or "float32")
    leaves = tree_leaves(M.init_params(cfg, dtype=dt, device="meta"))
    if kernel == "prox_update":
        codes = [prox_update.CODES[(l.dtype, l.dtype)] for l in leaves]
    else:
        bdt = torch.bfloat16 if buf == "bf16buf" else torch.float32
        codes = [opt_update.CODES[(l.dtype, bdt)] for l in leaves]
    return {"sizes": tuple(K * l.numel() for l in leaves), "codes": tuple(codes)}


def launch_record(kernel: str, shape: dict, *, impl: str = "auto", device: str = "cpu",
                  calls: int = 0, launched: int | None = None) -> KernelLaunch:
    """The launch record of one call shape, from the wrapper's own
    ``launch_geometry``.  ``shape``: auc_loss {K, T}; prox_update and
    opt_update {sizes, codes} of a step's leaves (or {tree}: a model's step,
    ``step_leaves``); flash_attention {B, S, H, KV, Skv, hd, dtype, aligned};
    grouped_matmul {N, Kd, G, F, dtype, tma_ok, strides (w's s_k, s_inner,
    s_outer in elements)}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import opt_update, prox_update
    kw = dict(impl=impl, device=device, calls=calls, launched=launched)
    if kernel == "auc_loss":
        g = _k1().launch_geometry(shape["K"], shape["T"])
        return KernelLaunch(kernel, g["kernel"], shape, (g["grid"][0], g["grid"][1], 1),
                            g["threads"], 0,
                            tiles={"rows a block (threads × rows a thread)":
                                   (g["rows_per_block"], g["threads"], None)}, **kw)
    if kernel in ("prox_update", "opt_update"):
        mod = prox_update if kernel == "prox_update" else opt_update
        if "tree" in shape:
            shape = dict(shape, **step_leaves(kernel, shape["tree"]))
        g = mod.launch_geometry(shape["sizes"], shape["codes"])
        shape = dict(shape, _query_keys={"launches": g["launches"]})
        tiles = {"leaves a launch (the table's capacity)":
                 (max(map(len, g["chunks"]), default=0), 1, g["max_leaves"])}
        return KernelLaunch(kernel, g["kernel"], shape, (g["grid"][0], 1, 1), g["threads"],
                            g["smem_bytes"], tiles=tiles, per_call=g["launches"], **kw)
    if kernel == "flash_attention":
        B, S, H, KV, Skv, hd = (shape[k] for k in ("B", "S", "H", "KV", "Skv", "hd"))
        dt = shape.get("dtype", torch.float32)
        g = fa.launch_geometry(B, S, H, KV, Skv, hd, dt, shape.get("aligned", True))
        e = torch.empty((), dtype=dt).element_size()
        tiles, boxes, strides = {}, (), ()
        q = {"bq": g["bq"], "bk": g["bk"], "stages": g.get("stages", 1)}
        if g["kernel"] == "flash_fwd":
            tiles = {"rows a block (16 thread rows × 4)": (g["bq"], 16, None)}
        else:
            tiles = {"wgmma M (rows a consumer warpgroup)":
                     (g["bq"] // g.get("consumers", 2), 64, None),
                     "wgmma N (keys of q·kᵀ)": (g["bk"], 8, 256)}
            if g["kernel"] in ("flash_fwd_wgmma", "flash_fwd_pingpong"):
                tiles["wgmma N (dims of P·V)"] = (hd, 8, 256)
                boxes = ((64, 1, 64, 1), g["tma_box"])
                strides = (hd * e, H * hd * e, S * H * hd * e)
            else:
                tiles["P·V in n64 products"] = (hd, 64, None)
                boxes = (g["tma_box"],)
            strides += (hd * e, KV * hd * e, Skv * KV * hd * e)
            q["tma_box"] = tuple(g["tma_box"])
        shape = dict(shape, _query_keys=q)
        return KernelLaunch(kernel, g["kernel"], shape, tuple(g["grid"]), g["threads"],
                            g["smem_bytes"], tiles=tiles, boxes=boxes, strides=strides, **kw)
    if kernel == "grouped_matmul":
        N, Kd, G, F = (shape[k] for k in ("N", "Kd", "G", "F"))
        dt = shape.get("dtype", torch.float32)
        g = md.launch_geometry(N, Kd, G, F, dt, shape.get("tma_ok", True))
        r, c = g["grid"]
        grid = (r, c, 1) if g["kernel"] == "gmm_rows" else (r * c, 1, 1)
        tiles, boxes, strides = {}, (), ()
        q = {"bm": g["bm"], "bn": g["bn"]}
        if g["kernel"] in ("gmm_wgmma", "gmm_wgmma_m128", "gmm_tf32x3"):
            if g["kernel"] == "gmm_wgmma":
                tiles = {"wgmma M (rows a tile)": (g["bm"], 64, None),
                         "wgmma N (columns a tile)": (g["bn"], 8, 256)}
            elif g["kernel"] == "gmm_wgmma_m128":     # two consumer warpgroups of 64 rows
                tiles = {"wgmma M (rows a consumer warpgroup)": (g["bm"] // 2, 64, 64),
                         "wgmma N (columns a tile)": (g["bn"], 8, 256)}
            else:        # the transposed product: columns on M, x rows on N
                tiles = {"wgmma M (columns a tile, 64 a consumer warpgroup)":
                         (g["bn"], 64, None),
                         "wgmma N (rows a tile)": (g["bm"], 8, 256)}
            e = torch.empty((), dtype=dt).element_size()
            boxes = g["tma_boxes"]
            s_k, s_inner, s_outer = shape.get("strides", (F, Kd * F, G * Kd * F))
            strides = (Kd * e, s_k * e, s_inner * e, s_outer * e)
            q["tma_boxes"] = tuple(tuple(b) for b in boxes)
        else:
            tiles = {"rows a tile (8-row steps)": (g["bm"], 8, None)}
        shape = dict(shape, _query_keys=q)
        return KernelLaunch(kernel, g["kernel"], shape, grid, g["threads"], g["smem_bytes"],
                            tiles=tiles, boxes=boxes, strides=strides, **kw)
    raise ValueError(f"unknown kernel {kernel!r}")


def kernel_query(rec: KernelLaunch) -> dict:
    """The geometry the kernel's own launch code reports for ``rec``'s
    shape (the built library; on the card)."""
    import ctypes

    from repro_torch.kernels import _build
    lib, s = _build.load(), rec.shape
    if rec.kernel == "auc_loss":
        out = (ctypes.c_longlong * 9)()
        if lib.coda_kernels_geometry(0, s["T"], s["K"], None, ctypes.addressof(out)) != 0:
            raise RuntimeError(f"coda_kernels_geometry refused {rec.name}")
        return {"grid": tuple(out[:3]), "threads": out[3], "smem_bytes": out[4]}
    if rec.kernel in ("prox_update", "opt_update"):
        out = (ctypes.c_longlong * 9)()
        rows = np.array(list(zip(s["sizes"], s["codes"])), dtype=np.int64).reshape(-1, 2)
        which = 1 if rec.kernel == "prox_update" else 2
        if lib.coda_kernels_geometry(which, len(rows), 0, rows.ctypes.data,
                                     ctypes.addressof(out)) != 0:
            raise RuntimeError(f"coda_kernels_geometry refused {rec.name}")
        return {"grid": tuple(out[:3]), "threads": out[3], "smem_bytes": out[4],
                "launches": out[5]}
    if rec.kernel == "flash_attention":
        out = (ctypes.c_int * 12)()
        vid = {"flash_fwd": 0, "flash_fwd_wgmma": 1, "flash_fwd_tf32x3": 2,
               "flash_fwd_pingpong": 3}[rec.variant]
        if lib.flash_attention_geometry(vid, s["hd"], s["B"], s["S"], s["H"], s["Skv"],
                                        ctypes.addressof(out)) != 0:
            raise RuntimeError(f"flash_attention_geometry refused {rec.name}")
        g = {"grid": tuple(out[:3]), "threads": out[3], "smem_bytes": out[4], "bq": out[5],
             "bk": out[6], "stages": out[7]}
        if rec.variant != "flash_fwd":
            g["tma_box"] = tuple(out[8:12])
        return g
    out = (ctypes.c_int * 13)()
    kid = {"gmm_rows": 0, "gmm_tiles": 1, "gmm_wgmma": 2, "gmm_tf32x3": 3,
           "gmm_wgmma_m128": 4}[rec.variant]
    bn = s["_query_keys"]["bn"]
    if lib.grouped_matmul_launch_geometry(kid, bn, s["N"], s["G"], s["F"],
                                          ctypes.addressof(out)) != 0:
        raise RuntimeError(f"grouped_matmul_launch_geometry refused {rec.name}")
    g = {"grid": tuple(out[:3]), "threads": out[3], "smem_bytes": out[4], "bm": out[5],
         "bn": out[6]}
    if rec.variant in ("gmm_wgmma", "gmm_wgmma_m128", "gmm_tf32x3"):
        g["tma_boxes"] = (tuple(out[7:9]), tuple(out[9:13]))
    return g


def launch_problems(rec: KernelLaunch) -> list:
    p = []
    if not 1 <= rec.threads <= MAX_THREADS:
        p.append(f"{rec.threads} threads a block (limit {MAX_THREADS})")
    if rec.smem_bytes > MAX_DYN_SMEM:
        p.append(f"{rec.smem_bytes} B of dynamic shared memory a block (limit {MAX_DYN_SMEM})")
    if len(rec.grid) != 3 or any(g < 1 for g in rec.grid):
        p.append(f"degenerate grid {rec.grid}")
    else:
        if rec.grid[0] > MAX_GRID_X:
            p.append(f"grid.x {rec.grid[0]} exceeds {MAX_GRID_X}")
        for axis, g in zip("yz", rec.grid[1:]):
            if g > MAX_GRID_YZ:
                p.append(f"grid.{axis} {g} exceeds {MAX_GRID_YZ}")
    for label, (value, multiple, most) in rec.tiles.items():
        if multiple and value % multiple:
            p.append(f"tile {label}: {value} is not a multiple of {multiple}")
        if most is not None and value > most:
            p.append(f"tile {label}: {value} exceeds {most}")
    for box in rec.boxes:
        if any(not 1 <= d <= MAX_TMA_BOX for d in box):
            p.append(f"TMA box {tuple(box)} has a dimension outside 1..{MAX_TMA_BOX}")
    for s in rec.strides:
        if s % TMA_STRIDE_ALIGN:
            p.append(f"TMA global stride {s} B is not a multiple of {TMA_STRIDE_ALIGN}")
    if rec.launched is not None:
        per_call = rec.per_call if rec.impl == "kernel" or (
            rec.impl == "auto" and rec.device == "cuda") else 0
        if rec.launched != per_call * rec.calls:
            p.append(f"impl={rec.impl!r} on {rec.device} tensors launched {rec.launched} "
                     f"kernels in {rec.calls} calls (the seam allows {per_call} a call)")
    if rec.query is not None:
        mine = rec.geometry()
        if {k: mine[k] for k in rec.query} != rec.query:
            p.append(f"the wrapper's launch_geometry {mine} is not the kernel's own "
                     f"{rec.query}")
    return p


def rule_kernel_static(rec: KernelLaunch) -> list:
    return [Finding("R5", rec.name, m) for m in launch_problems(rec)]


def dispatch_problems() -> list:
    """The dispatch seam, whatever the backend: "auto" launches for CUDA
    tensors only, "ref" never, "kernel" on a CPU tensor and an unknown impl
    raise."""
    from repro_torch.kernels import ops
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    problems = []
    if ops.dispatch("auto", cpu):
        problems.append('dispatch("auto") launches for CPU tensors')
    if not ops.dispatch("auto", cuda):
        problems.append('dispatch("auto") does not launch for CUDA tensors')
    if ops.dispatch("ref", cpu) or ops.dispatch("ref", cuda):
        problems.append('dispatch("ref") launches a kernel')
    for impl, dev in (("kernel", cpu), ("pallas", cpu), ("pallas", cuda), ("", cuda)):
        try:
            ops.dispatch(impl, dev)
        except ValueError:
            continue
        problems.append(f'dispatch({impl!r}) on {dev} did not raise')
    return problems


# --------------------------------------------------------------------------
# the recorders
# --------------------------------------------------------------------------
# K2's and K3's entry points besides their one-leaf wrappers: the
# multi-tensor launch over a step's leaves, and the plain version leaf by
# leaf that ``ops.prox_update_tree`` / ``ops.opt_update_tree`` take
_ENTRIES = {k: ((k, "kernel"), (f"{k}_multi", "kernel"), ("plain_multi", "ref"))
            for k in ("prox_update", "opt_update")}
_REF_FUNCS = {"auc_loss_ref": "auc_loss", "prox_update_ref": "prox_update",
              "opt_update_ref": "opt_update", "attention_full": "flash_attention",
              "attention_chunked": "flash_attention", "grouped_matmul_ref": "grouped_matmul"}


def _call_shape(kernel: str, a, kw) -> dict:
    if kernel == "auc_loss":
        return {"K": a[0].shape[0], "T": a[0].shape[1]}
    if kernel in ("prox_update", "opt_update"):
        from repro_torch.kernels import opt_update, prox_update
        # a step's lists of leaves (the multi-tensor wrappers, the plain
        # versions leaf by leaf) or one leaf
        cols = a[:4] if isinstance(a[0], (list, tuple)) else [[t] for t in a[:4]]
        if kernel == "prox_update":
            codes = [prox_update.CODES[(v.dtype, g.dtype)] for v, g in zip(cols[0], cols[1])]
        else:
            codes = [opt_update.CODES[(v.dtype, b.dtype)] for v, b in zip(cols[0], cols[3])]
        return {"sizes": tuple(v.numel() for v in cols[0]), "codes": tuple(codes)}
    if kernel == "flash_attention":
        q, k, v = a[:3]
        B, S, H, hd = q.shape
        aligned = all(not t.is_contiguous() or t.data_ptr() % 16 == 0 for t in (q, k, v))
        return {"B": B, "S": S, "H": H, "KV": k.shape[2], "Skv": k.shape[1], "hd": hd,
                "dtype": q.dtype, "aligned": aligned}
    from repro_torch.kernels import moe_dispatch as md
    x, w = a[0], a[1]
    _, _, s_outer, s_inner, s_k = md.weight_layout(w)
    G = md.weight_layout(w)[0]
    if w.dim() == 3:
        s_outer = G * s_inner
    return {"N": x.shape[0], "Kd": x.shape[1], "G": G, "F": w.shape[-1], "dtype": x.dtype,
            "tma_ok": md.tma_aligned(x, w) if x.device.type != "meta" else True,
            "strides": (s_k, s_inner, s_outer)}


def _geo_key(kernel, shape, impl, device):
    return (kernel, impl, device) + tuple(sorted((k, str(v)) for k, v in shape.items()))


@contextlib.contextmanager
def kernel_calls(sink: dict):
    """Record every call through the dispatch seam while the block runs:
    ``ops.dispatch`` notes the decision, the wrapper or plain function that
    follows takes it with the call's shape and the wrapper's launch-counter
    delta.  ``sink``: {key: [kernel, shape, impl, device, calls, launched,
    route mismatches]}."""
    from repro_torch.kernels import ops, ref
    pending: list = []
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    orig_dispatch = ops.dispatch

    def dispatch(impl, device):
        decision = orig_dispatch(impl, device)
        pending[:] = [(impl, device.type, decision)]
        return decision

    def wrap(kernel, route, fn, counter_mod):
        def call(*a, **kw):
            if not pending:
                return fn(*a, **kw)
            impl, dev, decision = pending.pop()
            before = counter_mod.launches
            out = fn(*a, **kw)
            shape = _call_shape(kernel, a, kw)
            key = _geo_key(kernel, shape, impl, dev)
            ent = sink.setdefault(key, [kernel, shape, impl, dev, 0, 0, 0])
            ent[4] += 1
            ent[5] += counter_mod.launches - before
            ent[6] += (route == "kernel") != decision
            return out
        return call

    mods = {"auc_loss": ops._auc_mod, "prox_update": ops._prox_mod,
            "opt_update": ops._opt_mod, "flash_attention": ops._fa_mod,
            "grouped_matmul": ops._moe_mod}
    try:
        patch(ops, "dispatch", dispatch)
        for kernel, mod in mods.items():
            for fname, route in _ENTRIES.get(kernel, ((kernel, "kernel"),)):
                patch(mod, fname, wrap(kernel, route, getattr(mod, fname), mod))
        for fname, kernel in _REF_FUNCS.items():
            patch(ref, fname, wrap(kernel, "ref", getattr(ref, fname), mods[kernel]))
        yield sink
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)


def launches_from_calls(sink: dict, *, query: bool = False) -> list:
    """One R5 record per (kernel, shape, impl, device) the calls made; with
    ``query``, each CUDA record carries the kernel's own geometry."""
    out = []
    for kernel, shape, impl, dev, calls, launched, mismatched in sink.values():
        rec = launch_record(kernel, shape, impl=impl, device=dev, calls=calls,
                            launched=launched)
        if mismatched:
            rec.launched = -1       # the route contradicted the seam's decision
        if query and dev == "cuda":
            rec.query = kernel_query(rec)
        out.append(rec)
    return out


def _inputs(args) -> list:
    return [t for a in args for t in _tensors(a)]


_WARM: list = []


def _warm_recorders() -> None:
    """The recorders' first use makes torch import lazily inside their
    handlers, and an exception caught there holds the caller's frames (and
    so its state) in a reference cycle, once.  A throwaway op pays for that
    before the first program."""
    if "recorders" in _WARM:
        return
    lint = _Lint(Program("warm-up"), [])
    x = torch.zeros(2, requires_grad=True)
    with _FunctionLint(lint), _DispatchLint(lint):
        torch.autograd.grad(torch.stack([x, x]).sum(), x)
    _WARM.append("recorders")


def _warm_device(device: torch.device) -> None:
    """A process's first matmuls on a card allocate cuBLAS's workspaces
    (tens of MB, kept for the process); pay for them before the first
    program's allocated bytes are read."""
    if ("device", str(device)) in _WARM:
        return
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones((2, 8, 8), dtype=dt, device=device, requires_grad=True)
        torch.autograd.grad(torch.bmm(x, x).sum() + (x[0] @ x[0]).sum(), x)
    torch.cuda.synchronize(device)
    _WARM.append(("device", str(device)))


def run_program(prog: Program, fn, args: list, *, consumed=(0,), query: bool = False):
    """Run ``fn(*args)`` once under every recorder and return its output.
    ``args`` is handed over: it is emptied after the call, so the caller
    must hold no other reference to the consumed arguments (``consumed``:
    their indices) for R2 to hold."""
    _warm_recorders()
    survivors = _Survivors([args[i] for i in consumed]) if consumed else None
    donated = storage_map(args[0]) if prog.expect.get("donated") else None
    on_card = next((t.device for t in _inputs(args) if t.device.type == "cuda"), None)
    if on_card is not None:
        _warm_device(on_card)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - _unique_bytes(
            [t for i in consumed for t in _tensors(args[i])])
        torch.cuda.reset_peak_memory_stats()
    lint = _Lint(prog, _inputs(args))
    flags = reduced_precision_allowed()
    bucketing.zero_collectives()
    sink: dict = {}
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with kernel_calls(sink), _FunctionLint(lint), _DispatchLint(lint):
            out = fn(*args)
        args.clear()
        prog.wire += list(bucketing.wire_log)
        prog.schedule += list(bucketing.overlap_log)
        for f in sorted(set(flags) | set(reduced_precision_allowed())):
            lint.note("reduced_precision", f)
        if survivors is not None:
            prog.retained = (prog.retained or []) + survivors.problems(out)
        if donated is not None:
            prog.moved = (prog.moved or []) + moved_leaves(donated, out)
    finally:
        if gc_on:
            gc.enable()
    if on_card is not None:
        torch.cuda.synchronize()
        new = _unique_bytes(t for t in _tensors(out) if t.device.type == "cuda")
        after = torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated()
        prog.memory = {"held_by_caller": held, "new_bytes": new, "allocated_after": after,
                       "excess": after - held - new, "peak_above_state": peak - held - new,
                       "transient_peak": peak - after}
    prog.launches += launches_from_calls(sink, query=query)
    prog.library_loads = library_loads()
    return out


def run_rules(programs, launches=(), *, rules=None, check_dispatch: bool = True) -> AuditReport:
    """Run the rules over captured programs and static launch records."""
    sel = set(rules) if rules is not None else {"R1", "R2", "R3", "R4", "R5"}
    rep = AuditReport([], [])
    for prog in programs:
        if "R1" in sel and "collectives" in prog.expect:
            rep.findings += rule_collective_placement(prog)
            rep.checked.append(("R1", prog.name))
        if "R2" in sel and (prog.retained is not None or prog.moved is not None
                            or prog.memory is not None):
            rep.findings += rule_buffer_reuse(prog)
            rep.checked.append(("R2", prog.name))
            if prog.memory is not None:
                rep.details[f"{prog.name}/memory"] = prog.memory
        if "R3" in sel:
            f, w = rule_host_sync(prog)
            rep.findings += f
            rep.waived += w
            rep.checked.append(("R3", prog.name))
        if "R4" in sel:
            rep.findings += rule_recompile_budget(prog)
            rep.checked.append(("R4", prog.name))
        if "R5" in sel:
            for rec in prog.launches:
                rep.findings += [Finding("R5", f"{prog.name}:{rec.name}", m)
                                 for m in launch_problems(rec)]
                rep.checked.append(("R5", f"{prog.name}:{rec.name}"))
                rep.details.setdefault("launches", []).append(launch_summary(rec))
    if "R5" in sel:
        for rec in launches:
            rep.findings += rule_kernel_static(rec)
            rep.checked.append(("R5", rec.name))
            rep.details.setdefault("launches", []).append(launch_summary(rec))
        if check_dispatch:
            rep.findings += [Finding("R5", "kernels.ops.dispatch", p) for p in dispatch_problems()]
            rep.checked.append(("R5", "kernels.ops.dispatch"))
    return rep


def launch_summary(rec: KernelLaunch) -> dict:
    shape = {k: (str(v) if isinstance(v, torch.dtype) else v) for k, v in rec.shape.items()
             if not k.startswith("_")}
    return {"kernel": rec.kernel, "variant": rec.variant, "shape": shape,
            "grid": list(rec.grid), "threads": rec.threads, "smem_bytes": rec.smem_bytes,
            "impl": rec.impl, "device": rec.device, "calls": rec.calls,
            "launched": rec.launched, "query_equal": None if rec.query is None
            else {k: rec.geometry()[k] for k in rec.query} == rec.query}


# --------------------------------------------------------------------------
# program registry: training executors
# --------------------------------------------------------------------------
def window_batch(mcfg, K: int, I: int, B: int, *, seed: int = 0, device="cpu", S: int = 0,
                 lead: tuple = ()) -> dict:
    """A window batch [*lead, I, K, B, ...] from ``seed``: the mlp's
    features (70 % positives, shifted by label, as the reference's audit
    draws them) or a language model's tokens [.., S]."""
    g = np.random.default_rng(seed)
    shp = lead + (I, K, B)
    y = (g.random(shp) < 0.7).astype(np.float32)
    if mcfg.family == "mlp":
        x = (g.standard_normal(shp + (mcfg.n_features,)) + 0.3 * (2 * y[..., None] - 1))
        inputs = {"features": torch.from_numpy(x.astype(np.float32))}
    else:
        inputs = {"tokens": torch.from_numpy(g.integers(0, mcfg.vocab_size, shp + (S,)))}
    out = dict(inputs, labels=torch.from_numpy(y))
    return {k: v.to(device) for k, v in out.items()}


def _alpha_batch(mcfg, K: int, m: int, *, seed: int, device, S: int):
    wb = window_batch(mcfg, K, 1, m, seed=seed, device=device, S=S)
    return {k: v[0] for k, v in wb.items()}


def _faults(ccfg, K: int, device, pair: bool = False):
    if not ccfg.faults_enabled:
        return None
    shape = (2, K) if pair else (K,)
    return {k: torch.ones(shape, dtype=torch.float32, device=device)
            for k in ("weights", "resync")}


def training_expectations(state, ccfg, *, wired: bool, k_loc: int, ring=None) -> dict:
    """R1 expectations of the training programs from the port's own
    accounting on ``state``: ``window``, ``stage`` and (``ring``, a
    ``bucketing.RingSpec``) ``pair``; the local-step body is always
    collective-free."""
    from repro_torch.core import coda
    masked = ccfg.faults_enabled
    out = {"local_steps": {"kind": "none"}}
    if not wired:
        out["window"] = {"kind": "none"}
    elif ccfg.avg_compress == "int8":
        out["window"] = {"kind": "gather_pair", "n_rows": k_loc,
                         "payload_bytes": coda.window_payload_bytes(state, "int8",
                                                                    masked=masked)}
    else:
        by = coda.window_payload_by_dtype(state, masked=masked)
        out["window"] = {"kind": "window", "by_dtype": by,
                         "expected_bytes": coda.window_payload_bytes(state, masked=masked)}
        ob = coda.opt_state_bytes(state)
        if ob:
            out["window"]["opt_bytes"] = ob
    sb = coda.stage_payload_bytes(ccfg)
    out["stage"] = ({"kind": "window", "expected_bytes": sb, "by_dtype": {"f32": sb}}
                    if wired and sb else {"kind": "none"})
    if ring is not None:
        sizes = {t: b["elements"] for t, b in bucketing.bucket_layout(state, masked=masked).items()}
        out["pair"] = {"kind": "ring", "n_hops": 2 * bucketing.ring_hop_count(sizes, ring),
                       "n_chains": 2 * bucketing.ring_chain_count(sizes, ring),
                       "hop_len": 2 * (ring.size - 1)}
    return out


def capture_vmap_programs(mcfg, ccfg, *, I: int = 2, B: int = 8, S: int = 0, seed: int = 0,
                          tag: str = "vmap", device="cpu", state=None, allow=None,
                          query: bool = False) -> list:
    """The batched executor's window and stage programs (R1: nothing on
    the wire — the workers are a batched tensor axis), each run once on a
    fresh state made from ``seed`` (or ``state``, handed over)."""
    from repro_torch.core import coda
    exe = coda.make_executor(mcfg, ccfg, "vmap")
    K = ccfg.n_workers
    if state is None:
        state = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(seed),
                                device=device)
    expect = {"collectives": {"kind": "none"}, "allow": dict(allow or {}),
              "donated": exe.donate}
    win = Program(f"{tag}/window", expect=dict(expect))
    fl = _faults(ccfg, K, device)
    args = [state, window_batch(mcfg, K, I, B, seed=seed, device=device, S=S), 0.1]
    del state
    st, _ = run_program(win, lambda s, wb, eta: exe.window_step(s, wb, eta, faults=fl), args,
                        query=query)
    stage = Program(f"{tag}/stage", expect=dict(expect))
    args = [st, _alpha_batch(mcfg, K, 2 * B, seed=seed + 1, device=device, S=S)]
    del st
    run_program(stage, exe.stage_end, args, query=query)
    return [win, stage]


def capture_sharded_programs(mcfg, ccfg, mesh, *, policy: str = "replica", I: int = 2,
                             B: int = 8, S: int = 0, seed: int = 0, tag: str = "sharded",
                             device="cpu", allow=None, local_steps_hook=None,
                             query: bool = False) -> list:
    """``core/coda_sharded.py`` on this rank: the local-step body
    (``communicate=False``, collective-free), the window, the overlapped
    pair (``overlap_chunks``) and the stage end, each run once.
    ``local_steps_hook(exe, state)`` runs inside every program's local
    steps when given (the red-team tests smuggle collectives through it)."""
    from repro_torch.core import coda
    exe = coda.make_executor(mcfg, ccfg, "shard_map", mesh=mesh, policy=policy)
    K = ccfg.n_workers
    whole = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(seed),
                            device=device)
    st = exe.place(whole)
    del whole
    k_loc = exe.rows.stop - exe.rows.start
    ring = exe._ring_spec()
    exp = training_expectations(st, ccfg, wired=bool(exe.worker_axes), k_loc=k_loc, ring=ring)
    allow = dict(allow or {})
    progs = []

    def program(name, fn, args):
        p = Program(f"{tag}/{name}", expect={"collectives": exp[name], "allow": allow,
                                             "donated": exe.donate})
        progs.append(p)
        return run_program(p, fn, args, query=query)

    def window(communicate):
        def fn(s, wb, eta):
            if local_steps_hook is not None:
                local_steps_hook(exe, s)
            return exe.window_step(s, wb, eta, communicate=communicate,
                                   faults=_faults(ccfg, K, device))
        return fn

    wb = lambda i: window_batch(mcfg, K, I, B, seed=seed + i, device=device, S=S)
    args = [st, wb(0), 0.1]
    del st
    st, _ = program("local_steps", window(False), args)
    args = [st, wb(1), 0.1]
    del st
    st, _ = program("window", window(True), args)
    if exe.overlap_pairs:
        args = [st, window_batch(mcfg, K, I, B, seed=seed + 2, device=device, S=S, lead=(2,)),
                0.1]
        del st
        st, _ = program("pair", lambda s, wb2, eta: exe.window_pair_step(
            s, wb2, eta, faults=_faults(ccfg, K, device, pair=True)), args)
    args = [st, _alpha_batch(mcfg, K, 2 * B, seed=seed + 3, device=device, S=S)]
    del st
    program("stage", exe.stage_end, args)
    return progs


def capture_training_programs(mcfg, ccfg, *, executor: str = "vmap", mesh=None,
                              policy: str = "replica", **kw) -> list:
    """Dispatch to the executor's capture (the registry's training half)."""
    if executor == "vmap":
        return capture_vmap_programs(mcfg, ccfg, **kw)
    if executor == "shard_map":
        if mesh is None:
            raise ValueError("shard_map capture needs a mesh")
        return capture_sharded_programs(mcfg, ccfg, mesh, policy=policy, **kw)
    raise ValueError(f"unknown executor {executor!r}")


# --------------------------------------------------------------------------
# program registry: serving
# --------------------------------------------------------------------------
def capture_serving_programs(cfg=None, *, params=None, slots: int = 2, max_len: int = 32,
                             prefill_chunk: int = 4, use_window: bool = True,
                             impl: str = "auto", tag: str = "serve", device="cpu",
                             prompts=None, max_new_tokens: int = 4, allow=None,
                             query: bool = False) -> list:
    """The engine's tick program (``ServingEngine._chunk_program``: one
    ``masked_chunk_step`` on device tensors, cut before its tokens go to
    the host) under a mixed workload: prompts longer than one chunk force
    prefill ticks (C = ``prefill_chunk``) and then decode-only ticks (C =
    1).  One program record per chunk shape, merged over its ticks; R2
    holds each tick's old cache dead once the engine holds the new one;
    R4 holds the engine to exactly the two shapes."""
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.tree import tree_map
    if cfg is None:
        from repro_torch.configs import get_smoke_config
        cfg = get_smoke_config("stablelm-1.6b")
    if params is None:
        params = tree_map(lambda x: x[None], M.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device=device))
    eng = E.ServingEngine(cfg, params, slots=slots, max_len=max_len, use_window=use_window,
                          impl=impl, prefill_chunk=prefill_chunk)
    del params
    progs: dict = {}
    seen: set = set()
    last: list = []                     # the previous tick's (program, survivors)
    inner = eng._chunk_program

    def tick(cache, toks, pos0, nst):
        C = toks.shape[1]
        seen.add(C)
        name = f"{tag}/{'prefill_chunk' if C == prefill_chunk else f'chunk_{C}'}"
        if C == 1:
            name = f"{tag}/decode_step"
        prog = progs.setdefault(name, Program(name, expect={"collectives": {"kind": "none"},
                                                            "allow": dict(allow or {})}))
        if last:                          # the engine now holds only `cache`
            p, surv = last.pop()
            p.retained = (p.retained or []) + surv.problems(cache)
        surv = _Survivors([cache])
        args = [cache, toks, pos0, nst]
        del cache
        out = run_program(prog, inner, args, consumed=(), query=query)
        last.append((prog, surv))
        return out

    eng._chunk_program = tick
    try:
        for uid in range(slots + 1):
            prompt = prompts[uid] if prompts is not None else [2 + uid, 3, 4, 5, 6, 7]
            eng.add_request(E.Request(uid=uid, prompt=list(prompt),
                                      max_new_tokens=max_new_tokens))
        eng.run()
    finally:
        # tick holds the engine's bound method: left in place, the engine
        # and its parameters would live on in a cycle until a collection
        del eng._chunk_program
    if last:
        p, surv = last.pop()
        p.retained = (p.retained or []) + surv.problems(eng.cache)
    out = list(progs.values())
    out.append(Program(f"{tag}/chunk_step_cache", chunk_shapes=seen,
                       expect={"chunk_shapes": {prefill_chunk, 1}},
                       library_loads=library_loads()))
    return out


# --------------------------------------------------------------------------
# program registry: the kernels seam
# --------------------------------------------------------------------------
# the reference's representative sizes (audit.py:955-956)
DEFAULT_SHAPES = {"moe": (64, 32, 4, 64), "auc": (300,), "prox": (1000,), "opt": (1000,),
                  "flash": (1, 256, 4, 2, 256, 64)}
# the paths' shapes of PERF.md §6 (static records: geometry only, no call)
PATH_SHAPES = [
    ("auc_loss", {"K": 4, "T": 32}), ("auc_loss", {"K": 8, "T": 4096}),
    ("auc_loss", {"K": 2, "T": 65536}),
    # K2/K3: a local step's leaves at K = 4 — the mlp's 6, ResNet50's 153,
    # bf16 stablelm-1.6b's 17 at 2 layers (bf16 matrices, fp32 norms),
    # ResNet50 with a bf16 momentum buffer — one leaf, and a table past
    # the capacity (two launches)
    ("prox_update", {"tree": "mlp"}), ("prox_update", {"tree": "resnet50"}),
    ("prox_update", {"tree": "stablelm-1.6b:2:bfloat16"}),
    ("prox_update", {"sizes": (9_437_184,), "codes": (0,)}),
    ("prox_update", {"sizes": (1000,) * 500, "codes": (0, 1, 2, 1) * 125}),
    ("opt_update", {"tree": "resnet50"}), ("opt_update", {"tree": "resnet50+bf16buf"}),
    ("opt_update", {"tree": "stablelm-1.6b:2:bfloat16"}),
    ("opt_update", {"sizes": (9_437_184,), "codes": (0,)}),
    ("flash_attention", {"B": 4, "S": 2048, "H": 32, "KV": 32, "Skv": 2048, "hd": 64}),
    ("flash_attention", {"B": 128, "S": 64, "H": 32, "KV": 32, "Skv": 64, "hd": 64}),
    ("flash_attention", {"B": 4, "S": 2048, "H": 32, "KV": 32, "Skv": 2048, "hd": 64,
                         "dtype": torch.bfloat16}),
    ("flash_attention", {"B": 128, "S": 64, "H": 32, "KV": 32, "Skv": 64, "hd": 64,
                         "dtype": torch.bfloat16}),
    ("flash_attention", {"B": 4, "S": 2048, "H": 32, "KV": 2, "Skv": 2048, "hd": 128}),
    ("flash_attention", {"B": 2, "S": 1024, "H": 48, "KV": 8, "Skv": 1024, "hd": 128}),
    ("flash_attention", {"B": 4, "S": 2048, "H": 40, "KV": 8, "Skv": 2048, "hd": 128,
                         "dtype": torch.bfloat16}),
    ("flash_attention", {"B": 2, "S": 1024, "H": 48, "KV": 8, "Skv": 1024, "hd": 128,
                         "dtype": torch.bfloat16}),
    ("flash_attention", {"B": 2, "S": 4096, "H": 25, "KV": 5, "Skv": 4096, "hd": 64}),
    ("flash_attention", {"B": 128, "S": 257, "H": 16, "KV": 8, "Skv": 257, "hd": 128}),
    ("flash_attention", {"B": 2, "S": 200, "H": 8, "KV": 2, "Skv": 200, "hd": 32}),
    ("grouped_matmul", {"N": 16, "Kd": 6144, "G": 16, "F": 10752}),
    ("grouped_matmul", {"N": 16, "Kd": 10752, "G": 16, "F": 6144}),
    ("grouped_matmul", {"N": 8192, "Kd": 6144, "G": 16, "F": 10752}),
    ("grouped_matmul", {"N": 8192, "Kd": 10752, "G": 16, "F": 6144}),
    # what TMA cannot read keeps the FFMA tiles: chip_smoke's unaligned cases
    ("grouped_matmul", {"N": 273, "Kd": 98, "G": 4, "F": 300, "tma_ok": False}),
    ("grouped_matmul", {"N": 273, "Kd": 96, "G": 4, "F": 302}),
    ("grouped_matmul", {"N": 8192, "Kd": 6144, "G": 16, "F": 10752, "dtype": torch.bfloat16}),
    ("grouped_matmul", {"N": 8192, "Kd": 10752, "G": 16, "F": 6144, "dtype": torch.bfloat16}),
    ("grouped_matmul", {"N": 16, "Kd": 6144, "G": 16, "F": 10752, "dtype": torch.bfloat16}),
    ("grouped_matmul", {"N": 8, "Kd": 7168, "G": 128, "F": 4864, "dtype": torch.bfloat16}),
    ("grouped_matmul", {"N": 4096, "Kd": 7168, "G": 128, "F": 4864, "dtype": torch.bfloat16}),
]


def _kernel_programs(impl: str, device, shapes: dict, dtype) -> list:
    """(name, fn, args, consumed) of one small call of each kernel."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g).to(device=device, dtype=dtype)
    N, Kd, E, F = shapes["moe"]
    (T,) = shapes["auc"]
    (n,) = shapes["prox"]
    (m,) = shapes["opt"]
    B, S, H, KV, Skv, hd = shapes["flash"]
    h = torch.rand((1, T), generator=g).to(device)
    y = (torch.rand((1, T), generator=g) < 0.5).float().to(device)
    duals = [torch.zeros(1, device=device) for _ in range(3)]
    seed = torch.zeros(1, dtype=torch.int64, device=device)
    buf = torch.zeros(m, device=device)
    return [
        ("grouped_matmul", lambda x, w, sizes: ops.grouped_matmul(x, w, sizes, impl=impl),
         [r(N, Kd), r(E, Kd, F), torch.tensor([N // E] * E, device=device)]),
        ("auc_loss", lambda hh, yy: ops.auc_loss(hh, yy, *duals, 0.7, impl=impl), [h, y]),
        ("prox_update", lambda v, gg, v0: ops.prox_update_tree(v, gg, v0, 0.1, 0.5, impl=impl),
         [r(n).float(), r(n).float(), r(n).float()]),
        ("opt_update[momentum]", lambda v, gg, v0: ops.opt_update(
            v, gg, v0, buf, 0.1, 0.5, 0.9, seed, mode="momentum", impl=impl),
         [r(m).float(), r(m).float(), r(m).float()]),
        ("opt_update[precond]", lambda v, gg, v0: ops.opt_update(
            v, gg, v0, buf, 0.1, 0.5, 1e-6, seed, mode="precond", impl=impl),
         [r(m).float(), r(m).float(), r(m).float()]),
        ("flash_attention", lambda q, k, v: ops.attention(q, k, v, causal=True, impl=impl),
         [r(B, S, H, hd), r(B, Skv, KV, hd), r(B, Skv, KV, hd)]),
    ]


def capture_kernel_launches(*, impl: str = "auto", shapes=None, device="cpu",
                            dtype=torch.float32, tag: str = "kernels", allow=None,
                            query: bool = False) -> tuple[list, list]:
    """Every kernel once through the seam at the reference's representative
    sizes (``shapes`` overrides), each call a program (R1–R5; R2: its
    operands die with the caller's references), and static R5 records at
    the paths' shapes of PERF.md §6.  Returns (programs, static launches)."""
    s = dict(DEFAULT_SHAPES)
    s.update(shapes or {})
    progs = []
    with torch.no_grad():
        for name, fn, args in _kernel_programs(impl, device, s, dtype):
            p = Program(f"{tag}/{name}", expect={"collectives": {"kind": "none"},
                                                 "allow": dict(allow or {})})
            progs.append(p)
            run_program(p, fn, args, consumed=tuple(range(len(args))), query=query)
    static = []
    for kernel, shape in PATH_SHAPES:
        rec = launch_record(kernel, shape, impl=impl)
        if query:
            rec.query = kernel_query(rec)
        static.append(rec)
    return progs, static


def site_of(module, needle: str) -> str:
    """``file:line`` of the first line of ``module``'s source that holds
    ``needle``: an expectation names a waived finding by the code it is
    about, and the name follows the code when lines move."""
    import inspect
    path = inspect.getsourcefile(module)
    for i, line in enumerate(inspect.getsource(module).splitlines(), 1):
        if needle in line:
            return _site_name(path, i)
    raise ValueError(f"{needle!r} is not in {path}")
