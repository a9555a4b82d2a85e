"""Analytic dry run of every (architecture × input shape × mesh), the
counterpart of ``repro.launch.dryrun`` with what ``scripts/mem_pass.py``
and ``scripts/sweep_dryrun.py`` add to its records.

The reference lowers and compiles each step for the production meshes
and reads XLA's ``cost_analysis`` and ``memory_analysis``.  Here the step
that its ``build_lowering`` builds runs once on the ``meta`` device
(shapes only, nothing allocated, ``impl="ref"`` passed explicitly) with
bf16 parameters:

  train_4k     → ``coda.window_step`` (a local primal-dual step + the average)
  prefill_32k  → ``model.prefill_step``
  decode_32k   → ``decode.serve_step`` (one token against a 32k cache)
  long_500k    → ``decode.serve_step`` (dense archs through their sliding
                 window; skipped for seamless-m4t-medium, as the reference
                 skips it)

and each record holds:

  * ``n_params``, ``n_params_active`` (``count_params``) and
    ``state_bytes`` (the whole step's state: the CoDA state for train, the
    parameters for prefill, parameters and caches for decode);
  * ``arg_bytes_per_device``: the step's arguments laid out by the GSPMD
    rules of ``sharding/rules.py`` on the reference's two meshes (abstract
    here: (16, 16) over (data, model), (2, 16, 16) over (pod, data,
    model)) — params or CoDA state, batch, and the KV / SSM / xLSTM caches
    of ``decode.cache_specs``;
  * ``avg_coll_bytes``: the window's payload a worker
    (``coda.window_payload_bytes`` on the meta state);
  * ``flops`` of the whole step (every worker) from
    ``torch.utils.flop_counter.FlopCounterMode`` over the meta step, and
    ``flops_per_device`` (that over the mesh's chips).  Two parts are
    counted analytically because ``meta`` cannot run them: the MoE sorted
    dispatch's group sizes depend on the routing, so each grouped GEMM
    counts 2·N·Kd·F for its N = T·k routed rows — every routed row passes
    once through the gate, up and down products, as the sorted dispatch
    does its work; and the sLSTM, a Python loop over positions, runs one
    position, whose count (forward, and backward for train) is multiplied
    by S, as the reference's ``slstm_flop_correction`` adds S − 1 steps;
  * mem_pass's two analytic records: ``moe_dispatch_bytes`` (eval shapes
    of the moe archs: the capacity [E, C = T, d] buffer against the sorted
    [T·k, d] one, bf16) and ``optimizer_state_bytes`` (train shapes:
    momentum, sm3 and shampoo_blocked state a worker in fp32 and bf16);
  * ``roofline``: the H100 terms of ``analysis/roofline.py`` over
    ``flops_per_device``, ``min_hbm_bytes`` and ``avg_coll_bytes``.

There is no counterpart of XLA's ``bytes accessed`` or of
``memory_analysis()``'s temp and peak bytes: nothing is compiled, so those
fields are left out, and the memory term reads the per-device argument
bytes under ``min_hbm_bytes``, a lower bound (every argument read once).
``repro/flags.py`` has no counterpart either: each of its knobs shapes
XLA's tracing (unrolled scans, chunk caps under unrolling, a GSPMD
constraint for the hill climb), and the meta step traces nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out PATH]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.roofline import H100, roofline_terms
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, input_specs
from repro_torch.launch import mesh as MESH
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves, tree_map

BF16 = torch.bfloat16


def is_skipped(arch: str, shape_name: str) -> str:
    if shape_name == "long_500k" and arch == "seamless-m4t-medium":
        return ("quadratic enc/cross attention over 512k frames; no published "
                "sub-quadratic variant for this arch")
    return ""


def spec_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


# --------------------------------------------------------------------------
# analytic FLOPs of what meta cannot run
# --------------------------------------------------------------------------
@contextlib.contextmanager
def analytic_grouped_matmul(counter: list):
    """While the block runs, every grouped GEMM of the sorted MoE dispatch
    returns a meta tensor of its output's shape and adds 2·N·Kd·F to
    ``counter[0]`` (its rows' sizes are data: meta has none)."""
    from repro_torch.kernels import ops
    orig = ops.grouped_matmul

    def gmm(x, w, group_sizes, *, impl="auto"):
        if x.device.type != "meta":
            raise ValueError("the analytic grouped GEMM counts meta tensors only")
        counter[0] += 2 * x.shape[0] * x.shape[1] * w.shape[-1]
        return x.new_empty((x.shape[0], w.shape[-1]))

    ops.grouped_matmul = gmm
    try:
        yield counter
    finally:
        ops.grouped_matmul = orig


def slstm_step_flops(cfg, K: int, B: int, dtype=BF16, *, train: bool = False) -> int:
    """FLOPs of one sLSTM position for K workers of B rows (the cell's
    recurrent einsum; with ``train`` its backward too), counted on meta."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.embeddings import ParamInit
    d = cfg.d_model
    init = ParamInit(torch.Generator(), dtype, "meta")
    p = tree_map(lambda t: t.expand((K,) + t.shape), X.init_slstm(cfg, init))
    carry = tuple(t.expand(K, B, d) for t in X.init_slstm_state(cfg, B, d, device="meta"))
    u = torch.empty((K, B, 4 * d), dtype=dtype, device="meta", requires_grad=train)
    with FlopCounterMode(display=False) as fc, torch.set_grad_enabled(train):
        carry = tuple(c.requires_grad_(train) if train else c for c in
                      (t.clone() for t in carry))
        r = X._recurrent(p, carry[2]).detach().requires_grad_(train)
        _, h = X._slstm_cell(carry, u, r)
        if train:
            torch.autograd.grad(h.float().sum(), [u, r] + list(carry), allow_unused=True)
    return fc.get_total_flops()


@contextlib.contextmanager
def one_slstm_position():
    """While the block runs, an sLSTM layer steps one position and repeats
    its output over the sequence (shapes and the first step's FLOPs; the
    other S − 1 positions are added from ``slstm_step_flops``)."""
    from repro_torch.models import xlstm as X
    orig = X.apply_slstm

    def apply_slstm(cfg, p, x):
        K, B, S, d = x.shape
        u = X._slstm_inputs(p, x)
        carry = tuple(t.expand(K, B, d) for t in X.init_slstm_state(cfg, B, d, device=x.device))
        _, h = X._slstm_cell(carry, u[:, :, 0], X._recurrent(p, carry[2]))
        return X.linear(torch.stack([h] * S, dim=2), p["w_out"])

    X.apply_slstm = apply_slstm
    try:
        yield
    finally:
        X.apply_slstm = orig


def n_slstm_layers(cfg) -> int:
    if cfg.family != "ssm" or cfg.slstm_every <= 0:
        return 0
    return sum(1 for i in range(cfg.n_layers) if i % cfg.slstm_every == cfg.slstm_every - 1)


def count_flops(cfg, fn, *, K: int, B: int, S: int, train: bool) -> int:
    """FLOPs of ``fn()`` on meta, with the MoE and sLSTM parts counted
    analytically (see the module docstring)."""
    counter = [0]
    with analytic_grouped_matmul(counter), one_slstm_position(), \
            FlopCounterMode(display=False) as fc:
        fn()
    total = fc.get_total_flops() + counter[0]
    n = n_slstm_layers(cfg)
    if n and S > 1:
        total += (S - 1) * n * slstm_step_flops(cfg, K, B, train=train)
    return total


# --------------------------------------------------------------------------
# the records
# --------------------------------------------------------------------------
def moe_dispatch_record(arch: str, shape_name: str):
    """mem_pass's dispatch-buffer record: None for non-moe archs and train
    shapes (training dispatches by capacity)."""
    from repro_torch.models import moe
    cfg, spec = get_config(arch), SHAPES[shape_name]
    if cfg.moe is None or spec.kind == "train":
        return None
    T = moe.tokens_per_forward(spec)
    cap = moe.dispatch_buffer_bytes(cfg, T, mode="capacity", dtype=BF16)
    srt = moe.dispatch_buffer_bytes(cfg, T, mode="sorted", dtype=BF16)
    return {"tokens": T, "capacity_bytes": cap, "sorted_bytes": srt, "ratio": cap / srt}


def optimizer_state_record(arch: str, shape_name: str):
    """mem_pass's optimizer-state record a worker (train shapes only), from
    the meta state of 8 workers."""
    from repro_torch.core import coda
    if SHAPES[shape_name].kind != "train":
        return None
    mcfg = get_config(arch)
    out = {}
    for opt in ("momentum", "sm3", "shampoo_blocked"):
        per = {}
        for name, dt in (("fp32", torch.float32), ("bf16", BF16)):
            ccfg = coda.CoDAConfig(n_workers=8, optimizer=opt, opt_dtype=dt)
            per[name] = coda.opt_state_bytes(coda.init_state(mcfg, ccfg, device="meta"))
        per["bf16_reduction"] = round(per["fp32"] / max(1, per["bf16"]), 2)
        out[opt] = per
    return out


def _replica(tree):
    """One replica's leaves with the leading K = 1 axis the port's steps take."""
    return tree_map(lambda t: t[None], tree)


def prefill_flops(cfg, *, B: int, S: int, dtype=BF16) -> int:
    """FLOPs of one replica's ``prefill_step`` over [B, S] tokens on meta."""
    from repro_torch.models import model as M
    params = _replica(M.init_params(cfg, dtype=dtype, device="meta"))
    batch = {"tokens": torch.empty((1, B, S), dtype=torch.int64, device="meta")}
    return count_flops(cfg, lambda: M.prefill_step(cfg, params, batch, impl="ref"), K=1, B=B,
                       S=S, train=False)


def param_record(arch: str, mesh, *, policy: str | None = None, n_layers: int = 0,
                 dtype=BF16) -> dict:
    """The parameter bytes one device holds under the serving specs
    (``tree_shardings`` without a worker axis), and their total, for the
    config (depth cut to ``n_layers`` when given)."""
    import dataclasses

    from repro_torch.models import model as M
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    params = M.init_params(cfg, dtype=dtype, device="meta")
    specs = R.tree_shardings(params, mesh, policy or R.policy_for(arch))
    return {"arch": arch, "n_layers": cfg.n_layers, "param_bytes": spec_bytes(params),
            "param_bytes_per_device": R.device_bytes(params, specs, mesh)}


def build_record(arch: str, shape_name: str, mesh, *, policy: str | None = None,
                 flops: bool = True) -> dict:
    """One (arch, shape, mesh) record (see the module docstring); without
    ``flops`` the meta step is not run (the bytes alone)."""
    from repro_torch.core import coda
    from repro_torch.models import model as M
    from repro_torch.serving import decode as D
    mcfg, shape = get_config(arch), SHAPES[shape_name]
    sizes = MESH.axis_sizes(mesh)
    multi_pod = "pod" in sizes
    policy = policy or R.policy_for(arch)
    use_window = shape_name == "long_500k" or mcfg.window_mode == "all_but_global"
    n_chips = mesh.size
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "policy": policy,
           "n_chips": n_chips, "use_window": use_window, "status": "ok"}
    args: dict = {}
    if shape.kind == "train":
        K = MESH.n_workers(mesh, policy)
        ccfg = coda.CoDAConfig(n_workers=K, param_dtype=BF16, use_window=use_window,
                               p_pos=0.71, impl="ref")
        state = coda.init_state(mcfg, ccfg, device="meta")
        batch = input_specs(mcfg, shape, n_workers=K, window_steps=1)
        args["state"] = R.device_bytes(state, R.state_shardings(state, mesh, policy, multi_pod),
                                       mesh)
        args["batch"] = R.device_bytes(batch, R.batch_shardings(batch, mesh, policy,
                                                                multi_pod), mesh)
        step = lambda: coda.window_step(mcfg, ccfg, state, batch, 0.1)
        count = dict(K=K, B=shape.global_batch // K, S=shape.seq_len, train=True)
        rec.update(n_workers=K, step_kind="coda_window", state_bytes=spec_bytes(state),
                   tokens_per_step=shape.global_batch * shape.seq_len,
                   avg_coll_bytes=coda.window_payload_bytes(state))
    else:
        params = M.init_params(mcfg, dtype=BF16, device="meta")
        args["params"] = R.device_bytes(params, R.tree_shardings(params, mesh, policy), mesh)
        if shape.kind == "prefill":
            full = input_specs(mcfg, shape, n_workers=1, window_steps=1)
            batch = {k: v[0, 0] for k, v in full.items() if k != "labels"}
            args["batch"] = R.device_bytes(batch, R.serve_shardings(batch, mesh), mesh)
            step = lambda: M.prefill_step(mcfg, _replica(params),
                                          {k: v[None] for k, v in batch.items()},
                                          use_window=use_window, impl="ref")
            count = dict(K=1, B=shape.global_batch, S=shape.seq_len, train=False)
            rec.update(step_kind="prefill", state_bytes=spec_bytes(params),
                       tokens_per_step=shape.global_batch * shape.seq_len)
        else:
            B, S = shape.global_batch, shape.seq_len
            cache = D.cache_specs(mcfg, B, S, use_window=use_window, dtype=BF16)
            io = input_specs(mcfg, shape)
            args["cache"] = R.device_bytes(cache, R.serve_shardings(cache, mesh), mesh)
            args["batch"] = R.device_bytes(io, R.serve_shardings(io, mesh), mesh)
            step = lambda: D.serve_step(mcfg, _replica(params), cache, io["tokens"],
                                        io["positions"], use_window=use_window, impl="ref")
            count = dict(K=1, B=B, S=1, train=False)
            rec.update(step_kind="decode", tokens_per_step=B,
                       state_bytes=spec_bytes(params) + spec_bytes(cache))
        rec["avg_coll_bytes"] = 0
    rec["arg_bytes_per_device"] = dict(args, total=sum(args.values()))
    rec["min_hbm_bytes"] = rec["arg_bytes_per_device"]["total"]
    rec["n_params"] = M.count_params(mcfg)
    rec["n_params_active"] = M.count_params(mcfg, active_only=True)
    md = moe_dispatch_record(arch, shape_name)
    if md is not None:
        rec["moe_dispatch_bytes"] = md
    od = optimizer_state_record(arch, shape_name)
    if od is not None:
        rec["optimizer_state_bytes"] = od
    if flops:
        rec["flops"] = count_flops(mcfg, step, **count)
        rec["flops_per_device"] = rec["flops"] / n_chips
        rec["roofline"] = dict(roofline_terms(rec["flops_per_device"], rec["min_hbm_bytes"],
                                              rec["avg_coll_bytes"], 1), hardware=H100.name)
    return rec


def run_pair(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True) -> dict:
    """One record, or a skipped or failed one (a failure is a bug in the
    port, recorded with its trace)."""
    skip = is_skipped(arch, shape_name)
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if skip:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "skipped",
               "reason": skip}
        if verbose:
            print(f"[dryrun] {tag}: SKIPPED ({skip.split(';')[0]})", flush=True)
        return rec
    t0 = time.perf_counter()
    try:
        rec = build_record(arch, shape_name, MESH.make_production_mesh(multi_pod=multi_pod))
    except Exception as e:
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "FAILED",
               "error": f"{type(e).__name__}: {e}", "trace": traceback.format_exc()[-2000:]}
        if verbose:
            print(f"[dryrun] {tag}: FAILED {e}", flush=True)
        return rec
    rec["seconds"] = round(time.perf_counter() - t0, 2)
    if verbose:
        print(f"[dryrun] {tag}: ok flops/device={rec['flops_per_device']:.3e} "
              f"args/device={rec['min_hbm_bytes']:.3e} avg_coll={rec['avg_coll_bytes']:.3e} "
              f"bound={rec['roofline']['bottleneck']} ({rec['seconds']} s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list(ASSIGNED_ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="every assigned arch and shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", metavar="PATH", help="write the records here as JSON lines "
                    "(default: stdout only)")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --arch and/or --shape, or --all")
    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.perf_counter()
    records = [run_pair(a, s, multi_pod=mp) for a in archs for s in shapes for mp in meshes]
    failed = [r for r in records if r["status"] == "FAILED"]
    if args.out:
        with open(args.out, "w") as fh:
            for r in records:
                fh.write(json.dumps(r) + "\n")
    else:
        for r in records:
            print(json.dumps(r))
    print(f"[dryrun] {len(records)} records, {len(failed)} failed, "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
