"""The port's GSPMD rules and analytic dry run against the reference's.

The specs of every parameter and CoDA-state leaf of the ten architectures'
full configs equal the reference's PartitionSpecs leaf by leaf (the
reference's trees from ``jax.eval_shape``, the port's on the ``meta``
device), on both abstract meshes and under both policies; the known
specs of ``tests/test_sharding.py``; every (arch × shape × mesh) record's
per-device argument bytes, state bytes, payload, parameter counts and
mem_pass's two records equal the reference's analytic values exactly;
the meta FLOP count equals an analytic 2·M·N·K count on one dense and one
moe smoke config (its ratio to XLA's ``cost_analysis`` printed, not held:
XLA also counts elementwise work); the sLSTM's one-position count times S
equals the whole loop."""
import contextlib
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs import input_specs as ref_input_specs
from repro.core import coda as RC
from repro.launch import mesh as RMESH
from repro.models import model as RM
from repro.serving import decode as RD
from repro.sharding import rules as RR
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.core import coda as PC
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as PM
from repro_torch.models import model as M
from repro_torch.sharding import rules as R

ROOT = pathlib.Path(__file__).resolve().parent.parent
BF16 = torch.bfloat16
KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)
MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}
PAIRS = [(a, s, m) for a in ASSIGNED_ARCHS for s in SHAPES for m in MESHES
         if not DR.is_skipped(a, s)]


def _meshes(name):
    shape, names = MESHES[name]
    return RMESH.abstract_mesh(shape, names), PM.abstract_mesh(shape, names)


def _key(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _port_specs(tree, specs) -> dict:
    flat = R.tree_with_paths(tree)
    return {_key(p): (s, tuple(l.shape)) for (p, l), (_, s) in zip(flat,
                                                                    R.spec_leaves(tree, specs))}


def _ref_specs(tree, specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shard = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: hasattr(x, "spec"))
    return {jax.tree_util.keystr(p): (tuple(s.spec if hasattr(s, "spec") else s), l.shape)
            for (p, l), s in zip(leaves, shard, strict=True)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    mcfg = ref_config(arch)
    return jax.eval_shape(lambda k: RM.init_params(k, mcfg, dtype=jnp.bfloat16), KEY)


@functools.lru_cache(maxsize=None)
def _ref_state(arch, K, use_window):
    mcfg = ref_config(arch)
    ccfg = RC.CoDAConfig(n_workers=K, param_dtype=jnp.bfloat16, use_window=use_window,
                         p_pos=0.71)
    return jax.eval_shape(lambda k: RC.init_state(k, mcfg, ccfg), KEY)


# ---------------------------------------------------------------------------
# specs leaf by leaf
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_state_specs_equal_the_reference(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    multi_pod = mesh == "pod2"
    params = M.init_params(get_config(arch), dtype=BF16, device="meta")
    rparams = _ref_params(arch)
    for policy in ("replica", "fsdp"):
        got = _port_specs(params, R.tree_shardings(params, pmesh, policy))
        rflat = jax.tree_util.tree_flatten_with_path(rparams)[0]
        want = {jax.tree_util.keystr(p): (tuple(RR.param_spec(p, l, rmesh, policy)), l.shape)
                for p, l in rflat}
        assert got == want, (arch, mesh, policy)
        K = RMESH.n_workers(rmesh, policy)
        state = PC.init_state(get_config(arch), PC.CoDAConfig(n_workers=K, param_dtype=BF16,
                                                              p_pos=0.71), device="meta")
        rstate = _ref_state(arch, K, False)
        got = _port_specs(state, R.state_shardings(state, pmesh, policy, multi_pod))
        want = _ref_specs(rstate, RR.state_shardings(rstate, rmesh, policy, multi_pod))
        assert got == want, (arch, mesh, policy, "state")


def test_known_specs_serving_layout():
    mesh = PM.abstract_mesh((1, 4, 2), ("pod", "data", "model"))
    params = M.init_params(get_config("qwen2.5-14b"), dtype=BF16, device="meta")
    specs = {_key(p): R.param_spec(p, l, mesh, "replica") for p, l in R.tree_with_paths(params)}
    assert specs["['layers']['attn']['wq']"] == tuple(P(None, None, "model"))
    assert specs["['layers']['attn']['wo']"] == tuple(P(None, "model", None))
    assert specs["['layers']['mlp']['w_down']"] == tuple(P(None, "model", None))
    assert specs["['embed']['table']"] == tuple(P("model", None))
    assert specs["['layers']['norm1']['scale']"] == tuple(P(None, None))


def test_moe_expert_parallel_specs_and_the_guard():
    mesh = PM.abstract_mesh((2, 4, 2), ("pod", "data", "model"))
    params = M.init_params(get_config("arctic-480b"), dtype=BF16, device="meta")
    specs = {_key(p): R.param_spec(p, l, mesh, "fsdp") for p, l in R.tree_with_paths(params)}
    assert specs["['layers']['moe']['w_gate']"] == (None, "data", None, "model")
    assert specs["['layers']['moe']['w_down']"] == (None, "data", "model", None)
    assert specs["['layers']['moe']['dense']['w_gate']"] == (None, "data", "model")
    assert specs["['layers']['moe']['router']"] == (None, None, None)
    mesh = PM.abstract_mesh((1, 4, 4), ("pod", "data", "model"))
    params = M.init_params(get_config("internvl2-2b"), dtype=BF16, device="meta")
    specs = {_key(p): R.param_spec(p, l, mesh, "replica") for p, l in R.tree_with_paths(params)}
    assert specs["['embed']['table']"][0] is None       # vocab 92553 % 4 != 0
    assert specs["['layers']['attn']['wq']"][-1] == "model"


def test_xlstm_list_layers_are_not_stacked():
    """A list index on the path means a per-layer leaf (no L axis)."""
    mesh = PM.abstract_mesh((16, 16), ("data", "model"))
    params = M.init_params(get_config("xlstm-350m"), dtype=BF16, device="meta")
    flat = R.tree_with_paths(params)
    path, leaf = next((p, l) for p, l in flat if p[-1] == "w_down" and isinstance(p[1], int))
    assert R.param_spec(path, leaf, mesh, "replica") == ("model", None)


def test_worker_count_policy():
    m1 = PM.make_production_mesh()
    m2 = PM.make_production_mesh(multi_pod=True)
    assert (PM.n_workers(m1, "replica"), PM.n_workers(m2, "replica")) == (16, 32)
    assert (PM.n_workers(m1, "fsdp"), PM.n_workers(m2, "fsdp")) == (1, 2)
    assert (m1.size, m2.size) == (256, 512)
    assert R.policy_for("dbrx-132b") == "fsdp" and R.policy_for("qwen2.5-14b") == "replica"
    assert R.worker_partition(m2, "replica", 32) == ("pod", "data")
    assert R.worker_partition(m1, "fsdp", 1) == ()


# ---------------------------------------------------------------------------
# every record's bytes against the reference's analytic values
# ---------------------------------------------------------------------------
def _ref_dev_bytes(tree, shardings, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    for l, (spec, _) in zip(jax.tree_util.tree_leaves(tree),
                            _ref_specs(tree, shardings).values()):
        n = l.dtype.itemsize
        for dim, axes in zip(l.shape, tuple(spec) + (None,) * (len(l.shape) - len(spec))):
            axes = () if axes is None else axes if isinstance(axes, tuple) else (axes,)
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n
    return total


def _nbytes(tree) -> int:
    return sum(math.prod(l.shape) * l.dtype.itemsize for l in jax.tree_util.tree_leaves(tree))


@functools.lru_cache(maxsize=None)
def _mem_pass():
    spec = importlib.util.spec_from_file_location("mem_pass", ROOT / "scripts" / "mem_pass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_record(arch, shape_name, mesh_name):
    rmesh, _ = _meshes(mesh_name)
    mcfg, shape = ref_config(arch), REF_SHAPES[shape_name]
    policy = RR.policy_for(arch)
    multi_pod = mesh_name == "pod2"
    use_window = shape_name == "long_500k" or mcfg.window_mode == "all_but_global"
    if shape.kind == "train":
        K = RMESH.n_workers(rmesh, policy)
        st = _ref_state(arch, K, use_window)
        batch = ref_input_specs(mcfg, shape, n_workers=K, window_steps=1)
        return {"state": _ref_dev_bytes(st, RR.state_shardings(st, rmesh, policy, multi_pod),
                                        rmesh),
                "batch": _ref_dev_bytes(batch, RR.batch_shardings(batch, rmesh, policy,
                                                                  multi_pod), rmesh),
                "state_bytes": _nbytes(st), "avg_coll_bytes": RC.window_payload_bytes(st)}
    params = _ref_params(arch)
    out = {"params": _ref_dev_bytes(params, RR.tree_shardings(params, rmesh, policy), rmesh)}
    if shape.kind == "prefill":
        batch = {k: jax.ShapeDtypeStruct(v.shape[2:], v.dtype)
                 for k, v in ref_input_specs(mcfg, shape).items() if k != "labels"}
        out["batch"] = _ref_dev_bytes(batch, RR.serve_shardings(batch, rmesh), rmesh)
        out["state_bytes"] = _nbytes(params)
    else:
        B, S = shape.global_batch, shape.seq_len
        cache = RD.cache_specs(mcfg, B, S, use_window=use_window, dtype=jnp.bfloat16)
        io = {"t": jax.ShapeDtypeStruct((B, 1), jnp.int32),
              "p": jax.ShapeDtypeStruct((B,), jnp.int32)}
        out["cache"] = _ref_dev_bytes(cache, RR.serve_shardings(cache, rmesh), rmesh)
        out["batch"] = _ref_dev_bytes(io, RR.serve_shardings(io, rmesh), rmesh)
        out["state_bytes"] = _nbytes(params) + _nbytes(cache)
    out["avg_coll_bytes"] = 0
    return out


@functools.lru_cache(maxsize=None)
def _ref_mem_pass(arch, shape_name):
    mp = _mem_pass()
    return mp.moe_dispatch_record(arch, shape_name), mp.optimizer_state_record(arch, shape_name)


@pytest.mark.parametrize("arch,shape,mesh", PAIRS, ids=[f"{a}-{s}-{m}" for a, s, m in PAIRS])
def test_record_bytes_equal_the_reference(arch, shape, mesh):
    _, pmesh = _meshes(mesh)
    got = DR.build_record(arch, shape, pmesh, flops=False)
    want = _ref_record(arch, shape, mesh)
    args = got["arg_bytes_per_device"]
    assert {k: args[k] for k in args if k != "total"} == {
        k: v for k, v in want.items() if k not in ("state_bytes", "avg_coll_bytes")}
    assert got["state_bytes"] == want["state_bytes"]
    assert got["avg_coll_bytes"] == want["avg_coll_bytes"]
    mcfg = ref_config(arch)
    assert got["n_params"] == RM.count_params(mcfg)
    assert got["n_params_active"] == RM.count_params(mcfg, active_only=True)
    md, od = _ref_mem_pass(arch, shape)
    assert got.get("moe_dispatch_bytes") == md
    assert got.get("optimizer_state_bytes") == od


def test_skipped_pair_and_the_cli():
    assert DR.run_pair("seamless-m4t-medium", "long_500k", multi_pod=False,
                       verbose=False)["status"] == "skipped"
    rec = DR.run_pair("stablelm-1.6b", "decode_32k", multi_pod=True, verbose=False)
    assert rec["status"] == "ok" and rec["roofline"]["bottleneck"] == "memory"
    assert rec["flops_per_device"] == rec["flops"] / 512
    assert "bytes accessed" not in rec and "memory" not in rec


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
def _analytic_prefill_flops(cfg, B, S) -> int:
    """2·M·N·K of every product of one replica's prefill: q, k, v, o, the
    scores and P·V over all S×S pairs (the plain attention's work), the
    mlp or the routed experts (T·k rows through gate, up and down) with the
    router, the last position's LM head and the score head."""
    T, d, hd = B * S, cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    attn = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d + 2 * 2 * B * H * S * S * hd
    if cfg.moe is None:
        ffn = 3 * 2 * T * d * cfg.d_ff
    else:
        k, E = cfg.moe.top_k, cfg.moe.n_experts
        ffn = 2 * T * d * E + 3 * 2 * T * k * d * cfg.d_ff
    return cfg.n_layers * (attn + ffn) + 2 * B * d * cfg.vocab_size + 2 * B * d


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "dbrx-132b"])
def test_meta_flops_equal_the_analytic_count(arch):
    cfg = get_smoke_config(arch)
    B, S = 2, 32
    got = DR.prefill_flops(cfg, B=B, S=S)
    assert got == _analytic_prefill_flops(cfg, B, S)
    # XLA's figure for the same smoke step, printed: it also counts
    # elementwise work, so the ratio is not held
    rcfg = ref_smoke_config(arch)
    params = jax.eval_shape(lambda k: RM.init_params(k, rcfg), KEY)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}   # one replica, no K axis
    ca = jax.jit(lambda p, b: RM.prefill_step(rcfg, p, b)).lower(params, batch).compile() \
        .cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    print(f"{arch} smoke prefill [{B}, {S}]: meta {got:.4e} FLOPs, XLA cost_analysis "
          f"{ca['flops']:.4e} (ratio {got / ca['flops']:.3f})")


@pytest.mark.parametrize("train", [False, True])
def test_slstm_one_position_times_s_equals_the_loop(train):
    from repro_torch.models import xlstm as X
    from repro_torch.models.embeddings import ParamInit
    cfg = get_smoke_config("xlstm-350m")
    K, B, S, d = 1, 2, 5, cfg.d_model
    init = ParamInit(torch.Generator(), BF16, "meta")

    def flops(patched):
        p = {k: v.expand((K,) + v.shape).requires_grad_(train)
             for k, v in X.init_slstm(cfg, init).items()}
        x = torch.empty((K, B, S, d), dtype=BF16, device="meta", requires_grad=train)
        ctx = DR.one_slstm_position() if patched else contextlib.nullcontext()
        with ctx, FlopCounterMode(display=False) as fc, torch.set_grad_enabled(train):
            out = X.apply_slstm(cfg, p, x)
            if train:
                torch.autograd.grad(out.float().sum(), [x] + list(p.values()))
        return fc.get_total_flops()

    step = DR.slstm_step_flops(cfg, K, B, train=train)
    assert step > 0
    assert flops(False) == flops(True) + (S - 1) * step
