"""The port's distributed executor (``core/coda_sharded.py`` on gloo ranks)
against the reference's own ``ShardedExecutor`` under shard_map.

One subprocess runs the reference on 4 forced host devices and writes one
npz for every case: the initial states, the windows, the fault vectors and
what its executor made of them.  jax 0.9's ``shard_map`` takes
``check_vma`` where the reference passes ``check_rep``, so that subprocess
wraps ``repro.core.coda_sharded._shard_map`` to rename the keyword (in the
subprocess only; ``src/repro`` is untouched).  The port then runs the same
cases on real gloo processes — one group of 4 ranks and one of 2, each
rank a subprocess meeting through a file store under ``tmp_path``, each
with a timeout — and rank 0 writes the gathered results.

Held, case by case (mlp 16→32, K = 4 unless named, I = 3, B = 8):
  * window states within fp32 atol 1e-6 + rtol 1e-5, losses within the
    fp32 tolerance; bf16 parameters under tests/test_torch_bf16.py's rule
    (the distance from the reference at most twice the reference's own
    bf16-vs-fp32 distance, plus one bf16 ulp), since the local steps' bf16
    arithmetic is torch's; the bf16 bucket average alone within one ulp;
  * the ring and int8 averages on the same bucket inputs bitwise the
    reference's ``ring_mean_buckets`` / ``ring_sum_buckets`` /
    ``int8_average`` under shard_map (the hops add in its order); the
    all_reduce mean and sum within the fp32 tolerance (gloo's reduction
    order is its own);
  * the collective counts exactly the reference's contract: none in the
    local steps, one all_reduce per dtype bucket a window with
    ``window_payload_by_dtype`` bytes, the int8 gather pair,
    ``ring_hop_count`` hops an averaging, one all_reduce a stage end, none
    on replicated partitions;
  * ``fit``'s history, rounds, iterations and exposed/overlapped bytes;
  * a crash-resume under the sharded executor bitwise the uninterrupted
    sharded run, and its checkpoint restored by the reference.
A 1-rank group (gloo here, NCCL on the card) holds the sharded window
bitwise the batched executor's.  The reference is imported inside the
tests that read it, so the card cases run where there is no jax:
``PYTHONPATH=src python -m pytest --noconftest -q -m cuda
tests/test_torch_sharded.py``.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as PCK
from repro_torch.configs import mlp_config
from repro_torch.core import bucketing as PB
from repro_torch.core import coda as PC
from repro_torch.launch import mesh as PM
from repro_torch.sharding import rules as PR
from repro_torch.tree import tree_leaves

from _torch_ranks import REFERENCE_UNDER_JAX_09, ROOT, TIMEOUT, env, run_ranks
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ATOL, RTOL = 1e-6, 1e-5

# (case, mesh, executor kwargs, CoDAConfig kwargs); the mesh is "r4" (4
# ranks, data=4), "r2" (2 ranks) or "pod" (4 ranks, pod=2 × data=2)
CASES = [
    ("plain_r4", "r4", {}, {}),
    ("plain_r2", "r2", {}, {}),
    ("k1_r4", "r4", {"K": 1}, {}),
    ("int8_r4", "r4", {}, {"avg_compress": "int8"}),
    ("overlap_r4", "r4", {"pair": True}, {"overlap_chunks": 2}),
    ("codasca_r4", "r4", {"windows": 2}, {"algorithm": "codasca"}),
    ("masked_r4", "r4", {"windows": 2}, {"participation": 0.5, "straggler_prob": 0.3,
                                         "max_staleness": 1, "fault_seed": 2}),
    ("masked_codasca_ring_r4", "r4", {"windows": 2, "pair": True},
     {"overlap_chunks": 2, "algorithm": "codasca", "participation": 0.75, "fault_seed": 5}),
    ("masked_int8_r4", "r4", {"windows": 2}, {"participation": 0.5, "avg_compress": "int8",
                                              "fault_seed": 1}),
    ("server_momentum_r4", "r4", {"windows": 2}, {"server_momentum": 0.9}),
    ("pod_replica_r4", "pod", {}, {}),
    ("pod_fsdp_r4", "pod", {"policy": "fsdp"}, {}),
    ("stage_end_r4", "r4", {"stage": True}, {}),
    ("bf16_r2", "r2", {}, {"param_dtype": "bf16", "algorithm": "codasca"}),
]
BF16_FACTOR, BF16_ULP = 2.0, 2.0 ** -7       # tests/test_torch_bf16.py's rule
BUCKETS = ("ring_mean", "ring_sum", "int8_k4", "int8", "pmean", "psum")
FIT_KW = dict(overlap_chunks=2)
RESUME_KW = dict(overlap_chunks=2, algorithm="codasca", participation=0.75, fault_seed=4)

_REFERENCE = REFERENCE_UNDER_JAX_09 + """
import sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import mlp_config
from repro.core import bucketing, coda, schedules
from repro.core.faults import FaultPlan

CASES, FIT_KW = json.loads(sys.argv[2]), json.loads(sys.argv[3])
SEEDS = {c[0]: i for i, c in enumerate(CASES)}
OUT, MCFG, I, B = {}, mlp_config(n_features=16, d=32), 3, 8
MESHES = {"r4": jax.make_mesh((4, 1), ("data", "model")),
          "r2": jax.make_mesh((2, 1), ("data", "model"), devices=jax.devices()[:2]),
          "pod": jax.make_mesh((2, 2, 1), ("pod", "data", "model"))}


def put(prefix, tree):
    for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(l)
        OUT[prefix + jax.tree_util.keystr(p)] = a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def draw(g, lead):
    y = (g.random(lead) < 0.7).astype(np.float32)
    x = (g.standard_normal(lead + (16,)) + 0.3 * (2 * y[..., None] - 1)).astype(np.float32)
    return {"features": x, "labels": y}


def faults(ccfg, w0, n):
    plan = FaultPlan.from_config(ccfg)
    us, rs = zip(*(plan.window(w0 + j) for j in range(n)))
    return {"weights": np.stack(us), "resync": np.stack(rs)}


def case(name, mesh, ex, kw):
    if kw.get("param_dtype") == "bf16":
        kw = dict(kw, param_dtype=jnp.bfloat16)
    ccfg = coda.CoDAConfig(n_workers=ex.get("K", 4), p_pos=0.7, **kw)
    st = coda.init_state(jax.random.PRNGKey(SEEDS[name]), MCFG, ccfg)
    put(f"{name}/init", st)
    if kw.get("param_dtype") is not None:   # the same windows in fp32, from the widened state
        wide = jax.tree_util.tree_map(
            lambda l: l.astype(jnp.float32) if l.dtype == jnp.bfloat16 else l, st)
        run(name, mesh, ex, dict(kw, param_dtype=jnp.float32), wide, "_fp32")
    run(name, mesh, ex, kw, st, "")


def run(name, mesh, ex, kw, st, tag):
    K, windows, pair = ex.get("K", 4), ex.get("windows", 1), ex.get("pair", False)
    ccfg = coda.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    exe = coda.make_executor(MCFG, ccfg, "shard_map", mesh=MESHES[mesh],
                             policy=ex.get("policy", "replica"), donate=False)
    st, losses = exe.place(st), []
    for w in range(windows):
        wb = draw(np.random.default_rng(100 * SEEDS[name] + w), ((2 if pair else 1) * I, K, B))
        put(f"{name}/wb{w}", wb)
        fl = None
        if ccfg.faults_enabled:
            fl = faults(ccfg, 2 * w if pair else w, 2 if pair else 1)
            put(f"{name}/fl{w}", fl)
        if pair:
            wb = {k: v.reshape((2, I) + v.shape[1:]) for k, v in wb.items()}
            st, l = exe.window_pair_step(st, wb, 0.1, faults=fl)
        else:
            fl = None if fl is None else {k: v[0] for k, v in fl.items()}
            st, l = exe.window_step(st, wb, 0.1, faults=fl)
        losses.append(np.asarray(l))
    OUT[f"{name}/losses{tag}"] = np.stack(losses)
    if ex.get("stage"):
        ab = draw(np.random.default_rng(999), (K, B))
        put(f"{name}/ab", ab)
        st = exe.stage_end(st, ab)
    put(f"{name}/out{tag}", st)


def buckets():
    g = np.random.default_rng(7)
    mats = [g.standard_normal((8, n)).astype(np.float32) for n in (5, 37, 1, 64)]
    mats.append(g.standard_normal((8, 19)).astype(jnp.bfloat16))
    for i, m in enumerate(mats):
        put(f"buckets/in{i}", m)
    ring = bucketing.RingSpec("data", 4, 3)
    fns = {"ring_mean": lambda ms: bucketing.ring_mean_buckets(ms, ring),
           "ring_sum": lambda ms: bucketing.ring_sum_buckets(ms, ring),
           "int8": lambda ms: bucketing.int8_average(ms, ("data",)),
           "int8_k4": lambda ms: bucketing.int8_average(ms, ("data",)),
           "pmean": lambda ms: bucketing.pmean_buckets(ms, ("data",)),
           "psum": lambda ms: bucketing.psum_buckets(ms, ("data",))}
    for name, f in fns.items():
        sm = _CS._shard_map(lambda *ms, f=f: tuple(f(list(ms))), mesh=MESHES["r4"],
                            in_specs=tuple(P("data") for _ in mats),
                            out_specs=tuple(P() for _ in mats), check_rep=False)
        rows = 4 if name.endswith("_k4") else 8
        for i, o in enumerate(jax.jit(sm)(*[jnp.asarray(m[:rows]) for m in mats])):
            put(f"buckets/{name}{i}", o)
    # the same 4 rows through the reference's arithmetic op by op (no jit)
    for i, o in enumerate(bucketing.int8_average([jnp.asarray(m[:4]) for m in mats], ())):
        put(f"buckets/int8_k4_eager{i}", o)


def fit():
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.7, **FIT_KW)
    sched = schedules.ScheduleConfig(n_workers=4, eta0=0.5, T0=6, I0=2, m0=16)
    key = jax.random.PRNGKey(3)
    put("fit/init", coda.init_state(key, MCFG, ccfg))
    g = np.random.default_rng(11)
    res = coda.fit(key, MCFG, ccfg, sched, 2,
                   sample_window=lambda k, i: draw(g, (i, 4, B)),
                   sample_alpha_batch=lambda k, m: draw(g, (4, m)), eval_every=2,
                   eval_fn=lambda st: float(np.asarray(st["params"]["score_head"]["w"])[0].sum()),
                   executor="shard_map", mesh=MESHES["r4"])
    OUT["fit/history"] = np.array(res.history, dtype=np.float64)
    OUT["fit/counters"] = np.array([res.comm_rounds, res.iterations, res.exposed_bytes,
                                    res.overlapped_bytes])
    put("fit/out", res.state)


buckets()
for name, mesh, ex, kw in CASES:
    case(name, mesh, ex, kw)
fit()
np.savez(sys.argv[1], **OUT)
print("REFERENCE OK", len(OUT))
"""

_RANK = """
import json, sys
import numpy as np
import torch
from repro_torch.configs import mlp_config
from repro_torch.core import bucketing as B, coda, schedules
from repro_torch.launch import mesh as M
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

rank, world, store, ref, out = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6]
CASES, FIT_KW, RESUME_KW = (json.loads(a) for a in sys.argv[6:9])
torch.set_num_threads(1)
M.init_rank("gloo", rank, world, "file://" + store, timeout_s=120)
REF, OUT, COUNTS = np.load(ref), {}, {}
MCFG, I, BATCH = mlp_config(n_features=16, d=32), 3, 8
MESHES = {"r4": M.make_worker_mesh(), "pod": M.make_worker_mesh(multi_pod=True)} if world == 4 \\
    else {"r2": M.make_worker_mesh()}


def arr(key, dtype=None):
    a = REF[key]
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load(prefix, like):
    return tree_unflatten(like, [arr(prefix + p, l.dtype).to(l.dtype)
                                 for p, l in zip(tree_paths(like), tree_leaves(like))])


def put(prefix, tree):
    for p, l in zip(tree_paths(tree), tree_leaves(tree)):
        l = l.detach().contiguous()
        OUT[prefix + p] = l.view(torch.int16).numpy().view(np.uint16) \\
            if l.dtype == torch.bfloat16 else l.numpy()


def counts():
    return {k: dict(v) for k, v in B.collectives.items()}


def config(K, kw):
    if kw.get("param_dtype") == "bf16":
        kw = dict(kw, param_dtype=torch.bfloat16)
    return coda.CoDAConfig(n_workers=K, p_pos=0.7, **kw)


def case(name, mesh, ex, kw):
    K, windows, pair = ex.get("K", 4), ex.get("windows", 1), ex.get("pair", False)
    ccfg = config(K, kw)
    exe = coda.make_executor(MCFG, ccfg, "shard_map", mesh=MESHES[mesh],
                             policy=ex.get("policy", "replica"))
    st = exe.place(load(f"{name}/init", coda.init_state(MCFG, ccfg)))
    assert exe.place(st) is st              # placing a placed state keeps it
    if name == "plain_r4":                  # the local steps alone
        B.zero_collectives()
        wb = {k: arr(f"{name}/wb0['{k}']") for k in ("features", "labels")}
        exe.window_step(st, wb, 0.1, communicate=False)
        COUNTS["local_steps"] = counts()
    B.zero_collectives()
    losses = []
    for w in range(windows):
        wb = {k: arr(f"{name}/wb{w}['{k}']") for k in ("features", "labels")}
        fl = None
        if ccfg.faults_enabled:
            fl = {k: arr(f"{name}/fl{w}['{k}']") for k in ("weights", "resync")}
        if pair:
            wb = {k: v.reshape((2, I) + v.shape[1:]) for k, v in wb.items()}
            st, l = exe.window_pair_step(st, wb, 0.1, faults=fl)
        else:
            fl = None if fl is None else {k: v[0] for k, v in fl.items()}
            st, l = exe.window_step(st, wb, 0.1, faults=fl)
        losses.append(l)
    if ex.get("stage"):
        st = exe.stage_end(st, {k: arr(f"{name}/ab['{k}']") for k in ("features", "labels")})
    COUNTS[name] = counts()
    put(f"{name}/out", exe.gather(st))
    OUT[f"{name}/losses"] = torch.stack(
        [exe.gather(l.transpose(0, 1)).transpose(0, 1) for l in losses]).numpy()
    if kw.get("param_dtype") == "bf16":    # the batched executor from the same whole state
        bt = coda.make_executor(MCFG, ccfg)
        whole = load(f"{name}/init", coda.init_state(MCFG, ccfg))
        for w in range(windows):
            whole, _ = bt.window_step(whole, {k: arr(f"{name}/wb{w}['{k}']")
                                              for k in ("features", "labels")}, 0.1)
        put(f"{name}/out_batched", whole)


def buckets():
    mats = [arr(f"buckets/in{i}", torch.bfloat16 if i == 4 else None) for i in range(5)]
    wire = B.Wire(MESHES["r4"].get_group("data"))
    ring = B.RingSpec(4, 3, wire)
    fns = {"ring_mean": lambda ms: B.ring_mean_buckets(ms, ring),
           "ring_sum": lambda ms: B.ring_sum_buckets(ms, ring),
           "int8": lambda ms: B.int8_average(ms, wire),
           "int8_k4": lambda ms: B.int8_average(ms, wire),
           "pmean": lambda ms: B.pmean_buckets(ms, wire),
           "psum": lambda ms: B.psum_buckets(ms, wire)}
    for name, f in fns.items():
        k_loc = 1 if name.endswith("_k4") else 2       # 4 or 8 rows over 4 ranks
        for i, o in enumerate(f([m[k_loc * rank:k_loc * (rank + 1)] for m in mats])):
            put(f"buckets/{name}{i}", o)


def draw(g, lead):
    y = (g.random(lead) < 0.7).astype(np.float32)
    x = (g.standard_normal(lead + (16,)) + 0.3 * (2 * y[..., None] - 1)).astype(np.float32)
    return {"features": torch.from_numpy(x), "labels": torch.from_numpy(y)}


class Crash(Exception):
    pass


def run_fit(ccfg, state, seed, crash_after=0, **kw):
    sched = schedules.ScheduleConfig(n_workers=4, eta0=0.5, T0=6, I0=2, m0=16)
    g, calls = np.random.default_rng(seed), [0]

    def sample_window(i):
        calls[0] += 1
        if crash_after and calls[0] > crash_after:
            raise Crash()
        return draw(g, (i, 4, BATCH))

    exe = coda.make_executor(MCFG, ccfg, "shard_map", mesh=MESHES["r4"])
    res = coda.fit(state, MCFG, ccfg, sched, 2, sample_window=sample_window,
                   sample_alpha_batch=lambda m: draw(g, (4, m)), executor=exe, rng=g, **kw)
    return res, exe


def fit():
    ccfg = config(4, FIT_KW)
    B.zero_collectives()
    res, exe = run_fit(ccfg, load("fit/init", coda.init_state(MCFG, ccfg)), 11, eval_every=2,
                       eval_fn=lambda st: float(st["params"]["score_head"]["w"][0].sum()))
    COUNTS["fit"] = counts()
    OUT["fit/history"] = np.array(res.history, dtype=np.float64)
    OUT["fit/counters"] = np.array([res.comm_rounds, res.iterations, res.exposed_bytes,
                                    res.overlapped_bytes])
    put("fit/out", exe.gather(res.state))


def resume():
    ccfg = config(4, RESUME_KW)
    init = coda.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(5))
    kw = dict(ckpt_every=1)
    whole, exe = run_fit(ccfg, init, 12, ckpt_dir=f"{out}/ckpt_whole", **kw)
    put("resume/whole", exe.gather(whole.state))
    try:
        run_fit(ccfg, init, 12, crash_after=4, ckpt_dir=f"{out}/ckpt", **kw)
        raise SystemExit("the sampler did not crash the run")
    except Crash:
        pass
    res, exe = run_fit(ccfg, init, 12, ckpt_dir=f"{out}/ckpt", resume=True, **kw)
    put("resume/resumed", exe.gather(res.state))
    for name, r in (("whole", whole), ("resumed", res)):
        OUT[f"resume/{name}_history"] = np.array(r.history, dtype=np.float64)
        OUT[f"resume/{name}_counters"] = np.array([r.comm_rounds, r.iterations,
                                                   r.exposed_bytes, r.overlapped_bytes])


if world == 4:
    buckets()
for name, mesh, ex, kw in CASES:
    if mesh in MESHES:
        case(name, mesh, ex, kw)
if world == 4:
    fit()
    resume()
if rank == 0:
    np.savez(f"{out}/port_r{world}.npz", **OUT)
    with open(f"{out}/counts_r{world}.json", "w") as f:
        json.dump(COUNTS, f)
M.dist.destroy_process_group()
print("RANK OK", rank)
# leave without the interpreter's teardown, where gloo's threads can abort
# the process ("terminate called without an active exception") after the
# rank has done all its work
sys.stdout.flush()
import os
os._exit(0)
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's npz, then the port's on 4 and on 2 gloo ranks."""
    out = tmp_path_factory.mktemp("sharded")
    cases = json.dumps(CASES)
    ref = subprocess.run(
        [sys.executable, "-c", "import json, os\nos.environ['XLA_FLAGS'] = "
         "'--xla_force_host_platform_device_count=4'\n" + _REFERENCE, str(out / "ref.npz"),
         cases, json.dumps(FIT_KW)], cwd=ROOT, env=env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert ref.returncode == 0 and "REFERENCE OK" in ref.stdout, ref.stderr[-4000:]
    for world in (4, 2):
        run_ranks(_RANK, world, out / f"store_r{world}", str(out / "ref.npz"), str(out), cases,
                  json.dumps(FIT_KW), json.dumps(RESUME_KW))
    counts = {}
    for world in (4, 2):
        with open(out / f"counts_r{world}.json") as f:
            counts.update(json.load(f))
    return {"ref": np.load(out / "ref.npz"), "port": {**np.load(out / "port_r4.npz"),
                                                       **np.load(out / "port_r2.npz")},
            "counts": counts, "dir": out}


def _keys(npz, prefix):
    return sorted(k for k in npz if k.startswith(prefix))


def _close(got, want, bf16: bool, what: str):
    if bf16:                                   # one bf16 ulp: adjacent bit patterns
        g, w = got.view(np.int16).astype(np.int32), want.view(np.int16).astype(np.int32)
        assert np.abs(g - w).max() <= 1, (what, np.abs(g - w).max())
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


def _params(mcfg_kw):
    return {"param_dtype": "bf16"} if mcfg_kw.get("param_dtype") == "bf16" else {}


def _f32(a):
    return (a.astype(np.uint32) << 16).view(np.float32) if a.dtype == np.uint16 else a


def _bf16_rule(got, want, want32, what):
    """|port − reference| ≤ 2·|reference bf16 − reference fp32| + one bf16
    ulp of max|reference fp32|."""
    p, r, f = _f32(got), _f32(want), _f32(want32)
    lim = BF16_FACTOR * float(np.abs(r - f).max()) + BF16_ULP * float(np.abs(f).max())
    assert float(np.abs(p - r).max()) <= lim, (what, float(np.abs(p - r).max()), lim)


@pytest.mark.parametrize("name,mesh,ex,kw", CASES, ids=[c[0] for c in CASES])
def test_window_states_match_the_reference_executor(results, name, mesh, ex, kw):
    """The window's (or pair's, or windows' and stage end's) state and
    losses on the port's gloo ranks against the reference's ShardedExecutor
    on the same inputs: fp32 atol 1e-6 + rtol 1e-5.  bf16 parameters: the
    local steps' bf16 arithmetic is torch's, not XLA's, so the port is held
    to the reference under the bf16 rule (its distance from the reference
    at most twice the reference's own bf16-vs-fp32 distance, plus one bf16
    ulp), and so to the port's batched executor from the same state: a bf16
    bucket's mean rounds at each rank's partial and at the wire's sum, as
    the reference's pmean does, where the batched mean rounds once (2 ulps
    seen).  The bf16 wire itself is held bitwise at the bucket level
    (``test_bucket_reductions_against_the_reference_under_shard_map``)."""
    ref, port = results["ref"], results["port"]
    keys = _keys(ref, f"{name}/out[")
    assert keys and keys == _keys(port, f"{name}/out[")
    bf16 = _params(kw)
    for k in keys:
        want, got = ref[k], port[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if bf16:
            want32 = ref[k.replace("/out", "/out_fp32")]
            _bf16_rule(got, want, want32, k)
            _bf16_rule(got, port[k.replace("/out", "/out_batched")], want32,
                       k + " vs the batched executor")
        else:
            _close(got, want, False, k)
    if bf16:
        _bf16_rule(port[f"{name}/losses"], ref[f"{name}/losses"], ref[f"{name}/losses_fp32"],
                   "losses")
    else:
        _close(port[f"{name}/losses"], ref[f"{name}/losses"], False, "losses")


def _payload(name, ex, kw, masked=False):
    """Bytes per dtype bucket one worker ships in a window of this case."""
    ccfg = PC.CoDAConfig(n_workers=ex.get("K", 4), p_pos=0.7,
                         **dict(kw, param_dtype=torch.bfloat16) if _params(kw) else kw)
    st = PC.init_state(mlp_config(n_features=16, d=32), ccfg)
    return st, PC.window_payload_by_dtype(st, masked=masked)


@pytest.mark.parametrize("name,mesh,ex,kw", CASES, ids=[c[0] for c in CASES])
def test_collectives_follow_the_reference_contract(results, name, mesh, ex, kw):
    """Exactly the reference's wire: per window one all_reduce per dtype
    bucket of ``window_payload_by_dtype`` bytes; int8 the s8 + f32 gather
    pair; rings ``ring_hop_count`` hops an averaging and no all_reduce; a
    stage end one all_reduce of its 4-byte α; nothing on a replicated
    partition (K = 1 on 4 ranks)."""
    got = results["counts"][name]
    windows = ex.get("windows", 1) * (2 if ex.get("pair") else 1)
    masked = "participation" in kw
    st, by_dtype = _payload(name, ex, kw, masked=masked)
    want = {k: {"calls": 0, "bytes": 0} for k in ("all_reduce", "all_gather", "p2p")}
    R = 2 if mesh == "r2" else 4
    if name == "k1_r4":
        pass                                          # replicated: no wire
    elif kw.get("avg_compress") == "int8":
        n_el = sum(l.numel() // l.shape[0] for l in PC._payload_leaves(st))
        n_leaves = len(PC._payload_leaves(st))
        lanes = 4 if masked else 0
        k_loc = 4 // R
        want["all_gather"] = {"calls": 2 * windows,
                              "bytes": windows * k_loc * (n_el + 4 * n_leaves + lanes)}
    elif kw.get("overlap_chunks"):
        sizes = {t: b["elements"] for t, b in PB.bucket_layout(st, masked=masked).items()}
        ring = PB.RingSpec(R, kw["overlap_chunks"])
        hops = PB.ring_hop_count(sizes, ring)
        chain = [PB._chunk_offsets(n, PB._n_chunks(n, ring)) for n in sizes.values()]
        hop_bytes = sum(-(-(hi - lo) // R) * 4 for offs in chain
                        for lo, hi in zip(offs[:-1], offs[1:])) * 2 * (R - 1)
        want["p2p"] = {"calls": windows * hops, "bytes": windows * hop_bytes}
    else:
        want["all_reduce"] = {"calls": windows * len(by_dtype),
                              "bytes": windows * sum(by_dtype.values())}
    if ex.get("stage"):
        want["all_reduce"]["calls"] += 1
        want["all_reduce"]["bytes"] += PC.stage_payload_bytes(PC.CoDAConfig(n_workers=4))
    assert {k: got[k] for k in want} == want


def test_local_steps_issue_no_collectives(results):
    """``window_step(communicate=False)``: the I local steps alone, on 4
    ranks, cross no wire at all."""
    assert all(v == {"calls": 0, "bytes": 0} for v in results["counts"]["local_steps"].values())


@pytest.mark.parametrize("what", BUCKETS)
def test_bucket_reductions_against_the_reference_under_shard_map(results, what):
    """The same [8, n] rows (four fp32 buckets' leaves and one bf16 leaf)
    reduced on 4 ranks (2 rows each; ``int8_k4``: the first 4 rows, one
    each).  The rings add hop by hop in the reference's order: bitwise.
    int8 gathers every row exactly, then takes the batched executor's mean:
    over 4 rows bitwise the reference's ``int8_average`` run op by op; its
    jitted shard_map, whose fused reduction XLA orders its own way, within
    the fp32 tolerance (1–2 ulps seen), as are 8 rows (torch's and XLA's
    8-row sums add in different orders: 1 ulp seen).  The all_reduce mean
    and sum add the ranks' partials in gloo's order, not XLA's: the fp32
    tolerance, bf16 one ulp."""
    ref, port = results["ref"], results["port"]
    for i in range(5):
        want, got = ref[f"buckets/{what}{i}"], port[f"buckets/{what}{i}"]
        assert got.dtype == want.dtype and got.shape == want.shape
        if what == "int8_k4":
            eager = ref[f"buckets/int8_k4_eager{i}"]
            assert np.array_equal(got.view(np.uint8), eager.view(np.uint8)), (what, i)
            _close(got, want, want.dtype == np.uint16, f"{what}{i}")
        elif what in ("ring_mean", "ring_sum"):
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), (what, i)
        else:
            _close(got, want, want.dtype == np.uint16, f"{what}{i}")


def test_fit_history_counters_and_state_match_the_reference(results):
    """``fit`` on 4 ranks with the overlapped pairs (2 stages: 3 and 9
    windows, so each stage ends in an unpaired window; an eval every 2nd
    window): the same (stage, iteration) history, losses and eval values at
    the fp32 tolerance, the same comm rounds, iterations, exposed and
    overlapped bytes, and the final state.  The wire: a ring per averaging
    of the 5 pairs, an all_reduce per unpaired window (2) and stage end
    (2)."""
    ref, port = results["ref"], results["port"]
    h_ref, h_port = ref["fit/history"], port["fit/history"]
    assert h_ref.shape == h_port.shape
    assert np.array_equal(h_ref[:, :2], h_port[:, :2])
    np.testing.assert_allclose(h_port[:, 2], h_ref[:, 2], atol=1e-5, rtol=1e-5)
    assert np.array_equal(ref["fit/counters"], port["fit/counters"])
    for k in _keys(ref, "fit/out"):
        _close(port[k], ref[k], False, k)
    c = results["counts"]["fit"]
    st = PC.init_state(mlp_config(n_features=16, d=32), PC.CoDAConfig(n_workers=4))
    sizes = {t: b["elements"] for t, b in PB.bucket_layout(st).items()}
    hops = PB.ring_hop_count(sizes, PB.RingSpec(4, 2))
    assert c["all_reduce"]["calls"] == 4 and c["all_gather"]["calls"] == 0
    assert c["p2p"]["calls"] == 5 * 2 * hops


def test_crash_resume_is_bitwise_under_the_sharded_executor(results):
    """CODASCA with faults and ring pairs on 4 ranks, a checkpoint after
    every window (pair): a run whose sampler raises at its 5th draw,
    resumed from its last checkpoint, ends bitwise the uninterrupted run:
    the whole state, the history and the counters."""
    port = results["port"]
    keys = _keys(port, "resume/whole[")
    assert keys
    for k in keys:
        assert np.array_equal(port[k].view(np.uint8),
                              port[k.replace("whole", "resumed")].view(np.uint8)), k
    for what in ("history", "counters"):
        assert np.array_equal(port[f"resume/whole_{what}"], port[f"resume/resumed_{what}"])


def test_sharded_checkpoint_restores_in_the_reference(results):
    """The crashed run's last checkpoint, written by rank 0 from the
    gathered state: the whole [K, ...] state in ``checkpoint.py``'s layout,
    which the reference's ``checkpoint.restore`` reads into its own state
    bitwise as the port's ``restore`` does."""
    import jax
    from repro.checkpoint import checkpoint as JCK
    from repro.configs.base import mlp_config as jmlp_config
    from repro.core import coda as JC
    d = str(results["dir"] / "ckpt")
    step = PCK.latest_step(d)
    assert step is not None and step == JCK.latest_step(d)
    kw = dict(RESUME_KW)
    tmpl = JC.init_state(jax.random.PRNGKey(0), jmlp_config(n_features=16, d=32),
                         JC.CoDAConfig(n_workers=4, p_pos=0.7, **kw))
    theirs = JCK.restore(d, step, {"state": tmpl})["state"]
    ours = PCK.restore(d, step, {"state": PC.init_state(
        mlp_config(n_features=16, d=32), PC.CoDAConfig(n_workers=4, p_pos=0.7, **kw))})["state"]
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(tree_leaves(ours))
    for (p, a), b in zip(flat, tree_leaves(ours)):
        assert a.shape[0] == 4 and np.array_equal(np.asarray(a), b.numpy()), \
            jax.tree_util.keystr(p)


# --------------------------------------------------------------------------
# one rank: the sharded window is the batched executor's, bitwise
# --------------------------------------------------------------------------
ONE_RANK = [
    {}, {"avg_compress": "int8"}, {"algorithm": "codasca", "participation": 0.75,
                                   "straggler_prob": 0.2, "fault_seed": 3},
    {"param_dtype": torch.bfloat16}, {"overlap_chunks": 4},
]


def _one_rank_window(rank, kw, dev):
    """One window (and a stage end) from the same state through both
    executors on a one-rank group: (max |difference| over every leaf,
    collectives)."""
    from repro_torch.core.faults import FaultPlan
    mcfg = mlp_config(n_features=16, d=32)
    ccfg = PC.CoDAConfig(n_workers=4, p_pos=0.7, **kw)
    st = PC.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(1), device=dev)
    g = torch.Generator().manual_seed(2)
    y = (torch.rand((3, 4, 8), generator=g) < 0.7).float()
    wb = {"features": torch.randn((3, 4, 8, 16), generator=g).to(dev), "labels": y.to(dev)}
    fl = None
    if ccfg.faults_enabled:
        fl = {k: torch.from_numpy(v).to(dev)
              for k, v in zip(("weights", "resync"), FaultPlan.from_config(ccfg).window(0))}
    exe = PC.make_executor(mcfg, ccfg, "shard_map", mesh=PM.make_host_mesh())
    batched = PC.make_executor(mcfg, ccfg)
    PB.zero_collectives()
    if exe.overlap_pairs:                      # a pair against two windows
        a, _ = exe.window_pair_step(exe.place(st), {k: torch.stack([v, v]) for k, v in
                                                    wb.items()}, 0.1)
    else:
        a, _ = exe.window_step(exe.place(st), wb, 0.1, faults=fl)
    a = exe.stage_end(a, {k: v[0] for k, v in wb.items()})
    comms = {k: dict(v) for k, v in PB.collectives.items()}
    b, _ = batched.window_step(st, wb, 0.1, faults=fl)
    if exe.overlap_pairs:
        b, _ = batched.window_step(b, wb, 0.1)
    b = PC.stage_end(mcfg, ccfg, b, {k: v[0] for k, v in wb.items()}, resync=False)
    diff = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    return same, diff, comms, PC.window_payload_by_dtype(st, masked=fl is not None) \
        if not kw.get("avg_compress") \
        else None


def _check_one_rank(kw, backend, dev):
    same, diff, comms, by_dtype = PM.run_ranks(_one_rank_window, 1, (kw, dev), backend=backend,
                                               timeout_s=120)
    assert same, f"max |sharded − batched| = {diff}"
    if kw.get("avg_compress"):
        assert comms["all_gather"]["calls"] == 2
    elif kw.get("overlap_chunks"):            # a ring of one rank has no hop
        assert comms["p2p"]["calls"] == 0 and comms["all_reduce"]["calls"] == 1
    else:
        assert comms["all_reduce"]["calls"] == len(by_dtype) + 1
        assert comms["all_reduce"]["bytes"] == sum(by_dtype.values()) + 4


@pytest.mark.parametrize("kw", ONE_RANK, ids=lambda kw: ",".join(kw) or "plain")
def test_one_rank_window_is_the_batched_executors_bitwise(kw):
    """At R = 1 the only new arithmetic is a reduction over one rank: the
    sharded window, its stage end and its collectives on a one-rank gloo
    group, bitwise the batched executor's."""
    _check_one_rank(kw, "gloo", "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", ONE_RANK, ids=lambda kw: ",".join(kw) or "plain")
def test_one_rank_nccl_window_is_the_batched_executors_bitwise(kw):
    """The same on the card: NCCL at R = 1, every bucket's all_reduce a real
    NCCL launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda)")
    _check_one_rank(kw, "nccl", "cuda")


# --------------------------------------------------------------------------
# which rows a rank holds: the reference's rules on the same meshes
# --------------------------------------------------------------------------
class _Mesh:
    """The two DeviceMesh reads ``rules`` makes, for a given rank."""
    def __init__(self, shape, names, rank):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)
        self._coord = np.unravel_index(rank, shape)

    def get_coordinate(self):
        return [int(c) for c in self._coord]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("policy", ["replica", "fsdp"])
def test_worker_partition_and_rows_follow_the_reference(policy, multi_pod):
    """``n_workers`` and ``worker_partition`` equal the reference's for K in
    1..8 on 1, 2, 4 and 8 ranks; every rank's rows tile [0, K) in worker
    order (rank-major over the worker axes), or are all K when the axis is
    replicated."""
    from repro.launch import mesh as JM
    from repro.sharding import rules as JR
    for R in (1, 2, 4, 8):
        if multi_pod and R % 2:
            continue
        shape = (2, R // 2, 1) if multi_pod else (R, 1)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        ref_mesh = JM.abstract_mesh(shape, names)
        assert PM.n_workers(_Mesh(shape, names, 0), policy) == JM.n_workers(ref_mesh, policy)
        for K in range(1, 9):
            meshes = [_Mesh(shape, names, r) for r in range(R)]
            wa = PR.worker_partition(meshes[0], policy, K)
            assert wa == JR.worker_partition(ref_mesh, policy, K), (R, K)
            rows = [PR.worker_rows(m, policy, K) for m in meshes]
            if not wa:
                assert all(r == slice(0, K) for r in rows)
                continue
            n = int(np.prod([dict(zip(names, shape))[a] for a in wa]))
            blocks = sorted({(r.start, r.stop) for r in rows})
            assert blocks == [(i * K // n, (i + 1) * K // n) for i in range(n)], (R, K, blocks)
