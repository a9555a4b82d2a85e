"""repro_torch.core.coda vs repro.core.coda, mirroring tests/test_coda.py.

The same numpy inputs go through both packages; the reference's initial
state is carried across with ``repro_torch.params``.  Tolerances:

  * one local step / one window / stage_end / averaging: atol 1e-5 — fp32
    matmuls and reductions summed in another order, a few steps deep;
  * the whole slice (``fit``, 32 local steps over 2 stages): losses rtol
    1e-4 (atol 1e-6 where a loss crosses zero), final parameters atol
    1e-4, test AUC atol 1e-3 (a near-tied pair may swap ranks);
  * ResNet-tiny local step: atol 1e-4 (convolution sums in another order);
  * byte accounting and schedule counters: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import baselines as JB
from repro.core import coda as JC
from repro.core import objective as JO
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_smoke_config, mlp_config
from repro_torch.core import coda as C
from repro_torch.core import objective as O
from repro_torch.core import schedules as S
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

JMCFG = jax_mlp_config(n_features=16, d=32)
MCFG = mlp_config(n_features=16, d=32)


def _window(seed, I, K, B, p=0.7, nf=16):
    rng = np.random.default_rng(seed)
    y = (rng.random((I, K, B)) < p).astype(np.float32)
    x = rng.standard_normal((I, K, B, nf)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": x, "labels": y}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(K, seed, mcfg=MCFG, jmcfg=JMCFG, **kw):
    """(reference config, reference numpy state, port config, port state)
    from the same initial weights."""
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    jst = _np(JC.init_state(jax.random.PRNGKey(seed), jmcfg, jccfg))
    return jccfg, jst, ccfg, P.state_from_jax(mcfg, ccfg, jst)


def _assert_state_close(port, ref, mcfg=MCFG, atol=1e-5):
    got = P.state_to_jax(mcfg, port)
    for field in ("params", "duals", "ref_params", "ref_duals"):
        gl, rl = jax.tree_util.tree_leaves(got[field]), jax.tree_util.tree_leaves(ref[field])
        assert len(gl) == len(rl), field
        for g, r in zip(gl, rl):
            np.testing.assert_allclose(g, np.asarray(r), atol=atol, err_msg=field)


def _spread(state):
    return max(float((l - l[0:1]).abs().max()) for l in tree_leaves(state["params"]))


def test_local_step_matches_reference():
    jccfg, jst, ccfg, st = _pair(4, 0)
    wb = _window(0, 1, 4, 8)
    jstep = jax.jit(lambda s_, b_: JC.local_step(JMCFG, jccfg, s_, b_, 0.1))
    jnew, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, jst),
                        _j({k: v[0] for k, v in wb.items()}))
    new, loss = C.local_step(MCFG, ccfg, st, _t({k: v[0] for k, v in wb.items()}), 0.1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-5)
    _assert_state_close(new, _np(jnew))


@pytest.mark.parametrize("I", [1, 4])
def test_window_step_matches_reference(I):
    jccfg, jst, ccfg, st = _pair(3, 1)
    wb = _window(1, I, 3, 8)
    jnew, jl = JC.window_step(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                              _j(wb), 0.05)
    new, losses = C.window_step(MCFG, ccfg, st, _t(wb), 0.05)
    assert losses.shape == (I,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=1e-5)
    _assert_state_close(new, _np(jnew))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_average_matches_reference(compress):
    """Average a state whose workers have drifted apart (3 local steps with
    no communication), plain and int8-compressed."""
    jccfg, jst, ccfg, _ = _pair(4, 2)
    jdrift, _ = JC.window_step(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                               _j(_window(2, 3, 4, 8)), 0.1, communicate=False)
    jdrift = _np(jdrift)
    drift = P.state_from_jax(MCFG, ccfg, jdrift)
    got = C.average(drift, compress=compress)
    want = _np(JC.average(jax.tree_util.tree_map(jnp.asarray, jdrift), compress=compress))
    _assert_state_close(got, want, atol=1e-6)


def test_average_syncs_workers():
    _, _, ccfg, st = _pair(4, 0)
    st2, _ = C.window_step(MCFG, ccfg, st, _t(_window(0, 3, 4, 8)), 0.1,
                           communicate=False)
    assert _spread(st2) > 1e-6  # local steps diverge across workers
    st3 = C.average(st2)
    assert _spread(st3) < 1e-7
    m2 = st2["params"]["score_head"]["w"].mean(0)
    m3 = st3["params"]["score_head"]["w"].mean(0)
    torch.testing.assert_close(m2, m3, rtol=0, atol=1e-7)


def test_window_equals_manual_steps():
    """window_step(I) must equal I explicit local_steps + one average."""
    _, _, ccfg, st0 = _pair(2, 1)
    wb = _t(_window(1, 4, 2, 8))
    out1, _ = C.window_step(MCFG, ccfg, st0, wb, 0.05)
    st_m = st0
    for i in range(4):
        st_m, _ = C.local_step(MCFG, ccfg, st_m, {k: v[i] for k, v in wb.items()}, 0.05)
    st_m = C.average(st_m)
    for a, b in zip(tree_leaves(out1), tree_leaves(st_m)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_k1_is_ppd_sg():
    """With K=1, averaging is a no-op: CoDA reduces to PPD-SG exactly."""
    _, _, ccfg, st0 = _pair(1, 2)
    wb = _t(_window(2, 3, 1, 8))
    with_avg, _ = C.window_step(MCFG, ccfg, st0, wb, 0.05, communicate=True)
    without, _ = C.window_step(MCFG, ccfg, st0, wb, 0.05, communicate=False)
    for a, b in zip(tree_leaves(with_avg), tree_leaves(without)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_i1_is_np_ppd_sg():
    """Three I=1 windows of the port match the reference's NP-PPD-SG
    baseline (average after every local step) step for step."""
    jccfg, jst, ccfg, st = _pair(4, 3)
    wb = _window(3, 3, 4, 8)
    for i in range(3):
        st, _ = C.window_step(MCFG, ccfg, st, _t({k: v[i:i + 1] for k, v in wb.items()}),
                              0.05)
    want, _ = JB.np_ppd_sg_window(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                                  _j(wb), 0.05)
    _assert_state_close(st, _np(want))


@pytest.mark.parametrize("resync", [False, True])
def test_stage_end_matches_reference(resync):
    jccfg, jst, ccfg, st = _pair(4, 4)
    jst1, _ = JC.window_step(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                             _j(_window(4, 2, 4, 16)), 0.1, communicate=not resync)
    jst1 = _np(jst1)
    st1 = P.state_from_jax(MCFG, ccfg, jst1)
    ab = {k: v[0] for k, v in _window(5, 1, 4, 64).items()}
    got = C.stage_end(MCFG, ccfg, st1, _t(ab), resync=resync)
    want = JC.stage_end(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst1), _j(ab),
                        resync=resync)
    _assert_state_close(got, _np(want))
    alpha = got["duals"]["alpha"]
    assert float((alpha - alpha[0]).abs().max()) == 0.0
    for f in ("a", "b"):  # proximal dual references = the pre-stage duals
        torch.testing.assert_close(got["ref_duals"][f],
                                   C.average(st1)["duals"][f] if resync
                                   else st1["duals"][f], rtol=0, atol=0)
    for a, b in zip(tree_leaves(got["ref_params"]), tree_leaves(got["params"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_init_state_gives_ref_params_own_buffers():
    ccfg = C.CoDAConfig(n_workers=3)
    st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    for p, r in zip(tree_leaves(st["params"]), tree_leaves(st["ref_params"])):
        assert p.data_ptr() != r.data_ptr()
        torch.testing.assert_close(p, r, rtol=0, atol=0)
        torch.testing.assert_close(p, p[0:1].expand_as(p), rtol=0, atol=0)
    assert st["params"]["score_head"]["b"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mlp", "resnet-tiny"])
@pytest.mark.parametrize("compress", [None, "int8"])
def test_byte_accounting_matches_reference(arch, compress):
    if arch == "mlp":
        mcfg, jmcfg = mlp_config(), jax_mlp_config()
    else:
        mcfg, jmcfg = get_smoke_config("resnet50"), jax_smoke_config("resnet50")
    jccfg, jst, ccfg, st = _pair(4, 5, mcfg=mcfg, jmcfg=jmcfg)
    sched = JS.ScheduleConfig(n_workers=4, T0=30, I0=8)
    psched = S.ScheduleConfig(n_workers=4, T0=30, I0=8)
    jstages, stages = JS.stages(sched, 3), S.stages(psched, 3)
    assert [dataclasses.astuple(s) for s in stages] == \
        [dataclasses.astuple(s) for s in jstages]
    assert C.model_bytes(st, compress) == JC.model_bytes(jst, compress)
    assert C.window_payload_bytes(st, compress) == JC.window_payload_bytes(jst, compress)
    assert C.stage_payload_bytes(ccfg) == JC.stage_payload_bytes(jccfg) == 4
    assert C.comm_rounds(stages) == JC.comm_rounds(jstages)
    assert C.comm_bytes(stages, st, compress) == JC.comm_bytes(jstages, jst, compress)


@pytest.mark.parametrize("mode", ["practical", "theorem1"])
@pytest.mark.parametrize("I0,grow", [(0, False), (4, False), (2, True)])
def test_schedules_equal_reference(mode, I0, grow):
    kw = dict(n_workers=8, eta0=0.2, T0=50, I0=I0, mode=mode, grow_I=grow)
    assert S.stages(S.ScheduleConfig(**kw), 4) == \
        [S.Stage(**dataclasses.asdict(s)) for s in JS.stages(JS.ScheduleConfig(**kw), 4)]


def test_resnet_tiny_local_step_matches_reference():
    """Gradients through the grouped convolutions, GroupNorm and the
    asymmetric SAME padding: one local step on ResNet-tiny."""
    mcfg, jmcfg = get_smoke_config("resnet50"), jax_smoke_config("resnet50")
    jccfg, jst, ccfg, st = _pair(2, 6, mcfg=mcfg, jmcfg=jmcfg)
    rng = np.random.default_rng(6)
    y = (rng.random((2, 4)) < 0.7).astype(np.float32)
    x = rng.standard_normal((2, 4, 64, 3)).astype(np.float32) + 0.2 * (2 * y[..., None, None] - 1)
    batch = {"images": x, "labels": y}
    jstep = jax.jit(lambda s_, b_: JC.local_step(jmcfg, jccfg, s_, b_, 0.5))
    jnew, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, jst), _j(batch))
    new, loss = C.local_step(mcfg, ccfg, st, _t(batch), 0.5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-5)
    _assert_state_close(new, _np(jnew), mcfg=mcfg, atol=1e-4)


@pytest.mark.parametrize("bad", [
    dict(algorithm="sgd"), dict(avg_compress="fp8"), dict(objective="mse"),
    dict(server_momentum=1.0), dict(pauc_beta=0.0), dict(overlap_chunks=-1),
    dict(overlap_chunks=2, avg_compress="int8"), dict(stream_bins=-1),
    dict(participation=0.0), dict(straggler_prob=1.0), dict(max_staleness=-1),
    dict(optimizer="adam"), dict(opt_beta=1.0), dict(precond_every=0),
])
def test_config_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        JC.CoDAConfig(n_workers=2, **bad)
    with pytest.raises(ValueError):
        C.CoDAConfig(n_workers=2, **bad)


OVERLAP_CONFIGS = [
    dict(overlap_chunks=1), dict(overlap_chunks=2), dict(overlap_chunks=4),
    dict(overlap_chunks=2, algorithm="codasca"), dict(overlap_chunks=2, participation=0.5),
]

# each rank: every overlap configuration's window pair on the sharded
# executor against two windows of the batched executor from the same state
_PAIRS = """
import json, sys
import torch
from repro_torch.configs import mlp_config
from repro_torch.core import bucketing as B, coda
from repro_torch.core.faults import FaultPlan
from repro_torch.launch import mesh as M
from repro_torch.tree import tree_leaves

rank, world, store, configs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    json.loads(sys.argv[4]), sys.argv[5]
torch.set_num_threads(1)
M.init_rank("gloo", rank, world, "file://" + store, timeout_s=120)
mcfg, mesh, res = mlp_config(n_features=16, d=32), M.make_worker_mesh(), []
for kw in configs:
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.7, **kw)
    st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    wb = {"features": torch.randn((2, 3, 4, 8, 16), generator=g),
          "labels": (torch.rand((2, 3, 4, 8), generator=g) < 0.7).float()}
    fl = None
    if ccfg.faults_enabled:
        plan = FaultPlan.from_config(ccfg)
        us, rs = zip(*(plan.window(w) for w in range(2)))
        fl = {"weights": torch.tensor(us), "resync": torch.tensor(rs)}
    exe = coda.make_executor(mcfg, ccfg, "shard_map", mesh=mesh)
    B.zero_collectives()
    got, losses = exe.window_pair_step(exe.place(st), wb, 0.1, faults=fl)
    hops = B.collectives["p2p"]["calls"]
    got = exe.gather(got)
    bt = coda.make_executor(mcfg, ccfg)
    for w in range(2):
        st, _ = bt.window_step(st, {k: v[w] for k, v in wb.items()}, 0.1,
                               faults=None if fl is None else {k: v[w] for k, v in fl.items()})
    sizes = {t: b["elements"] for t, b in
             B.bucket_layout(st, masked=ccfg.faults_enabled).items()}
    res.append({"pairs": exe.overlap_pairs, "loss_rows": list(losses.shape), "hops": hops,
                "want_hops": 2 * B.ring_hop_count(sizes, exe._ring_spec()),
                "all_reduce": B.collectives["all_reduce"]["calls"],
                "err": max(float((a - b).abs().max())
                           for a, b in zip(tree_leaves(got), tree_leaves(st)))})
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
M.dist.destroy_process_group()
print("RANK OK")
# leave without the interpreter's teardown, where gloo's threads can abort
# the process ("terminate called without an active exception") after the
# rank has done all its work
sys.stdout.flush()
import os
os._exit(0)
"""


@pytest.fixture(scope="module")
def overlap_pairs(tmp_path_factory):
    import json

    from _torch_ranks import run_ranks
    d = tmp_path_factory.mktemp("overlap_pairs")
    run_ranks(_PAIRS, 2, d / "store", json.dumps(OVERLAP_CONFIGS), str(d / "out.json"))
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("i", range(len(OVERLAP_CONFIGS)),
                         ids=[",".join(f"{k}={v}" for k, v in c.items()) for c in OVERLAP_CONFIGS])
def test_overlap_configs_run_a_window_pair_on_two_ranks(overlap_pairs, i):
    """The overlapped ring averaging (``overlap_chunks``), with CODASCA and
    with faults: both packages accept each configuration, and on 2 gloo
    ranks the sharded executor's window pair (each averaging C rings of
    2·(R−1) hops a chunk, no all_reduce) equals two windows of the batched
    executor from the same state within 1e-6."""
    kw = OVERLAP_CONFIGS[i]
    C.CoDAConfig(n_workers=2, **kw)
    JC.CoDAConfig(n_workers=2, **kw)
    got = overlap_pairs[i]
    assert got["pairs"] and got["loss_rows"] == [6, 2]
    assert got["hops"] == got["want_hops"] > 0 and got["all_reduce"] == 0
    assert got["err"] <= 1e-6, got["err"]


def test_executor_selection():
    ccfg = C.CoDAConfig(n_workers=2)
    assert isinstance(C.make_executor(MCFG, ccfg, "vmap"), C.BatchedExecutor)
    with pytest.raises(ValueError, match="needs a mesh"):
        C.make_executor(MCFG, ccfg, "shard_map")
    with pytest.raises(ValueError):
        C.make_executor(MCFG, ccfg, "pmap")


def test_fit_matches_reference_on_replayed_windows():
    """The whole slice: the reference's ``fit`` (mlp, K=4, 2 stages, T0=8,
    I=4) with samplers that record their windows; the port's ``fit``
    replays them from the same initial state.  Loss history, final state
    and test AUC must match."""
    K, I, B = 4, 4, 16
    key = jax.random.PRNGKey(7)
    ds = JShardedDataset(key, JDataConfig(kind="features", n_features=16, signal=2.0),
                         1024, K, target_p=0.71)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=ds.p_pos)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=ds.p_pos)
    kw = dict(n_workers=K, eta0=0.5, T0=8, I0=I)
    windows, alphas = [], []

    def record(store, batch):
        store.append(_np(batch))
        return batch

    jres = JC.fit(key, JMCFG, jccfg, JS.ScheduleConfig(**kw), 2,
                  sample_window=lambda k, i: record(windows, ds.sample_window(k, i, B)),
                  sample_alpha_batch=lambda k, m: record(alphas, ds.sample_alpha_batch(k, m)))
    # fit draws its initial state with init_state(key): rebuild it to carry across
    st0 = P.state_from_jax(MCFG, ccfg, _np(JC.init_state(key, JMCFG, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    res = C.fit(st0, MCFG, ccfg, S.ScheduleConfig(**kw), 2,
                sample_window=lambda i: _t(next(wit)),
                sample_alpha_batch=lambda m: _t(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds) == (32, 10)
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    _assert_state_close(res.state, _np(jres.state), atol=1e-4)
    test = ds.full(1024)
    jh, _ = JM.score(JMCFG, jax.tree_util.tree_map(lambda x: x[0], jres.state["params"]),
                     {"features": test["features"]})
    h, _ = M.score(MCFG, tree_map(lambda x: x[:1], res.state["params"]),
                   {"features": torch.from_numpy(np.array(test["features"]))[None]})
    got = O.roc_auc(h[0], torch.from_numpy(np.array(test["labels"])))
    want = float(JO.roc_auc(jh, test["labels"]))
    assert abs(got - want) <= 1e-3 and got > 0.8
