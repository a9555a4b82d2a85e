"""repro_torch.checkpoint and ``coda.fit``'s crash-resume, mirroring
tests/test_checkpoint.py, and checkpoints crossing between the packages.

The contract: a run killed mid-flight resumes from the latest
window-boundary checkpoint and finishes bitwise the uninterrupted run —
state, the samplers' numpy stream, loop counters, loss history and byte
accounting — with fault injection too (the schedule is a function of
the fault seed and the global window count).  A state checkpoint written
by either package restores into the other's state bitwise (same files,
same keys, bf16 as its uint16 bits).
"""
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro_torch import params as P
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import mlp_config
from repro_torch.core import coda as C
from repro_torch.core import schedules as S
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.tree import tree_leaves, tree_paths
from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMCFG = jax_mlp_config(n_features=8, d=16)
MCFG = mlp_config(n_features=8, d=16)
K, I, B = 4, 2, 4
SCHED = S.ScheduleConfig(n_workers=K, eta0=0.3, T0=8, I0=I)
N_STAGES = 2  # practical mode triples T stagewise: 4 + 12 = 16 windows

CONFIGS = {
    "clean": {},
    "fault-injected": dict(participation=0.7, straggler_prob=0.2, max_staleness=1,
                           fault_seed=11),
    "codasca-faults-sketch": dict(algorithm="codasca", participation=0.75,
                                  straggler_prob=0.2, straggler_windows=2, max_staleness=2,
                                  fault_seed=3, stream_bins=64),
    "momentum-bf16": dict(optimizer="momentum", opt_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16),
    "codasca-server-momentum": dict(algorithm="codasca", server_momentum=0.9),
}


class _Crash(RuntimeError):
    pass


def _run(ccfg, crash_after=None, **kw):
    """fit on a fresh dataset (seed 0, Dirichlet shards) whose window
    sampler dies on its (crash_after+1)-th draw when ``crash_after`` is
    set; the dataset's generator rides the checkpoints."""
    ds = ShardedDataset(DataConfig(kind="features", n_features=8), 512, K, seed=0,
                        target_p=0.6, dirichlet_alpha=0.5)
    seen = [0]

    def sample_window(n):
        if crash_after is not None and seen[0] >= crash_after:
            raise _Crash(f"simulated crash at window draw {seen[0]}")
        seen[0] += 1
        return ds.sample_window(n, B)

    st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    return C.fit(st, MCFG, ccfg, SCHED, N_STAGES, sample_window, ds.sample_alpha_batch,
                 rng=ds.draw_rng, **kw)


def _assert_identical(a, b):
    assert tree_paths(a.state) == tree_paths(b.state)
    for pa, pb in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert pa.dtype == pb.dtype and torch.equal(pa, pb), "state leaf differs"
    assert a.history == b.history
    assert (a.comm_rounds, a.iterations) == (b.comm_rounds, b.iterations)
    assert (a.exposed_bytes, a.overlapped_bytes) == (b.exposed_bytes, b.overlapped_bytes)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_crash_resume_is_bitwise_identical(tmp_path, name):
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6, **CONFIGS[name])
    want = _run(ccfg)
    d = str(tmp_path / "run")
    with pytest.raises(_Crash):
        _run(ccfg, crash_after=5, ckpt_dir=d, ckpt_every=2)
    # died after 5 window draws: checkpoints at gw = 2 and 4
    assert ckpt.latest_step(d) == 4
    meta = ckpt.load_metadata(d, 4)
    assert meta["gw"] == 4 and meta["rounds"] == 4 and "rng" in meta
    got = _run(ccfg, ckpt_dir=d, ckpt_every=2, resume=True)
    _assert_identical(want, got)
    assert ckpt.latest_step(d) == 16
    if "participation" in CONFIGS[name]:
        assert want.exposed_bytes == 16 * C.window_payload_bytes(want.state, masked=True) \
            + 2 * 4


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6)
    _assert_identical(_run(ccfg), _run(ccfg, ckpt_dir=str(tmp_path / "empty"), ckpt_every=4,
                                       resume=True))


def test_checkpointing_fit_needs_the_samplers_generator(tmp_path):
    """Without ``rng`` a checkpoint could not carry the samplers' state, so a
    resumed run would draw other windows: ``fit`` refuses before any step."""
    ds = ShardedDataset(DataConfig(kind="features", n_features=8), 512, K, seed=0,
                        target_p=0.6)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.6)
    st = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    for resume in (False, True):
        with pytest.raises(ValueError, match="rng"):
            C.fit(st, MCFG, ccfg, SCHED, N_STAGES, lambda n: ds.sample_window(n, B),
                  ds.sample_alpha_batch, ckpt_dir=str(tmp_path / "run"), ckpt_every=2,
                  resume=resume)
    assert ckpt.latest_step(str(tmp_path / "run")) is None


def test_checkpoint_cadence_and_metadata_roundtrip(tmp_path):
    d = str(tmp_path / "run")
    _run(C.CoDAConfig(n_workers=K, p_pos=0.6), ckpt_dir=d, ckpt_every=2)
    assert ckpt.latest_step(d) == 16
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in range(2, 17, 2)]
    for step in range(2, 17, 2):
        meta = ckpt.load_metadata(d, step)
        assert meta["gw"] == step
        for k in ("stage", "w", "rounds", "iters", "exposed", "overlapped", "history", "rng"):
            assert k in meta, k
    assert ckpt.latest_step(str(tmp_path / "nothing")) is None


def test_save_restore_roundtrip_and_checks(tmp_path):
    tree = {"b": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  torch.randn(3, dtype=torch.float32)],
            "a": {"w": torch.randn(2, 5).to(torch.bfloat16), "t": torch.tensor(7)}}
    path = ckpt.save(str(tmp_path), 3, tree, {"note": "x"})
    assert path.endswith("step_00000003")
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["keys"] == ["['a']['t']", "['a']['w']", "['b'][0]", "['b'][1]"]
    assert man["dtypes"] == ["int64", "bfloat16", "int32", "float32"]
    assert np.load(os.path.join(path, "arrays.npz"))["a1"].dtype == np.uint16
    like = {"b": [torch.zeros(2, 3, dtype=torch.int32), torch.zeros(3)],
            "a": {"w": torch.zeros(2, 5, dtype=torch.bfloat16),
                  "t": torch.tensor(0)}}
    back = ckpt.restore(str(tmp_path), 3, like)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert ckpt.load_metadata(str(tmp_path), 3) == {"note": "x"}
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(str(tmp_path), 3, {"b": like["b"]})
    like["b"][1] = torch.zeros(4)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 3, like)


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
CROSS = {
    "fp32": dict(),
    "bf16-codasca-momentum": dict(algorithm="codasca", param_dtype="bf16",
                                  optimizer="momentum", opt_dtype="bf16", stream_bins=16),
    "bf16-server-momentum": dict(algorithm="codasca", server_momentum=0.5,
                                 param_dtype="bf16"),
}


def _cfgs(kw):
    dt = lambda v, j: (jnp.bfloat16 if j else torch.bfloat16) if v == "bf16" else v
    jkw = {k: dt(v, True) for k, v in kw.items()}
    tkw = {k: dt(v, False) for k, v in kw.items()}
    return (JC.CoDAConfig(n_workers=K, p_pos=0.6, **jkw),
            C.CoDAConfig(n_workers=K, p_pos=0.6, **tkw))


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _window(seed):
    rng = np.random.default_rng(seed)
    y = (rng.random((I, K, B)) < 0.6).astype(np.float32)
    return {"features": rng.standard_normal((I, K, B, 8)).astype(np.float32)
            + 0.3 * (2 * y[..., None] - 1), "labels": y}


@pytest.mark.parametrize("case", list(CROSS))
def test_reference_checkpoint_restores_into_the_port_bitwise(tmp_path, case):
    jccfg, ccfg = _cfgs(CROSS[case])
    jst0 = JC.init_state(jax.random.PRNGKey(1), JMCFG, jccfg)
    exe = JC.make_executor(JMCFG, jccfg, "vmap", donate=False)
    jst, _ = exe.window_step(jst0, jax.tree_util.tree_map(jnp.asarray, _window(0)), 0.3)
    jckpt.save(str(tmp_path), 8, {"state": jst}, {"by": "reference"})
    template = {"state": C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))}
    got = ckpt.restore(str(tmp_path), 8, template)["state"]
    want = jax.tree_util.tree_leaves({"state": jst})
    assert tree_paths({"state": got}) == [jax.tree_util.keystr(p) for p, _ in
                                          jax.tree_util.tree_flatten_with_path(
                                              {"state": jst})[0]]
    for g, w in zip(tree_leaves(got), want, strict=True):
        assert np.array_equal(_bits(g), _bits(w))
    assert ckpt.load_metadata(str(tmp_path), 8) == {"by": "reference"}


@pytest.mark.parametrize("case", list(CROSS))
def test_port_checkpoint_restores_into_the_reference_bitwise(tmp_path, case):
    jccfg, ccfg = _cfgs(CROSS[case])
    st0 = C.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    st, _ = C.make_executor(MCFG, ccfg).window_step(
        st0, {k: torch.from_numpy(v) for k, v in _window(1).items()}, 0.3)
    ckpt.save(str(tmp_path), 8, {"state": st}, {"by": "port"})
    template = {"state": JC.init_state(jax.random.PRNGKey(1), JMCFG, jccfg)}
    got = jckpt.restore(str(tmp_path), 8, template)
    for g, w in zip(jax.tree_util.tree_leaves(got), tree_leaves({"state": st}), strict=True):
        assert g.dtype.name == str(w.dtype)[6:]
        assert np.array_equal(_bits(g), _bits(w))
    # and through params.py: the port's state rebuilt from the reference's
    back = P.state_from_jax(MCFG, ccfg, jax.tree_util.tree_map(np.asarray, got["state"]))
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def _launch(*args):
    env = one_thread_env()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                          "--stages", "1", "--t0", "8", "--interval", "2", "--n-data", "512",
                          "--algorithm", "codasca", "--participation", "0.75", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launcher_checkpoints_resume_and_export(tmp_path):
    """``--ckpt-dir`` + ``--ckpt-every`` writes window checkpoints; a rerun
    with ``--resume`` starts from the last one and prints the same
    counters and test AUC; ``--ckpt-dir`` alone saves the final state."""
    d = str(tmp_path / "run")
    first = _launch("--ckpt-dir", d, "--ckpt-every", "2")
    assert ckpt.latest_step(d) == 4
    again = _launch("--ckpt-dir", d, "--ckpt-every", "2", "--resume")
    done = re.compile(r"^done: (\d+) iters, (\d+) comm rounds, [\d.]+s, (test AUC=\S+)$", re.M)
    assert done.search(first).groups() == done.search(again).groups()
    assert done.search(first).group(1) == "8"
    e = str(tmp_path / "export")
    out = _launch("--ckpt-dir", e)
    assert f"checkpoint: {e}/step_00000008" in out
    meta = ckpt.load_metadata(e, 8)
    assert meta["arch"] == "mlp" and 0.0 <= meta["auc"] <= 1.0
