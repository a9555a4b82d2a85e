"""repro_torch.core.baselines and repro_torch.quickstart vs the reference's
``core/baselines.py`` and ``examples/quickstart.py``.

The reference's parameters and windows are carried across (numpy); its
``jax.random`` draws are replayed through the port.  Tolerances:
  * ``bce_step`` and ``np_ppd_sg_window`` in fp32: atol 1e-6 on parameters
    and losses (a few fp32 sums in another order);
  * ``bce_step`` on bf16 parameters: one bf16 ulp of the weight (rtol 2⁻⁷)
    plus 1e-6: w − η·ḡ is rounded to bf16 once, and an fp32 gradient a few
    ulp apart may round the other way;
  * the quickstart twin on the reference's replayed windows (832 local
    steps over 3 stages): window losses rtol 1e-4 (atol 1e-6), the final
    test AUC atol 1e-3 (a near-tied pair may swap ranks), counters exact.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import baselines as JB
from repro.core import coda as JC
from repro.core import objective as JO
from repro.core import schedules as JS
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedDataset as JShardedDataset
from repro.models import model as JM
from repro_torch import params as P
from repro_torch import quickstart as Q
from repro_torch.configs import mlp_config
from repro_torch.core import baselines as B
from repro_torch.core import coda as C
from repro_torch.tree import tree_leaves
from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMCFG, MCFG = jax_mlp_config(n_features=16, d=32), mlp_config(n_features=16, d=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, lead, nf=16, p=0.7):
    rng = np.random.default_rng(seed)
    y = (rng.random(lead) < p).astype(np.float32)
    x = rng.standard_normal(lead + (nf,)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
    return {"features": x, "labels": y}


def _leaves_close(got, want, **tol):
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


def test_params_k_and_ppd_sg_config():
    p = B.bce_init(MCFG, 3, generator=torch.Generator().manual_seed(0))
    assert B.params_k(p) == 3 == JB.params_k(JB.bce_init(jax.random.PRNGKey(0), JMCFG, 3))
    cfg = B.ppd_sg_config(C.CoDAConfig(n_workers=8, p_pos=0.7, gamma=0.3))
    want = JB.ppd_sg_config(JC.CoDAConfig(n_workers=8, p_pos=0.7, gamma=0.3))
    assert (cfg.n_workers, cfg.p_pos, cfg.gamma) == (want.n_workers, want.p_pos,
                                                     want.gamma) == (1, 0.7, 0.3)
    # bce_init stacks one replica K times, in the asked dtype
    assert all(torch.equal(l[0], l[2]) for l in tree_leaves(p))
    p16 = B.bce_init(MCFG, 2, dtype=torch.bfloat16)
    assert p16["mlp"][0]["w"].dtype == torch.bfloat16
    assert p16["score_head"]["b"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bce_step_matches_reference(dtype):
    """One synchronous parallel-SGD step on BCE: the workers' gradients
    averaged, w ← w − η·ḡ, through the bce objective and the executors'
    loss, from the reference's ``bce_init``."""
    K, Bsz = 3, 16
    jp = _np(JB.bce_init(jax.random.PRNGKey(1), JMCFG, K, dtype=getattr(jnp, dtype)))
    batch = _batch(1, (K, Bsz))
    jnew, jloss = JB.bce_step(JMCFG, jax.tree_util.tree_map(jnp.asarray, jp),
                              {k: jnp.asarray(v) for k, v in batch.items()}, 0.1)
    new, loss = B.bce_step(MCFG, P.from_jax_params(MCFG, jp),
                           {k: torch.from_numpy(v) for k, v in batch.items()}, 0.1)
    assert [t.dtype for t in tree_leaves(new)] == [t.dtype for t in
                                                   tree_leaves(P.from_jax_params(MCFG, jp))]
    assert abs(float(loss) - float(jloss)) <= 1e-6
    tol = {"atol": 1e-6} if dtype == "float32" else {"atol": 1e-6, "rtol": 2 ** -7}
    _leaves_close(P.to_jax_params(MCFG, new), _np(jnew), **tol)
    # every worker holds the same replica after the averaged step
    assert all(torch.equal(l[0], l[1]) for l in tree_leaves(new))


def test_np_ppd_sg_window_matches_reference():
    """NP-PPD-SG: an average after every local step of a 3-step window."""
    K, I, Bsz = 3, 3, 8
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7)
    jst = _np(JC.init_state(jax.random.PRNGKey(2), JMCFG, jccfg))
    wb = _batch(2, (I, K, Bsz))
    jnew, jlosses = JB.np_ppd_sg_window(JMCFG, jccfg, jax.tree_util.tree_map(jnp.asarray, jst),
                                        {k: jnp.asarray(v) for k, v in wb.items()}, 0.3)
    new, losses = B.np_ppd_sg_window(MCFG, ccfg, P.state_from_jax(MCFG, ccfg, jst),
                                     {k: torch.from_numpy(v) for k, v in wb.items()}, 0.3)
    assert losses.shape == (I,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-6)
    got = P.state_to_jax(MCFG, new)
    for field in ("params", "duals"):
        _leaves_close(got[field], _np(jnew[field]), atol=1e-6)
    assert all(torch.equal(l[0], l[2]) for l in tree_leaves(new["params"]))


def test_quickstart_twin_matches_reference_on_replayed_windows():
    """``examples/quickstart.py``'s run (K=4, I=8, B=32, mlp d=64 on 32
    features at signal 1.5, 3 stages, T0=64) with samplers that record the
    reference's windows; the port's ``quickstart.run`` replays them from the
    reference's initial state and scores the reference's held-out split."""
    key = jax.random.PRNGKey(0)
    jmcfg = jax_mlp_config(n_features=32, d=64)
    dcfg = JDataConfig(kind="features", n_features=32, signal=1.5)
    ds = JShardedDataset(key, dcfg, Q.N_DATA, Q.K, target_p=0.71)
    jccfg = JC.CoDAConfig(n_workers=Q.K, p_pos=ds.p_pos)
    windows, alphas = [], []

    def record(store, batch):
        store.append(_np(batch))
        return batch

    jres = JC.fit(key, jmcfg, jccfg, JS.ScheduleConfig(n_workers=Q.K, eta0=Q.ETA0, T0=Q.T0,
                                                      I0=Q.I), Q.N_STAGES,
                  sample_window=lambda k, i: record(windows, ds.sample_window(k, i, Q.BATCH)),
                  sample_alpha_batch=lambda k, m: record(alphas, ds.sample_alpha_batch(k, m)))
    test = ds.full(Q.N_TEST)
    p0 = jax.tree_util.tree_map(lambda x: x[0], jres.state["params"])
    jauc = float(JO.roc_auc(JM.score(jmcfg, p0, {"features": test["features"]})[0],
                            test["labels"]))
    ccfg = C.CoDAConfig(n_workers=Q.K, p_pos=ds.p_pos)
    st0 = P.state_from_jax(Q.MCFG, ccfg, _np(JC.init_state(key, jmcfg, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    tt = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    out = Q.run(st0, ds.p_pos, tt(_np(test)), sample_window=lambda i: tt(next(wit)),
                sample_alpha_batch=lambda m: tt(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (out["iterations"], out["comm_rounds"]) == (jres.iterations, jres.comm_rounds) \
        == (832, 107)
    assert [h[:2] for h in out["history"]] == [h[:2] for h in jres.history]
    np.testing.assert_allclose([h[2] for h in out["history"]], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    assert abs(out["auc"] - jauc) <= 1e-3 and out["auc"] > 0.85
    assert dataclasses.asdict(Q.MCFG) == dataclasses.asdict(jmcfg)


def test_quickstart_prints_the_references_lines():
    """``python -m repro_torch.quickstart --device cpu``: the reference's
    four summary lines (its counters exactly) and its AUC > 0.85 assert."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
                         cwd=ROOT, env=one_thread_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.fullmatch(r"dataset: n=\d+, positive ratio=0\.7\d\d, 4 workers", lines[0])
    assert lines[1:4] == ["iterations            : 832",
                          "communication rounds  : 107 (naive parallel would need 835)",
                          "bytes/round/worker    : 25,360"]
    auc = re.fullmatch(r"final test AUC        : (\d\.\d{4})", lines[4])
    assert auc and float(auc.group(1)) > 0.85
