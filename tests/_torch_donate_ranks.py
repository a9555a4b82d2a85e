"""Rank functions for tests/test_torch_donate.py: spawned gloo ranks import
this module by name.  Each rank runs the sharded executor over the same
windows, pair and stage end twice, donating and not, and rank 0 returns
both end states, the losses and what the donated run handed back."""
import numpy as np
import torch

from repro_torch.configs.base import mlp_config
from repro_torch.core import coda
from repro_torch.core.faults import FaultPlan
from repro_torch.launch import mesh as M
from repro_torch.tree import tree_leaves, tree_paths

MCFG, K, I, BATCH = mlp_config(n_features=8, d=16), 4, 2, 4
CASES = {"blocking": {"optimizer": "momentum"},
         "overlap": {"overlap_chunks": 2, "optimizer": "sm3"},
         "overlap_codasca_masked": {"overlap_chunks": 2, "algorithm": "codasca",
                                    "participation": 0.75, "fault_seed": 5,
                                    "optimizer": "shampoo_blocked", "shampoo_block": 8,
                                    "precond_every": 2},
         "server_momentum": {"server_momentum": 0.9, "overlap_chunks": 2}}


def _window(seed: int, lead: tuple) -> dict:
    g = np.random.default_rng(seed)
    y = (g.random(lead + (K, BATCH)) < 0.6).astype(np.float32)
    x = g.standard_normal(lead + (K, BATCH, 8)) + 0.3 * (2 * y[..., None] - 1)
    return {"features": torch.from_numpy(x.astype(np.float32)), "labels": torch.from_numpy(y)}


def _faults(ccfg, w0: int, n: int):
    if not ccfg.faults_enabled:
        return None
    plan = FaultPlan.from_config(ccfg)
    us, rs = zip(*(plan.window(w0 + j) for j in range(n)))
    out = {"weights": np.stack(us), "resync": np.stack(rs)}
    return {k: torch.from_numpy(v[0] if n == 1 else v) for k, v in out.items()}


def _run(ccfg, donate: bool):
    """Two blocking windows, a stage end, a pair (or two more windows) and
    another stage end, from a state made from seed 0."""
    exe = coda.make_executor(MCFG, ccfg, "shard_map", mesh=M.make_worker_mesh(), donate=donate)
    st = exe.place(coda.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0)))
    losses = []
    for w in range(2):
        st, lo = exe.window_step(st, _window(w, (I,)), 0.3, faults=_faults(ccfg, w, 1))
        losses.append(exe.gather(lo.transpose(0, 1)))
    st = exe.stage_end(st, {k: v[0] for k, v in _window(10, (1,)).items()})
    before = {p: t.untyped_storage().data_ptr() for p, t in zip(tree_paths(st),
                                                                  tree_leaves(st))}
    if exe.overlap_pairs:
        st, lo = exe.window_pair_step(st, _window(2, (2, I)), 0.3, faults=_faults(ccfg, 2, 2))
        losses.append(exe.gather(lo.transpose(0, 1)))
    else:
        for w in (2, 3):
            st, lo = exe.window_step(st, _window(w, (I,)), 0.3, faults=_faults(ccfg, w, 1))
            losses.append(exe.gather(lo.transpose(0, 1)))
    kept = sum(t.untyped_storage().data_ptr() == before[p]
               for p, t in zip(tree_paths(st), tree_leaves(st)))
    st = exe.stage_end(st, {k: v[0] for k, v in _window(11, (1,)).items()})
    whole = exe.gather(st)
    return ({p: t.clone() for p, t in zip(tree_paths(whole), tree_leaves(whole))},
            torch.cat(losses, dim=1), kept, len(before))


def donated_and_not(rank: int, case: str) -> dict:
    torch.set_num_threads(1)
    ccfg = coda.CoDAConfig(n_workers=K, p_pos=0.6, **CASES[case])
    out = {}
    for donate in (True, False):
        out[donate] = _run(ccfg, donate)
    return out
