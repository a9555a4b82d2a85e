"""Rank functions for tests/test_torch_overlap.py: spawned gloo ranks import
this module by name.  Each rank runs one overlapped window pair and the
sequential schedule of the same two windows (``_one_window`` twice) from
the same state and batches, and returns what rank 0 needs to compare."""
import time

import numpy as np
import torch

from repro_torch.configs.base import mlp_config
from repro_torch.core import bucketing as B
from repro_torch.core import coda
from repro_torch.core.faults import FaultPlan
from repro_torch.launch import mesh as M
from repro_torch.tree import tree_leaves, tree_map, tree_paths

MCFG, I, BATCH = mlp_config(n_features=16, d=32), 3, 8
# the overlap_r4 and masked_codasca_ring_r4 cases of tests/test_torch_sharded.py
CASES = {"overlap": {"overlap_chunks": 2},
         "codasca_masked": {"overlap_chunks": 2, "algorithm": "codasca",
                            "participation": 0.75, "fault_seed": 5}}
HOP_SLEEP_S = 0.05


class SleepyWire(B.Wire):
    """A wire whose every hop first sleeps: the first window's chains then
    outlast the start of the second window's local steps."""

    def hop(self, send, chain=None):
        time.sleep(HOP_SLEEP_S)
        return super().hop(send, chain)


def _batches(seed: int) -> list:
    g = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        y = (g.random((I, 4, BATCH)) < 0.7).astype(np.float32)
        x = (g.standard_normal((I, 4, BATCH, 16)) + 0.3 * (2 * y[..., None] - 1))
        out.append({"features": torch.from_numpy(x.astype(np.float32)),
                    "labels": torch.from_numpy(y)})
    return out


def _faults(ccfg, exe):
    if not ccfg.faults_enabled:
        return None
    plan = FaultPlan.from_config(ccfg)
    us, rs = zip(*(plan.window(w) for w in range(2)))
    return {"weights": torch.from_numpy(np.stack(us)), "resync": torch.from_numpy(np.stack(rs))}


def _snapshot(state) -> dict:
    return {p: l.clone() for p, l in zip(tree_paths(state), tree_leaves(state))}


def _chains(wire_log) -> dict:
    """Each ring chain's hops (dtype, bytes) in order."""
    out: dict = {}
    for kind, tag, n, chain in wire_log:
        if kind == "p2p":
            out.setdefault(chain, []).append((tag, n))
    return out


def pair_and_sequential(rank: int, case: str, seed: int) -> dict:
    """The overlapped pair and the sequential schedule on this rank; rank 0
    returns both end states, losses, wire chains, and the pair's
    ``overlap_log`` and summary."""
    torch.set_num_threads(1)
    mesh = M.make_worker_mesh()
    ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.7, **CASES[case])
    exe = coda.make_executor(MCFG, ccfg, "shard_map", mesh=mesh)
    exe.wire = SleepyWire(exe.wire.group)
    R = exe.wire.size
    run = B._RingReduction.run

    def slow(self, u):
        time.sleep(HOP_SLEEP_S)
        return run(self, u)
    if R == 1:                 # no hops to sleep in: each unit sleeps instead
        B._RingReduction.run = slow
    try:
        return _pair_and_sequential(exe, ccfg, seed, R)
    finally:
        B._RingReduction.run = run


def _pair_and_sequential(exe, ccfg, seed: int, R: int) -> dict:
    """Two overlapped pairs (the second runs its units in the order the
    first one's second window read them), then the same four windows one
    after the other."""
    whole = coda.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(seed))
    wb = _batches(seed)
    fl = _faults(ccfg, exe)
    wb2 = {k: torch.stack([w[k] for w in wb]) for k in wb[0]}

    st, pairs = exe.place(tree_map(torch.clone, whole)), []   # the pairs consume it
    for _ in range(2):
        B.zero_collectives()
        st, losses = exe.window_pair_step(st, wb2, 0.1, faults=fl)
        pairs.append({"losses": losses.clone(), "chains": _chains(B.wire_log),
                      "log": list(B.overlap_log), "summary": dict(exe.overlap_summary)})
    pair = dict(pairs[0], state=_snapshot(st), second=pairs[1],
                losses=torch.cat([p["losses"] for p in pairs]))
    del st

    B.zero_collectives()
    st, ring, out = exe.place(whole), exe._ring_spec(), []
    bt2, fl2 = exe._batch(wb2, 2), exe._faults(fl, True)
    for w in range(4):
        if w == 2:
            chains = _chains(B.wire_log)
            B.zero_collectives()
        i = w % 2
        st, lo = exe._one_window(st, {k: v[i] for k, v in bt2.items()}, 0.1,
                                 communicate=True, ring=ring,
                                 fl=None if fl2 is None else {k: v[i] for k, v in fl2.items()})
        out.append(lo)
    seq = {"state": _snapshot(st), "losses": torch.cat(out), "chains": chains,
           "second_chains": _chains(B.wire_log), "log": list(B.overlap_log)}
    return {"R": R, "pair": pair, "sequential": seq}
