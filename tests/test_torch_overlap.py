"""The overlapped window pair (``core/coda_sharded.window_pair_step`` with
``bucketing.PendingAverage``) on real gloo ranks, counterpart of the
reference's fused pair (``tests/test_overlap.py``).

Each case runs on 1, 2 and 4 ranks (``tests/_torch_overlap_ranks.py``; each
group spawned by ``launch/mesh.run_ranks``) with a test-only wire whose
every hop sleeps 50 ms (at R = 1, with no hop, each unit sleeps instead),
so the first averaging outlasts the start of the second window.  Held:

  * start order — the second window's first local step starts before the
    first averaging's last unit completes, at least one averaged leaf is
    waited on after that start, and (R1's compute half) a unit is waited
    on after the second window's first matmul, except where that matmul
    needs every unit (the masked case's two chunks at R > 1);
  * two pairs are bitwise the sequential schedule (the four windows one
    after the other, ``_one_window`` four times) on the ``overlap_r4`` and
    ``masked_codasca_ring_r4`` cases of ``tests/test_torch_sharded.py``:
    the state, the losses, and the hops of each ring chain (dtype and
    bytes, in order); the second pair runs its units in the order the
    first pair's second window read them;
  * the pair's summary: one unit a chain at R > 1 (C = 2 chunks of the one
    f32 bucket), one a row block at R = 1; the masked leaves also wait on
    the weight lanes' unit.

About 60 s on one torch thread (the sleeps and the spawned ranks dominate).
"""
import re

import pytest
import torch

from repro_torch.analysis import audit as A
from repro_torch.launch import mesh as PM

import _torch_overlap_ranks as T
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

RANKS = (1, 2, 4)


@pytest.fixture(scope="module")
def runs():
    return {(R, case): PM.run_ranks(T.pair_and_sequential, R, (case, 3), backend="gloo")
            for R in RANKS for case in T.CASES}


def _first(log, event):
    return next(t for e, _, t in log if e == event)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(T.CASES))
def test_second_window_starts_before_the_first_averaging_ends(runs, R, case):
    log = runs[(R, case)]["pair"]["log"]
    issued = [w for e, w, _ in log if e == "issue"]
    done = {w: t for e, w, t in log if e == "done"}
    assert issued and set(done) == set(issued)
    start = _first(log, "step")
    assert start < max(done.values()), "window 2 began after the first averaging ended"
    assert all(t < start for e, _, t in log if e == "issue"), "a unit was issued late"
    waits = [t for e, _, t in log if e == "wait"]
    assert any(t > start for t in waits), "no leaf was waited on after window 2 began"
    # the first wait is a read inside window 2, not a barrier before it
    assert min(waits) > start
    # compute between (the audit's R1 half): a unit waited on after window 2's
    # first matmul.  Not possible for the masked case's 2 chunks at R > 1: the
    # weight lanes ride the last chunk and the first layer's rows the first,
    # so window 2's first matmul needs both
    problems = A.compute_between_problems(log)
    if case == "codasca_masked" and R > 1:
        assert len(problems) == 1 and "one after the other" in problems[0]
        first = next(i for i, (e, *_) in enumerate(log) if e == "compute")
        assert {w for e, w, _ in log[:first] if e == "wait"} == set(issued)
    else:
        assert problems == []


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(T.CASES))
def test_pair_is_bitwise_the_sequential_schedule(runs, R, case):
    pair, seq = runs[(R, case)]["pair"], runs[(R, case)]["sequential"]
    assert list(pair["state"]) == list(seq["state"])
    for path, want in seq["state"].items():
        got = pair["state"][path]
        assert got.dtype == want.dtype and torch.equal(got, want), path
    assert torch.equal(pair["losses"], seq["losses"])
    assert pair["chains"] == seq["chains"]
    assert pair["second"]["chains"] == seq["second_chains"]
    assert seq["log"] == []                   # the sequential schedule defers nothing


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(T.CASES))
def test_second_pair_runs_its_units_in_the_first_pairs_read_order(runs, R, case):
    """The first pair runs its units in index order; the second in the
    order the first pair's second window waited on them."""
    pair = runs[(R, case)]["pair"]
    issued = [w for e, w, _ in pair["log"] if e == "issue"]
    first_waits = []
    for e, w, _ in pair["log"]:
        if e == "wait" and w not in first_waits:
            first_waits.append(w)
    assert sorted(first_waits) == sorted(issued)
    tail = lambda w: w.split("/", 1)[1]        # the unit, without its averaging's serial
    again = [tail(w) for e, w, _ in pair["second"]["log"] if e == "issue"]
    assert again == [tail(w) for w in first_waits]
    index = [int(re.search(r"(\d+)$", w).group(1)) for w in issued]   # row i or chunk c
    assert index == sorted(index)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(T.CASES))
def test_pair_units_and_waits(runs, R, case):
    out = runs[(R, case)]
    sm, chains = out["pair"]["summary"], out["pair"]["chains"]
    masked = case == "codasca_masked"
    rows = 19 if masked else 9                # state (+ variate) rows (+ the lanes)
    leaves = 18 if masked else 9              # params and duals (+ cg_params, cg_duals)
    assert sm["leaves"] == leaves
    if R == 1:
        assert (sm["units"], sm["chains"]) == (rows, 0) and chains == {}
        assert sm["also_other_units"] == (leaves if masked else 0)
    else:
        assert sm["units"] == sm["chains"] == 2
        # both windows' rings: 2 chains each of 2·(R−1) equal hops
        assert len(chains) == 4 and all(len(h) == 2 * (R - 1) and len(set(h)) == 1
                                        for h in chains.values())
        assert (sm["also_other_units"] > 0) == masked
    waited = {w for e, w, _ in out["pair"]["log"] if e == "wait"}
    assert waited == {w for e, w, _ in out["pair"]["log"] if e == "issue"}
