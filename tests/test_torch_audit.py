"""The port's program audit (``repro_torch.analysis.audit``) against the
reference's: a red-team case a rule (the counterparts of
``tests/test_audit.py``), the real stack on 2 and 4 gloo ranks (it passes,
and a collective smuggled into the local steps fails it), the CLI's
matrix, and every leg's R1 expectation against the reference's own
accounting functions on the same configs."""
import gc

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

from repro_torch.analysis import audit as A
from repro_torch.analysis import roofline
from repro_torch.configs.base import mlp_config
from repro_torch.core import bucketing as PB
from repro_torch.core import coda as PC
from repro_torch.launch import audit as LA
from repro_torch.launch import mesh as PM

MCFG = mlp_config(n_features=16, d=32)


@pytest.fixture(autouse=True)
def fp32_accumulation():
    """The entry points' setting (``repro_torch.disable_tf32``); R3 flags
    the reduced-precision reductions left on."""
    m = torch.backends.cuda.matmul
    old = (m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction)
    m.allow_bf16_reduced_precision_reduction = m.allow_fp16_reduced_precision_reduction = False
    yield
    m.allow_bf16_reduced_precision_reduction, m.allow_fp16_reduced_precision_reduction = old


def _prog(name, wire, collectives):
    return A.Program(name, expect={"collectives": collectives}, wire=list(wire))


def _r(rule, report):
    return [f for f in report.findings if f.rule == rule]


# ---------------------------------------------------------------------------
# R1 — collective placement (synthetic wire logs)
# ---------------------------------------------------------------------------
WINDOW = {"kind": "window", "expected_bytes": 400, "by_dtype": {"f32": 400}}


def test_r1_local_steps_must_be_collective_free():
    ok = A.run_rules([_prog("local_steps", [], {"kind": "none"})], rules={"R1"})
    bad = A.run_rules([_prog("local_steps", [("all_reduce", "f32", 400)], {"kind": "none"})],
                      rules={"R1"})
    assert ok.ok and not bad.ok
    assert "collective-free" in _r("R1", bad)[0].message


def test_r1_window_is_one_all_reduce_a_bucket():
    assert A.run_rules([_prog("w", [("all_reduce", "f32", 400)], WINDOW)]).ok
    two = A.run_rules([_prog("w", [("all_reduce", "f32", 400)] * 2, WINDOW)], rules={"R1"})
    assert "stray all_reduce" in _r("R1", two)[0].message
    short = A.run_rules([_prog("w", [("all_reduce", "f32", 396)], WINDOW)], rules={"R1"})
    assert "no all_reduce carries the f32 bucket of 400" in _r("R1", short)[0].message
    gathered = A.run_rules([_prog("w", [("all_gather", "f32", 400)], WINDOW)], rules={"R1"})
    assert any("only all_reduce" in f.message for f in gathered.findings)


def test_r1_bf16_state_needs_both_buckets():
    spec = {"kind": "window", "expected_bytes": 300, "by_dtype": {"bf16": 200, "f32": 100}}
    assert A.run_rules([_prog("w", [("all_reduce", "bf16", 200), ("all_reduce", "f32", 100)],
                              spec)], rules={"R1"}).ok
    merged = A.run_rules([_prog("w", [("all_reduce", "f32", 300)], spec)], rules={"R1"})
    assert not merged.ok


@pytest.mark.parametrize("leak", ["extra_bucket", "merged"])
def test_r1_optimizer_state_on_the_wire_is_named(leak):
    spec = dict(WINDOW, opt_bytes=256)
    wire = ([("all_reduce", "f32", 400), ("all_reduce", "f32", 256)] if leak == "extra_bucket"
            else [("all_reduce", "f32", 656)])
    rep = A.run_rules([_prog("w", wire, spec)], rules={"R1"})
    assert any("optimizer state leaked onto the wire" in f.message for f in rep.findings)


def test_r1_int8_leg_ships_the_s8_f32_pair():
    spec = {"kind": "gather_pair", "payload_bytes": 100, "n_rows": 2}
    ok = [("all_gather", "s8", 184), ("all_gather", "f32", 16)]
    assert A.run_rules([_prog("w", ok, spec)], rules={"R1"}).ok
    plain = [("all_gather", "f32", 184), ("all_gather", "f32", 16)]
    rep = A.run_rules([_prog("w", plain, spec)], rules={"R1"})
    assert any("uncompressed" in f.message for f in rep.findings)
    assert not A.run_rules([_prog("w", [("all_reduce", "f32", 200)], spec)], rules={"R1"}).ok


# an overlapped pair's host schedule: both units issued, the second window's
# first matmul waits on c0, the second runs before the wait on c1
OVERLAPPED = [("issue", "a1/f32/c0", 0.0), ("issue", "a1/f32/c1", 0.1), ("step", "0", 0.2),
              ("wait", "a1/f32/c0", 0.3), ("compute", "bmm", 0.4), ("wait", "a1/f32/c1", 0.5),
              ("compute", "bmm", 0.6)]


def _pair(wire, spec, schedule=OVERLAPPED):
    p = _prog("pair", wire, spec)
    p.schedule = list(schedule)
    return p


def test_r1_ring_hops_and_the_unchecked_compute_half():
    """The ring's wire (chains grouped by their tags, interleaved or not)
    and, now checked, the compute between the first averaging's issue and
    the second window's waits."""
    spec = {"kind": "ring", "n_hops": 4, "n_chains": 2, "hop_len": 2}
    hops = [("p2p", "f32", 8, "a1/f32/c0"), ("p2p", "f32", 8, "a1/f32/c0"),
            ("p2p", "f32", 4, "a1/f32/c1"), ("p2p", "f32", 4, "a1/f32/c1")]
    rep = A.run_rules([_pair(hops, spec)], rules={"R1"})
    assert rep.ok and rep.checked == [("R1", "pair")]
    interleaved = [hops[0], hops[2], hops[1], hops[3]]
    assert A.run_rules([_pair(interleaved, spec)], rules={"R1"}).ok
    wrong = A.run_rules([_pair(hops + hops[:2], spec)], rules={"R1"})
    assert "expected 4 ring hops, found 6" in _r("R1", wrong)[0].message
    ragged = A.run_rules([_pair([hops[0], hops[2], hops[1], hops[1]], spec)], rules={"R1"})
    assert "equal hops" in _r("R1", ragged)[0].message
    one_chain = [h[:3] + ("a1/f32/c0",) for h in hops[:2]] * 2
    merged = A.run_rules([_pair(one_chain, spec)], rules={"R1"})
    assert "expected 2 independent chains" in _r("R1", merged)[0].message
    untagged = A.run_rules([_pair([h[:3] for h in hops], spec)], rules={"R1"})
    assert any("no chain tag" in f.message for f in untagged.findings)
    blocking = A.run_rules([_pair(hops + [("all_reduce", "f32", 4, None)],
                                  dict(spec, n_hops=4))], rules={"R1"})
    assert any("blocking" in f.message for f in blocking.findings)
    # the sequential pair: every unit waited on before the second window's compute
    sequential = [e for e in OVERLAPPED if e[0] != "compute"] + [("compute", "bmm", 0.7)]
    seq = A.run_rules([_pair(hops, spec, sequential)], rules={"R1"})
    assert any("one after the other" in f.message for f in seq.findings)
    late = [OVERLAPPED[0], OVERLAPPED[2], OVERLAPPED[1]] + OVERLAPPED[3:]
    assert any("issued after the second window began" in f.message
               for f in A.run_rules([_pair(hops, spec, late)], rules={"R1"}).findings)
    assert any("issued no unit" in f.message
               for f in A.run_rules([_pair(hops, spec, [])], rules={"R1"}).findings)


# ---------------------------------------------------------------------------
# R2 — buffer reuse
# ---------------------------------------------------------------------------
_KEPT = []


def _step(state):
    return {k: (v * 2 if torch.is_tensor(v) else v) for k, v in state.items()}


def test_r2_a_window_that_keeps_the_old_state_is_found():
    def keeps(state):
        _KEPT.append(state)                   # the old state outlives the call
        return _step(state)

    p = A.Program("window")
    A.run_program(p, keeps, [{"w": torch.ones(4), "b": torch.zeros(2)}])
    _KEPT.clear()
    rep = A.run_rules([p], rules={"R2"})
    assert len(_r("R2", rep)) == 1 and "still alive" in rep.findings[0].message
    ok = A.Program("window")
    A.run_program(ok, _step, [{"w": torch.ones(4), "b": torch.zeros(2)}])
    assert A.run_rules([ok], rules={"R2"}).ok and ok.retained == []


def test_r2_a_reference_cycle_holding_the_old_state_is_found():
    """The fault ``tree_unflatten``'s closure once had: the old tree freed
    only when the cyclic collector runs."""
    def cyclic(state):
        def rebuild():
            return rebuild, state             # a closure that refers to itself
        rebuild.keep = rebuild
        return _step(state)

    p = A.Program("window")
    A.run_program(p, cyclic, [{"w": torch.ones(4)}])
    gc.collect()
    rep = A.run_rules([p], rules={"R2"})
    assert "until the cyclic collector ran" in rep.findings[0].message


def test_r2_shared_leaves_are_not_retained():
    """An unchanged leaf handed on to the new state (``ref_params`` in a
    window) is the new state's, not a survivor."""
    p = A.Program("stage")
    A.run_program(p, lambda s: dict(s, w=s["w"] + 1), [{"w": torch.ones(4), "r": torch.ones(3)}])
    assert p.retained == []


def _donated_window(donate: bool):
    """A batched executor's window, declared donated, on a fresh state."""
    ccfg = PC.CoDAConfig(n_workers=4, p_pos=0.7, optimizer="momentum")
    exe = PC.make_executor(MCFG, ccfg, donate=donate)
    p = A.Program("vmap/window", expect={"donated": True})
    A.run_program(p, lambda s, wb, eta: exe.window_step(s, wb, eta),
                  [PC.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0)),
                   A.window_batch(MCFG, 4, 2, 8), 0.1])
    return p


@pytest.mark.parametrize("donate", [True, False])
def test_r2_a_donated_window_hands_every_leaf_back_in_its_storage(donate):
    """A donating window writes the parameters, momentum, duals and step
    counter into the consumed state's buffers; the same window without
    donation allocates new ones, which the donation check finds."""
    p = _donated_window(donate)
    rep = A.run_rules([p], rules={"R2"})
    assert ("R2", "vmap/window") in rep.checked
    if donate:
        assert rep.ok and p.moved == [] and p.retained == []
    else:
        assert len(_r("R2", rep)) == 1 and "new storage" in rep.findings[0].message
        assert any("['params']" in m for m in p.moved) and any("['opt']" in m for m in p.moved)


def test_r2_a_donated_program_is_held_to_the_transient_peak_bound():
    """The card's record of a donated program: a transient peak over
    ``R2_PEAK_STATE_RATIO`` × the new state + the slack is a finding (a
    window that kept its input), one under it is not; a program nothing
    was donated to is only recorded."""
    state = 10 * 2 ** 30
    mem = lambda peak: {"held_by_caller": 0, "new_bytes": state, "allocated_after": state,
                        "excess": 0, "peak_above_state": peak, "transient_peak": peak}
    over = int(A.transient_peak_bound(state)) + 1
    bad = A.Program("w", expect={"donated": True}, memory=mem(over))
    good = A.Program("w", expect={"donated": True}, memory=mem(state // 2))
    plain = A.Program("w", memory=mem(over))
    assert "transient" not in str(A.run_rules([good], rules={"R2"}).findings)
    assert A.run_rules([good], rules={"R2"}).ok and A.run_rules([plain], rules={"R2"}).ok
    assert "peaked" in _r("R2", A.run_rules([bad], rules={"R2"}))[0].message


def test_r2_capture_declares_the_default_executors_donated():
    ccfg = PC.CoDAConfig(n_workers=2, p_pos=0.7)
    progs = A.capture_vmap_programs(MCFG, ccfg)
    assert all(p.expect["donated"] and p.moved == [] for p in progs)
    assert A.run_rules(progs, rules={"R2"}).ok


# ---------------------------------------------------------------------------
# R3 — host syncs and dtypes
# ---------------------------------------------------------------------------
def _lint(fn, *args):
    p = A.Program("step")
    A.run_program(p, fn, list(args), consumed=())
    return A.run_rules([p], rules={"R3"})


def test_r3_float64_in_a_step():
    rep = _lint(lambda x: x.to(torch.float64) * 2, torch.ones(3))
    assert any("float64" in f.message for f in rep.findings)


def test_r3_item_in_a_step():
    rep = _lint(lambda x: x * float(x.sum().item()), torch.ones(3))
    assert any("host read" in f.message and "test_torch_audit.py" in f.message
               for f in rep.findings)


def test_r3_cpu_copy_in_a_step():
    rep = _lint(lambda x: x.cpu() + 1, torch.ones(3))
    assert any("copy to the host" in f.message for f in rep.findings)


def test_r3_data_dependent_shapes():
    rep = _lint(lambda x: torch.nonzero(x > 0), torch.ones(3))
    assert any("depends on data" in f.message for f in rep.findings)
    rep = _lint(lambda x: x[x > 0], torch.ones(3))
    assert any("index[bool]" in f.message for f in rep.findings)


def test_r3_narrow_reduction_dtype():
    rep = _lint(lambda x: torch.sum(x, dtype=torch.bfloat16), torch.ones(3))
    assert any("below fp32" in f.message for f in rep.findings)


def test_r3_reduced_precision_flag():
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    rep = _lint(lambda x: x @ x, torch.ones(3, 3))
    assert any("allow_bf16_reduced_precision_reduction" in f.message for f in rep.findings)


def test_r3_constants_and_clean_steps_pass():
    """A Python constant made a tensor and read back is host work, not a
    sync; nor is a clean step."""
    assert _lint(lambda x: x * float(torch.tensor(0.5)), torch.ones(3)).ok
    assert _lint(lambda x: torch.softmax(x, 0).sum(), torch.ones(3)).ok


def _reads_the_host(x):
    return x * float(x.mean().item())


def test_r3_waiver_names_the_site():
    site = A.site_of(__import__(__name__), "float(x.mean().item())")
    p = A.Program("step", expect={"allow": {site: "named"}})
    A.run_program(p, _reads_the_host, [torch.ones(3)], consumed=())
    rep = A.run_rules([p], rules={"R3"})
    assert rep.ok and rep.waived == [("R3", "step", site, "named")]


# ---------------------------------------------------------------------------
# R4 — what is built or loaded
# ---------------------------------------------------------------------------
def test_r4_a_third_chunk_shape_is_found():
    ok = A.Program("cache", chunk_shapes={4, 1}, expect={"chunk_shapes": {4, 1}})
    bad = A.Program("cache", chunk_shapes={4, 2, 1}, expect={"chunk_shapes": {4, 1}})
    assert A.run_rules([ok], rules={"R4"}).ok
    assert "chunk shapes [1, 2, 4]" in A.run_rules([bad], rules={"R4"}).findings[0].message
    loads = A.Program("w", library_loads=2)
    assert not A.run_rules([loads], rules={"R4"}).ok


def test_r4_the_engine_dispatches_two_chunk_shapes():
    progs = A.capture_serving_programs(slots=2, max_len=32, prefill_chunk=4)
    cache = [p for p in progs if p.chunk_shapes is not None]
    assert cache[0].chunk_shapes == {4, 1}
    rep = A.run_rules(progs)
    assert rep.ok, [str(f) for f in rep.findings]
    assert ("R2", "serve/decode_step") in rep.checked


def test_serving_capture_lets_the_engine_go():
    """The captured engine and its parameters are freed when the programs
    are made, without a cyclic collection (a 4-layer bf16 dbrx engine's
    26.6 GiB once outlived the audit on the card)."""
    import weakref
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("stablelm-1.6b")
    p = tree_map(lambda x: x[None], M.init_params(cfg, generator=torch.Generator().manual_seed(0)))
    leaf = weakref.ref(p["embed"]["table"])
    on = gc.isenabled()
    gc.disable()
    try:
        progs = A.capture_serving_programs(cfg, params=p, slots=2, max_len=32, prefill_chunk=4)
        del p
        assert leaf() is None
    finally:
        if on:
            gc.enable()
    assert A.run_rules(progs).ok


# ---------------------------------------------------------------------------
# R5 — static kernel checks
# ---------------------------------------------------------------------------
def _launch(**kw):
    base = dict(kernel="k", variant="v", shape={}, grid=(4, 4, 1), threads=256, smem_bytes=0)
    return A.KernelLaunch(**dict(base, **kw))


@pytest.mark.parametrize("kw,needle", [
    ({"smem_bytes": 240 * 1024}, "dynamic shared memory"),
    ({"grid": (4, 70_000, 1)}, "grid.y 70000"),
    ({"threads": 2048}, "threads a block"),
    ({"tiles": {"wgmma M": (96, 64, None)}}, "not a multiple of 64"),
    ({"tiles": {"wgmma N": (264, 8, 256)}}, "exceeds 256"),
    ({"boxes": ((512, 1),)}, "TMA box"),
    ({"strides": (200,)}, "stride 200"),
    ({"impl": "auto", "device": "cpu", "calls": 1, "launched": 1}, "impl='auto' on cpu"),
    ({"impl": "ref", "device": "cuda", "calls": 2, "launched": 1}, "impl='ref'"),
    ({"query": {"grid": (4, 4, 2), "threads": 256, "smem_bytes": 0}}, "kernel's own"),
])
def test_r5_red_team(kw, needle):
    rep = A.run_rules([], [_launch(**kw)], check_dispatch=False)
    assert not rep.ok and any(needle in f.message for f in rep.findings), rep.findings


def test_r5_every_path_shape_fits_the_card():
    recs = [A.launch_record(k, s) for k, s in A.PATH_SHAPES]
    rep = A.run_rules([], recs)
    assert rep.ok, [str(f) for f in rep.findings]
    assert {r.variant for r in recs} == {"auc_loss_kernel", "prox_update_multi_kernel",
                                         "opt_update_multi_kernel", "flash_fwd",
                                         "flash_fwd_pingpong",
                                         "flash_fwd_tf32x3", "gmm_rows", "gmm_tiles",
                                         "gmm_wgmma", "gmm_tf32x3", "gmm_wgmma_m128"}
    tf = next(r for r in recs if r.variant == "flash_fwd_tf32x3" and r.shape["hd"] == 128)
    assert tf.smem_bytes == 230_512                     # 1,936 B under the opt-in limit


def test_r5_records_the_128_row_kernel_at_dbrxs_bf16_prefill():
    """R5's record of the bf16 dbrx prefill's K5 calls: gmm_wgmma_m128's
    flattened grid of 128-row × 256-column tiles, two consumer warpgroups
    of 64 rows, its TMA boxes and w's strided view."""
    for Kd, F in ((6144, 10752), (10752, 6144)):
        rec = A.launch_record("grouped_matmul", {"N": 8192, "Kd": Kd, "G": 16, "F": F,
                                                 "dtype": torch.bfloat16})
        assert rec.variant == "gmm_wgmma_m128"
        assert rec.grid == ((8192 // 128 + 16) * (F // 256), 1, 1)
        assert (rec.threads, rec.smem_bytes) == (384, 197_696)
        assert rec.tiles == {"wgmma M (rows a consumer warpgroup)": (64, 64, 64),
                             "wgmma N (columns a tile)": (256, 8, 256)}
        assert rec.boxes == ((64, 128), (64, 64, 1, 1))
        assert rec.strides == (Kd * 2, F * 2, Kd * F * 2, 16 * Kd * F * 2)
        assert rec.shape["_query_keys"] == {"bm": 128, "bn": 256,
                                            "tma_boxes": ((64, 128), (64, 64, 1, 1))}
        assert not A.launch_problems(rec)


@pytest.mark.parametrize("B,S,H,KV,hd,grid,threads,bk", [
    (4, 2048, 32, 32, 64, (11 * 32 * 4, 1, 1), 512, 128),   # stablelm prefill: a block an item
    (4, 2048, 40, 10, 128, (132, 1, 1), 384, 128),          # phi3 prefill: persistent
    (128, 64, 32, 32, 64, (132, 1, 1), 384, 64),            # stablelm training: two heads an item
    (128, 64, 25, 5, 64, (132, 1, 1), 384, 64),             # hymba training: odd H
])
def test_r5_records_the_pingpong_attention(monkeypatch, B, S, H, KV, hd, grid, threads, bk):
    """R5's record of a bf16 K4 call at a path shape: flash_fwd_pingpong's
    grid (a block a 192-row item at head_dim 64, else a persistent block an
    SM of the card's, here an H100 SXM's 132), consumer warpgroups of 64
    rows, its q and K/V boxes and the tensors' strides."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "_sm_count", lambda: 132)
    rec = A.launch_record("flash_attention", {"B": B, "S": S, "H": H, "KV": KV, "Skv": S,
                                              "hd": hd, "dtype": torch.bfloat16})
    assert rec.variant == "flash_fwd_pingpong"
    assert rec.grid == grid and rec.threads == threads
    assert rec.smem_bytes == {64: 156_848, 128: 164_960}[hd]
    assert rec.tiles == {"wgmma M (rows a consumer warpgroup)": (64, 64, None),
                         "wgmma N (keys of q·kᵀ)": (bk, 8, 256),
                         "wgmma N (dims of P·V)": (hd, 8, 256)}
    assert rec.boxes == ((64, 1, 64, 1), (64, 1, bk, 1))
    assert rec.strides == (hd * 2, H * hd * 2, S * H * hd * 2, hd * 2, KV * hd * 2,
                           S * KV * hd * 2)
    assert rec.shape["_query_keys"] == {"bq": 64 * (threads // 128 - 1), "bk": bk,
                                        "stages": {64: 4, 128: 2}[hd], "tma_box": (64, 1, bk, 1)}
    assert not A.launch_problems(rec)


def test_r5_dispatch_seam():
    assert A.dispatch_problems() == []


def test_k2_k3_geometry_is_the_grid_stride_launch():
    """K2/K3 are one multi-tensor launch over a step's leaves: a block a
    tile (4096 elements of an fp32 v, 8192 of a bf16 one), empty leaves
    skipped, 384 leaves a launch; the R5 records of a step's leaf set carry
    the launches a call."""
    from repro_torch.kernels import opt_update, prox_update
    for mod in (prox_update, opt_update):
        assert mod.launch_geometry([1000], [0])["grid"] == (1,)
        assert mod.launch_geometry([9_437_184], [0])["grid"] == (2304,)
        assert mod.launch_geometry([0], [0])["launches"] == 0
        two = mod.launch_geometry([5000, 0, 9000], [0, 0, 0])
        assert two["launches"] == 1 and two["grid"] == (2 + 3,) and two["chunks"] == [[0, 2]]
    assert prox_update.launch_geometry([9000], [1])["grid"] == (2,)      # bf16 v
    assert opt_update.launch_geometry([9000], [1])["grid"] == (3,)       # fp32 v, bf16 buffer
    rn = A.launch_record("prox_update", {"tree": "resnet50"})
    assert len(rn.shape["sizes"]) == 153 and rn.per_call == 1
    past = A.launch_record("prox_update", {"sizes": (10,) * 385, "codes": (0,) * 385})
    assert past.per_call == 2 and past.shape["_query_keys"] == {"launches": 2}


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def test_report_aggregation_and_json():
    import json
    progs = [_prog("a", [], {"kind": "none"}),
             _prog("b", [("all_reduce", "f32", 4)], {"kind": "none"}),
             _pair([], {"kind": "ring", "n_hops": 0, "n_chains": 0, "hop_len": 0})]
    rep = A.run_rules(progs, rules={"R1"})
    d = json.loads(rep.to_json())
    assert d["ok"] is False and d["n_findings"] == 1 and d["n_checked"] == 3
    assert d["rules"]["R1"]["checked"] == ["a", "b", "pair"]
    assert d["rules"]["R1"]["findings"][0]["program"] == "b"
    assert set(d["rules"]["R1"]) == {"checked", "findings", "waived"}
    with pytest.raises(AssertionError, match="audit failed"):
        rep.raise_if_failed()
    A.run_rules([progs[0]], rules={"R1"}).raise_if_failed()


def test_collective_bytes_from_the_wire_log():
    out = roofline.collective_bytes([("all_reduce", "f32", 400), ("all_reduce", "bf16", 200),
                                     ("p2p", "f32", 8)])
    assert out["all_reduce"] == {"bytes": 600, "count": 2, "by_dtype": {"f32": 400, "bf16": 200}}
    assert (out["total_bytes"], out["total_count"]) == (608, 3)
    t = roofline.roofline_terms(989e12, 3.35e12, 0, 1)
    assert t["compute_s"] == pytest.approx(1.0) and t["memory_s"] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# the real stack
# ---------------------------------------------------------------------------
def test_cli_matrix_passes_on_one_rank():
    art = LA.run_matrix("cpu", n_devices=1, smoke=True, verbose=False)
    assert art["ok"], [r for r in art["legs"] if not r["ok"]]
    names = {r["leg"] for r in art["legs"]}
    assert {"serving/chunk_step", "kernels/auto", "kernels/ref", "opt/shampoo_blocked/vmap"} \
        <= names
    for r in art["legs"]:
        want = {"R1", "R2", "R3", "R4", "R5"}
        assert want <= set(r["rules"]), (r["leg"], sorted(r["rules"]))
        if r["leg"].endswith("/overlap") or "/overlap/" in r["leg"]:
            # R1's compute half is checked: the pair program's findings are R1's too
            assert any(p.endswith("/pair") for p in r["rules"]["R1"]["checked"])


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_real_stack_passes_and_smuggled_all_reduce_fails(n_ranks):
    import _torch_audit_ranks as T
    ok = PM.run_ranks(T.rank_legs, n_ranks, (n_ranks, False), backend="gloo")
    assert all(r["ok"] for r in ok), [r for r in ok if not r["ok"]]
    bad = PM.run_ranks(T.rank_legs, n_ranks, (n_ranks, True), backend="gloo")
    msgs = [f for r in bad for f in r["rules"]["R1"]["findings"]]
    assert any(f["program"].endswith("/local_steps") and "collective-free" in f["message"]
               for f in msgs)
    assert not any(r["ok"] for r in bad)


# ---------------------------------------------------------------------------
# every leg's R1 expectation against the reference's own accounting
# ---------------------------------------------------------------------------
def _ref_state(K, kw):
    from repro.core import coda as RC
    from repro.configs.base import mlp_config as ref_mlp
    import jax.numpy as jnp
    kw = dict(kw)
    if kw.get("opt_dtype") is not None:
        kw["opt_dtype"] = jnp.bfloat16
    ccfg = RC.CoDAConfig(n_workers=K, **kw)
    return ccfg, RC.init_state(jax.random.PRNGKey(0), ref_mlp(n_features=16, d=32), ccfg)


def _leg_kwargs(leg):
    ccfg = LA._ccfg(leg, 4)
    kw = {"algorithm": ccfg.algorithm, "avg_compress": ccfg.avg_compress,
          "overlap_chunks": ccfg.overlap_chunks, "participation": ccfg.participation,
          "straggler_prob": ccfg.straggler_prob, "max_staleness": ccfg.max_staleness}
    if leg.optimizer:
        kw = {"optimizer": ccfg.optimizer, "opt_dtype": "bf16", "shampoo_block": 16,
              "precond_every": 2}
    return ccfg, kw


TRAINING = [leg for leg in LA.build_legs(4) if leg.kind == "training" and not leg.workers]


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("leg", TRAINING, ids=[leg.name for leg in TRAINING])
def test_leg_expectations_equal_the_reference(leg, R):
    from repro.core import bucketing as RB
    from repro.core import coda as RC
    import jax.numpy as jnp
    ccfg, kw = _leg_kwargs(leg)
    K = ccfg.n_workers
    st = PC.init_state(MCFG, ccfg, generator=torch.Generator().manual_seed(0))
    ring = PB.RingSpec(R, ccfg.overlap_chunks) if ccfg.overlap_chunks else None
    got = A.training_expectations(st, ccfg, wired=True, k_loc=K // R, ring=ring)
    rccfg, rst = _ref_state(K, kw)
    masked = rccfg.faults_enabled
    assert got["local_steps"] == {"kind": "none"}
    w = got["window"]
    if ccfg.avg_compress == "int8":
        assert w["payload_bytes"] == RC.window_payload_bytes(rst, "int8", masked=masked)
        assert w["n_rows"] * R == K
    else:
        assert w["expected_bytes"] == RC.window_payload_bytes(rst, masked=masked)
        assert w["by_dtype"] == RC.window_payload_by_dtype(rst, masked=masked)
        assert w.get("opt_bytes", 0) == RC.opt_state_bytes(rst)
    sb = RC.stage_payload_bytes(rccfg)
    assert got["stage"] == {"kind": "window", "expected_bytes": sb, "by_dtype": {"f32": sb}}
    if ring is not None:
        mats, _, _ = RB._state_mats(rst)
        if "cv_params" in rst:
            mats = mats * 2
        if masked:
            mats = mats + [jnp.zeros((K, 2 if "cv_params" in rst else 1), jnp.float32)]
        sizes = RB.bucket_sizes(mats)
        rring = RB.RingSpec("data", R, ccfg.overlap_chunks)
        assert got["pair"]["n_hops"] == 2 * RB.ring_hop_count(sizes, rring)
        assert got["pair"]["n_chains"] == 2 * RB.ring_chain_count(sizes, rring)
        assert got["pair"]["hop_len"] == 2 * (R - 1)
        assert np.all([n > 0 for n in sizes.values()])
