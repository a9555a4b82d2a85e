"""The port's ssm family (xlstm-350m) vs ``repro`` on the smoke config,
part 2 (the layers and serving are tests/test_torch_xlstm.py): one local
step's gradient against ``jax.grad``, one CoDA window each with sgd, sm3
and shampoo_blocked against the reference's ``window_step``, sm3's axis
rules over the xLSTM leaves, bf16 through mLSTM → sLSTM → mLSTM, the
arch-smoke forward and window, a checkpoint round trip of an ssm state, and
the launcher's schedule, bytes per round and depth cut.

Tolerances: those of tests/_torch_zoo.py (fp32 atol = rtol = 1e-5); each
test states its own where it differs.  About 55 s in one process.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo import one_torch_thread  # noqa: F401  (this module's autouse fixture)
from _torch_zoo import (K, cfgs, check_arch_smoke_forward_and_coda_step, check_depth_cut,
                        check_launcher_accounting, check_sm3_axis_rules, close, init_state_np,
                        inputs, jx_tree, np_tree, rule, stacked, tt, vmapped, widen)
from repro.checkpoint import checkpoint as jckpt
from repro.core import coda as JC
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import coda as C
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves

ARCH = "xlstm-350m"
# mLSTM, sLSTM, mLSTM: the sLSTM's fp32 output reaches a later layer
THREE = {"n_layers": 3, "slstm_every": 2}


def test_local_step_gradient_matches_reference():
    """One local step's losses and primal and dual gradients on K=3 workers
    over mLSTM → sLSTM → mLSTM against ``jax.grad`` (``grad_step``): losses
    at the fp32 tolerance, the gradients at atol 1e-5, rtol 1e-4 (the tie
    rules of the maxima would show here).  The step's update is held with
    the window below."""
    jcfg, cfg = cfgs(ARCH, **THREE)
    jccfg = JC.CoDAConfig(n_workers=3, p_pos=0.7)
    ccfg = C.CoDAConfig(n_workers=3, p_pos=0.7)
    jst = init_state_np(jcfg, jccfg, 9)
    st = P.state_from_jax(cfg, ccfg, jst)
    batch = inputs(cfg, (3, 4), 9, labels=True)
    jl, (jgp, jgd) = jax.jit(lambda s_, b_: JC.grad_step(jcfg, jccfg, s_, b_))(
        jx_tree(jst), jx_tree(batch))
    loss, (gp, gd), _ = C.grad_step_scores(cfg, ccfg, st, tt(batch))
    close(loss, jl)
    for g, w in zip(jax.tree_util.tree_leaves(P.to_jax_params(cfg, gp)),
                    jax.tree_util.tree_leaves(np_tree(jgp)), strict=True):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    for k in jgd:
        close(gd[k], jgd[k])


# per optimizer: the parameters' tolerance, then each optimizer-state
# field's (sm3: the accumulator list; Shampoo: the statistics "s" and the
# preconditioners "p")
WINDOW_TOL = {
    "sgd": ({"atol": 1e-5}, {}),
    "sm3": ({"atol": 5e-4}, {None: {"rtol": 1e-3, "atol": 1e-6}}),
    "shampoo_blocked": ({"atol": 2e-5}, {"s": {"rtol": 1e-4, "atol": 1e-4},
                                         "p": {"rtol": 0, "atol": 0.05}}),
}


@pytest.mark.parametrize("optimizer", ["sgd", "sm3", "shampoo_blocked"])
def test_window_step_matches_reference(optimizer):
    """One CoDA window (I = 2 local steps, then the average) on K=2 workers
    against the reference's ``window_step``; the losses at atol 1e-5, sgd's
    parameters at atol 1e-5.  The preconditioned optimizers take the same
    gradients to fp32 rounding (the embedding rows, sums over many tokens,
    ~1e-6 apart: ``test_local_step_gradient_matches_reference``) and
    scale that rounding up where a gradient is near zero: sm3 steps by
    g/√(ν+ε) (ε = 1e-4 here), parameters at atol 5e-4, accumulators (sums
    of g²) at rtol 1e-3; Shampoo (8-wide blocks over the reference's
    flattening of every leaf, ``r`` included; the inverse roots refreshed at
    the first step and kept at the second) parameters at atol 2e-5,
    statistics at rtol 1e-4, preconditioners — whose entries reach
    1/√ε = 1000 on blocks of near-zero statistics — at atol 0.05.  With the
    same gradients both hold tighter
    (``test_sm3_axis_rules_take_the_xlstm_leaves``)."""
    kw = {"sgd": {}, "sm3": {"optimizer": "sm3", "opt_eps": 1e-4},
          "shampoo_blocked": {"optimizer": "shampoo_blocked", "shampoo_block": 8,
                              "precond_every": 2}}[optimizer]
    jcfg, cfg = cfgs(ARCH)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    jst = init_state_np(jcfg, jccfg, 10)
    st = P.state_from_jax(cfg, ccfg, jst)
    wb = inputs(cfg, (2, K, 4), 10, labels=True)
    jnew, jl = jax.jit(lambda s_, b_: JC.window_step(jcfg, jccfg, s_, b_, 0.3))(
        jx_tree(jst), jx_tree(wb))
    new, losses = C.window_step(cfg, ccfg, st, tt(wb), 0.3)
    close(losses, jl)
    got, want = P.state_to_jax(cfg, new, ccfg), np_tree(jnew)
    ptol, otol = WINDOW_TOL[optimizer]
    for g, w in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(want["params"]), strict=True):
        np.testing.assert_allclose(g, w, rtol=0, err_msg="params", **ptol)
    if optimizer == "sgd":
        return
    np.testing.assert_array_equal(got["opt"]["t"], want["opt"]["t"])
    for g, w in zip(got["opt"]["leaves"], want["opt"]["leaves"], strict=True):
        for field, tol in otol.items():
            for a, b in zip(jax.tree_util.tree_leaves(g if field is None else g[field]),
                            jax.tree_util.tree_leaves(w if field is None else w[field]),
                            strict=True):
                np.testing.assert_allclose(a, b, err_msg=str(field), **tol)


def test_sm3_axis_rules_take_the_xlstm_leaves():
    """The same gradients through both packages' sm3 ``apply_grads``: no
    leaf is permuted (``r [K, 4, H, hd, hd]`` is not a convolution), the
    accumulators bitwise, the parameters at atol 1e-6
    (``check_sm3_axis_rules``); Shampoo's statistics over 5-D leaves are
    held bitwise on the moe family's experts (tests/test_torch_moe.py)."""
    check_sm3_axis_rules(ARCH)


def test_bf16_three_layers_as_the_reference_runs_it():
    """bf16 weights through mLSTM → sLSTM → mLSTM: the sLSTM's fp32 carry
    promotes its output, so the residual stream is fp32 from layer 1 on in
    both packages.  The hidden states and scores under the bf16 rule
    against the reference's bf16 and fp32 runs on the same weights."""
    jcfg, cfg = cfgs(ARCH, **THREE)
    t16 = stacked(jcfg, K, 12, dtype=jnp.bfloat16)
    p16 = P.from_jax_params(cfg, t16)
    assert p16["layers"][1]["core"]["r"].dtype == torch.bfloat16
    assert p16["layers"][1]["core"]["b_in"].dtype == torch.float32
    b = inputs(cfg, (K, 3), 12, S=16)
    h16, _ = vmapped(lambda p_, b_: JM.backbone(jcfg, p_, b_), t16, b)
    h32, _ = vmapped(lambda p_, b_: JM.backbone(jcfg, p_, b_), widen(t16), b)
    h, _ = M.backbone(cfg, p16, tt(b))
    assert h.dtype == torch.float32 and h16.dtype == jnp.float32
    rule(h, h16, h32, "hidden")
    s16, _ = vmapped(lambda p_, b_: JM.score(jcfg, p_, b_), t16, b)
    s32, _ = vmapped(lambda p_, b_: JM.score(jcfg, p_, b_), widen(t16), b)
    rule(M.score(cfg, p16, tt(b))[0], s16, s32, "scores")


def test_forward_and_coda_step():
    """tests/test_arch_smoke.py::test_forward_and_coda_step[xlstm-350m]."""
    check_arch_smoke_forward_and_coda_step(ARCH)


def test_checkpoint_round_trip_of_an_ssm_state(tmp_path):
    """An sm3 CoDA state of the ssm family written by the reference's
    checkpoint restores into the port bitwise, and back."""
    jcfg, cfg = cfgs(ARCH)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, optimizer="sm3")
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, optimizer="sm3")
    jst = JC.init_state(jax.random.PRNGKey(15), jcfg, jccfg)
    jckpt.save(str(tmp_path / "ref"), 3, {"state": jst})
    template = {"state": C.init_state(cfg, ccfg)}
    got = ckpt.restore(str(tmp_path / "ref"), 3, template)["state"]
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(jst), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ckpt.save(str(tmp_path / "port"), 4, {"state": got})
    back = jckpt.restore(str(tmp_path / "port"), 4, {"state": jst})["state"]
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jst),
                    strict=True):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_launcher_schedule_and_bytes_per_round(capsys):
    """``--arch xlstm-350m --smoke``: the reference launcher's schedule and
    bytes per round (the 411,525 parameters and 3 duals)."""
    out = check_launcher_accounting(ARCH, capsys)
    assert f"bytes/round/worker={(411_525 + 3) * 4:,} " in out
    assert "model: xlstm-350m params/worker=411,525 leaves=" in out


def test_launcher_cuts_the_depth(capsys):
    check_depth_cut(ARCH, capsys)
