"""CoDA — Communication-efficient Distributed primal-dual training (Alg. 1+2),
counterpart of ``repro.core.coda``.

The training state is a plain dict

    {"params": tree, "duals": {field: [K]}, "ref_params": tree,
     "ref_duals": {field: [K]}}

where every parameter leaf carries a leading worker axis K (``params[k]`` is
machine k's replica), plus ``opt`` for a stateful optimizer
(``core/optimizer.py``: never averaged, never in the payload) and, with
``stream_bins > 0``, the streaming sketch ``sk_acc`` / ``sk_new`` /
``sk_loc`` ({"pos", "neg"}: [K, bins] fp32 counts; see
``metrics/streaming.py``).  A local step runs every worker at once: one batched
forward over ``[K, B, ...]`` inputs, one ``auc_loss`` launch over the
``[K, B]`` scores, autograd of ``losses.sum()`` (the workers are
independent, so the sum gives each worker its own gradient — a mean would
scale them by 1/K), then the optimizer's update: one ``prox_update``
launch per parameter leaf (sgd, shampoo_blocked) or one ``opt_update``
launch per leaf (momentum, sm3).  The periodic averaging is a mean over
axis 0, broadcast back; with the sketch on it also folds the per-worker
deltas into the accumulator.

Updates are out of place: every step returns new tensors and never writes
into the old ones, so ``ref_params`` may share buffers with ``params``
after ``stage_end`` (``init_state`` still gives it its own copy, as the
reference does).

Ported: ``algorithm="coda"`` with the ``auc`` objective over the mlp, cnn,
dense and moe families (token batches ``[K, B, S]``; ``use_window`` and
``impl`` reach ``M.score`` as in the reference; an moe local step adds
``moe_aux_coef`` times the load-balance loss and dispatches by capacity,
its stage-end α batches by ``cfg.moe.dispatch`` through K5), every
optimizer (sgd, momentum, sm3, shampoo_blocked; moe: sgd and momentum),
the streaming sketch, plain or int8-compressed averaging, and the
worker-batched executor (the reference's ``VmapExecutor``).  Every other
``CoDAConfig`` feature raises ``NotImplementedError`` naming its ROADMAP
item — it never silently trains plain CoDA.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import objective, optimizer, schedules
from repro_torch.metrics import streaming
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class CoDAConfig:
    """Every field and validation of ``repro.core.coda.CoDAConfig``; dtypes
    are torch dtypes."""

    n_workers: int
    gamma: float = 0.5
    p_pos: float = 0.5
    moe_aux_coef: float = 0.01
    use_window: bool = False
    impl: str = "auto"            # kernel dispatch (see kernels.ops)
    avg_compress: str = ""        # "" | "int8"
    algorithm: str = "coda"       # "coda" | "codasca"
    objective: str = "auc"
    pauc_beta: float = 0.3
    server_momentum: float = 0.0
    overlap_chunks: int = 0
    stream_bins: int = 0
    stream_range: tuple[float, float] = (-8.0, 8.0)
    participation: float = 1.0
    straggler_prob: float = 0.0
    straggler_windows: int = 1
    max_staleness: int = 0
    staleness_discount: float = 0.5
    fault_seed: int = 0
    crashes: tuple = ()
    param_dtype: Any = torch.float32
    optimizer: str = "sgd"
    opt_dtype: Any = torch.float32
    opt_beta: float = 0.9
    opt_eps: float = 1e-6
    shampoo_block: int = 32
    precond_every: int = 1

    @property
    def faults_enabled(self) -> bool:
        return (self.participation < 1.0 or self.straggler_prob > 0.0
                or bool(self.crashes))

    def __post_init__(self):
        # the reference's validations, in its order
        if self.algorithm not in ("coda", "codasca"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.avg_compress not in ("", "int8"):
            raise ValueError(f"unknown avg_compress {self.avg_compress!r}")
        if self.objective not in objective.names():
            raise ValueError(f"unknown objective {self.objective!r} "
                             f"(registered: {objective.names()})")
        if not 0.0 <= self.server_momentum < 1.0:
            raise ValueError("server_momentum must be in [0, 1), got "
                             f"{self.server_momentum}")
        if not 0.0 < self.pauc_beta <= 1.0:
            raise ValueError(f"pauc_beta must be in (0, 1], got "
                             f"{self.pauc_beta}")
        if self.overlap_chunks < 0:
            raise ValueError(f"overlap_chunks must be >= 0, got "
                             f"{self.overlap_chunks}")
        if self.overlap_chunks and self.avg_compress:
            raise ValueError("overlapped ring averaging ships plain dtype "
                             "buckets; it cannot be combined with "
                             f"avg_compress={self.avg_compress!r}")
        if self.stream_bins < 0:
            raise ValueError(f"stream_bins must be >= 0, got "
                             f"{self.stream_bins}")
        if self.stream_bins and self.avg_compress:
            raise ValueError("the streaming-eval sketch ships raw fp32 "
                             "counts (int8 rounding would corrupt them); it "
                             "cannot be combined with "
                             f"avg_compress={self.avg_compress!r}")
        if self.stream_bins and not self.stream_range[1] > self.stream_range[0]:
            raise ValueError(f"stream_range must satisfy hi > lo, got "
                             f"{self.stream_range}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation must be in (0, 1], got "
                             f"{self.participation}")
        if not 0.0 <= self.straggler_prob < 1.0:
            raise ValueError(f"straggler_prob must be in [0, 1), got "
                             f"{self.straggler_prob}")
        if self.straggler_windows < 1:
            raise ValueError(f"straggler_windows must be >= 1, got "
                             f"{self.straggler_windows}")
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got "
                             f"{self.max_staleness}")
        if not 0.0 < self.staleness_discount <= 1.0:
            raise ValueError(f"staleness_discount must be in (0, 1], got "
                             f"{self.staleness_discount}")
        if self.faults_enabled and self.server_momentum:
            raise ValueError(
                "server momentum keeps a replicated buffer that assumes "
                "every worker holds the synced iterate after each window; "
                "it cannot be combined with partial participation / fault "
                "injection (participation < 1, stragglers, or crashes)")
        if self.optimizer not in optimizer.names():
            raise ValueError(f"unknown optimizer {self.optimizer!r} "
                             f"(registered: {optimizer.names()})")
        if self.opt_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("opt_dtype must be float32 or bfloat16, got "
                             f"{self.opt_dtype}")
        if not 0.0 <= self.opt_beta < 1.0:
            raise ValueError(f"opt_beta must be in [0, 1), got "
                             f"{self.opt_beta}")
        if self.opt_eps <= 0.0:
            raise ValueError(f"opt_eps must be > 0, got {self.opt_eps}")
        if self.shampoo_block < 1:
            raise ValueError(f"shampoo_block must be >= 1, got "
                             f"{self.shampoo_block}")
        if self.precond_every < 1:
            raise ValueError(f"precond_every must be >= 1, got "
                             f"{self.precond_every}")
        self._reject_unported()

    def _reject_unported(self):
        """Valid but not ported yet: raise rather than train plain CoDA."""
        unported = [
            (self.algorithm != "coda", f"algorithm={self.algorithm!r}",
             "Queue 1 item 8 (CODASCA)"),
            (self.objective != "auc", f"objective={self.objective!r}",
             "Queue 1 item 3 (objectives)"),
            (self.faults_enabled or self.max_staleness != 0
             or self.straggler_windows != 1 or self.staleness_discount != 0.5
             or self.fault_seed != 0,
             "fault injection knobs", "Queue 1 item 8 (faults)"),
            (self.overlap_chunks != 0, f"overlap_chunks={self.overlap_chunks}",
             "Queue 1 item 10 (distributed executor)"),
            (self.server_momentum != 0.0,
             f"server_momentum={self.server_momentum}",
             "Queue 1 item 8 (server momentum)"),
            (self.param_dtype != torch.float32,
             f"param_dtype={self.param_dtype}", "Queue 1 item 4 (bf16 params)"),
        ]
        for bad, what, item in unported:
            if bad:
                raise NotImplementedError(
                    f"CoDAConfig {what} is not ported to repro_torch yet "
                    f"(ROADMAP {item})")


CoDAState = dict[str, Any]


def _stack(params, K: int):
    return tree_map(lambda x: x[None].expand((K,) + x.shape).clone(), params)


def init_state(mcfg: ModelConfig, ccfg: CoDAConfig, *,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cpu") -> CoDAState:
    """A fresh state: one replica of ``M.init_params`` stacked K times,
    ``ref_params`` in buffers of its own, the zero sketch counts when
    ``stream_bins > 0``, and the optimizer's initial state."""
    if mcfg.family == "moe" and ccfg.optimizer in ("sm3", "shampoo_blocked"):
        # their state follows the reference's axis order through
        # params.ref_order, which reads every 5-D leaf as a convolution
        raise NotImplementedError(
            f"optimizer {ccfg.optimizer!r} on the moe family is not ported yet "
            "(ROADMAP Queue 1 item 11: the expert leaves' axis order)")
    params = M.init_params(mcfg, generator=generator, dtype=ccfg.param_dtype,
                           device=device)
    K = ccfg.n_workers
    obj = objective.for_config(ccfg)
    duals = obj.init_duals(K, device)
    state = {
        "params": _stack(params, K),
        "duals": duals,
        "ref_params": _stack(params, K),
        "ref_duals": {f: torch.zeros_like(duals[f]) for f in obj.prox_refs},
    }
    if ccfg.stream_bins:
        # sk_acc: the replicated global counts; sk_new: each worker's delta
        # since the last average; sk_loc: each worker's own merged deltas
        z = lambda: torch.zeros((K, ccfg.stream_bins), dtype=torch.float32,
                                device=device)
        for k in ("sk_acc", "sk_new", "sk_loc"):
            state[k] = {"pos": z(), "neg": z()}
    opt = optimizer.for_config(ccfg).init(ccfg, state["params"])
    if opt is not None:
        state["opt"] = opt
    return state


# --------------------------------------------------------------------------
# local primal-dual step (Algorithm 2, lines inside the I-window)
# --------------------------------------------------------------------------
def _worker_loss(mcfg, ccfg, obj, params, duals, batch):
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    h, aux = M.score(mcfg, params, inputs, use_window=ccfg.use_window,
                     train=True, impl=ccfg.impl)
    f = obj.loss(h, batch["labels"], duals, impl=ccfg.impl)
    return f + ccfg.moe_aux_coef * aux, h


def grad_step_scores(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState,
                     batch):
    """Per-worker losses [K], raw primal/dual gradients (gp, gduals), and
    the batch scores h [K, B].  A leaf the loss does not reach (the dense
    family's ``lm_head``) gets a zero gradient, as ``jax.grad`` gives it."""
    obj = objective.for_config(ccfg)
    leaves = [l.detach().requires_grad_(True)
              for l in tree_leaves(state["params"])]
    params = tree_unflatten(state["params"], leaves)
    duals = {k: v.detach().requires_grad_(True)
             for k, v in state["duals"].items()}
    wrt = leaves + list(duals.values())
    with torch.enable_grad():
        losses, hs = _worker_loss(mcfg, ccfg, obj, params, duals, batch)
        grads = torch.autograd.grad(losses.sum(), wrt, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
    gp = tree_unflatten(state["params"], grads[:len(leaves)])
    gd = dict(zip(duals, grads[len(leaves):]))
    return losses.detach(), (gp, gd), hs.detach()


def apply_grads(ccfg: CoDAConfig, state: CoDAState, grads, eta) -> CoDAState:
    """Proximal primal descent (through the optimizer seam) + the
    objective's dual step."""
    gp, gd = grads
    obj = objective.for_config(ccfg)
    opt = optimizer.for_config(ccfg)
    new_params, new_opt = opt.step(ccfg, state.get("opt"), state["params"],
                                   gp, state["ref_params"], eta)
    new_state = dict(state)
    new_state["params"] = new_params
    if new_opt is not None:
        new_state["opt"] = new_opt
    new_state["duals"] = obj.dual_step(state["duals"], gd,
                                       state["ref_duals"], eta, ccfg.gamma)
    return new_state


def local_step(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState, batch,
               eta) -> tuple:
    """One local primal-dual update on every worker (no communication).
    ``batch``: leading [K, per_worker_batch, ...] axes.  Returns
    (new_state, per-worker losses [K]).  With the sketch on, the scores the
    loss already computed go into the per-worker deltas."""
    losses, grads, hs = grad_step_scores(mcfg, ccfg, state, batch)
    new = apply_grads(ccfg, state, grads, eta)
    if "sk_new" in state:
        new["sk_new"] = sketch_update(ccfg, state["sk_new"], hs, batch["labels"])
    return new, losses


def sketch_update(ccfg: CoDAConfig, sk, hs, labels):
    """Scatter one local step's scores [K, B] into the per-worker sketch
    deltas ({"pos": [K, bins], "neg": [K, bins]})."""
    lo, hi = ccfg.stream_range
    pos, neg = streaming.update_counts(sk["pos"], sk["neg"], hs, labels, lo, hi)
    return {"pos": pos, "neg": neg}


def int8_quantize(xf, red_axes):
    """Max-abs int8 quantizer: per-tensor fp32 scale over ``red_axes``,
    payload in [-127, 127].  Empty ``red_axes`` (a [K] dual) gives each
    element its own scale, as ``jnp.max(axis=())`` does; ``torch.amax``
    would reduce over every axis instead."""
    absx = torch.abs(xf)
    scale = (torch.amax(absx, dim=red_axes, keepdim=True) if red_axes
             else absx) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def average(state: CoDAState, compress: str | None = None) -> CoDAState:
    """Periodic model averaging over the worker axis (params and duals);
    ``compress="int8"`` averages each worker's int8-quantized replica."""
    if compress == "int8":
        def avg(x):
            xf = x.to(torch.float32)
            q, scale = int8_quantize(xf, tuple(range(1, x.dim())))
            deq = q.to(torch.float32) * scale
            m = torch.mean(deq, dim=0, keepdim=True)
            return m.expand(x.shape).to(x.dtype).contiguous()
    else:
        def avg(x):
            return torch.mean(x, dim=0, keepdim=True).expand(x.shape).contiguous()
    new = dict(state)
    new["params"] = tree_map(avg, state["params"])
    new["duals"] = {k: avg(v) for k, v in state["duals"].items()}
    if "sk_new" in state:
        new = merge_sketch(new)
    return new


def merge_sketch(state: CoDAState) -> CoDAState:
    """Fold the per-worker sketch deltas into the replicated accumulator at
    a window average: sk_acc += Σ_k sk_new[k], sk_loc[k] += sk_new[k], then
    reset the deltas.  Exact: integer-valued fp32 counts below 2²⁴."""
    new = dict(state)
    new["sk_acc"] = {k: state["sk_acc"][k] + state["sk_new"][k].sum(0, keepdim=True)
                     for k in ("pos", "neg")}
    new["sk_loc"] = {k: state["sk_loc"][k] + state["sk_new"][k] for k in ("pos", "neg")}
    new["sk_new"] = {k: torch.zeros_like(v) for k, v in state["sk_new"].items()}
    return new


def window_step(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState,
                window_batch, eta, *, communicate: bool = True):
    """``I`` local steps + (optionally) one averaging.  ``window_batch``
    leaves: [I, K, per_worker_batch, ...].  Returns (state, losses [I],
    each the mean over workers)."""
    I = window_batch["labels"].shape[0]
    losses = []
    for i in range(I):
        state, loss = local_step(mcfg, ccfg, state,
                                 {k: v[i] for k, v in window_batch.items()},
                                 eta)
        losses.append(loss)
    if communicate:
        state = average(state, compress=ccfg.avg_compress or None)
    return state, torch.stack(losses).mean(dim=1)


# --------------------------------------------------------------------------
# stage boundary (Algorithm 1, lines 4–7 + proximal reference update)
# --------------------------------------------------------------------------
def estimate_stage_duals(mcfg: ModelConfig, ccfg: CoDAConfig, params, duals,
                         batch):
    """Every worker's stage-boundary dual re-estimates ({field: [K]}) from
    a fresh minibatch."""
    obj = objective.for_config(ccfg)
    if not obj.stage_fields:
        return {}
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        h, _ = M.score(mcfg, params, inputs, use_window=ccfg.use_window,
                       train=False, impl=ccfg.impl)
    return obj.stage_duals(h, batch["labels"], duals)


def stage_end(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState, batch,
              *, resync: bool = True):
    """Re-estimate the stage duals on every worker, worker-mean them, and
    move the proximal references to the (averaged) iterate.  ``resync=False``
    (what the executor passes) skips the redundant re-average: every window
    already ends in one."""
    obj = objective.for_config(ccfg)
    if resync:
        state = average(state)
    upd = estimate_stage_duals(mcfg, ccfg, state["params"], state["duals"],
                               batch)
    new_duals = dict(state["duals"])
    for f, v in upd.items():
        new_duals[f] = torch.mean(v, dim=0, keepdim=True).expand(v.shape).contiguous()
    new = dict(state)
    new["duals"] = new_duals
    new["ref_params"] = state["params"]   # safe: updates are out of place
    new["ref_duals"] = {f: state["duals"][f] for f in obj.prox_refs}
    return new


# --------------------------------------------------------------------------
# accounting + driver
# --------------------------------------------------------------------------
def _payload_leaves(state: CoDAState):
    return tree_leaves({"params": state["params"], "duals": state["duals"]})


def model_bytes(state: CoDAState, compress: str | None = None) -> int:
    """Bytes one worker ships per averaging round (params + dual tree);
    int8: 1 B/element + one fp32 scale per tensor."""
    leaves = _payload_leaves(state)
    if compress == "int8":
        return sum(l.numel() // l.shape[0] for l in leaves) + len(leaves) * 4
    return sum(l.numel() // l.shape[0] * l.element_size() for l in leaves)


def opt_state_bytes(state: CoDAState) -> int:
    """Per-worker optimizer-state bytes (``state["opt"]``; 0 for sgd).
    Local bytes only: never in a window payload."""
    return optimizer.state_bytes(state.get("opt"))


def streaming_payload_bytes(state: CoDAState) -> int:
    """Extra fp32 bytes the sketch adds to the window collective: the
    per-worker deltas ``sk_new`` (2·stream_bins·4); 0 when it is off."""
    if "sk_new" not in state:
        return 0
    return sum(l.numel() // l.shape[0] * 4 for l in state["sk_new"].values())


def window_payload_bytes(state: CoDAState, compress: str | None = None) -> int:
    """Bytes one worker ships in the single window all-reduce: CoDA's
    ``model_bytes`` plus the sketch deltas when the sketch is on."""
    return model_bytes(state, compress) + streaming_payload_bytes(state)


def stage_payload_bytes(ccfg: CoDAConfig) -> int:
    """One fp32 scalar per objective ``stage_fields`` entry."""
    return 4 * len(objective.for_config(ccfg).stage_fields)


def comm_rounds(stage_list) -> int:
    """Averaging rounds + one stage-dual all-reduce per stage."""
    return sum(-(-st.T // st.I) + 1 for st in stage_list)


def comm_bytes(stage_list, state: CoDAState, compress: str | None = None, *,
               stage_bytes: int = 4) -> int:
    """Total bytes one worker ships over a schedule."""
    mb = window_payload_bytes(state, compress)
    return sum((-(-st.T // st.I)) * mb + stage_bytes for st in stage_list)


@dataclasses.dataclass
class FitResult:
    state: CoDAState
    history: list          # (stage, iteration, loss)
    comm_rounds: int
    iterations: int
    step_seconds: list     # per window: host seconds per local step


class BatchedExecutor:
    """The single-device executor: the worker axis is a batched tensor axis
    (the reference's ``VmapExecutor``): ``window_step(state, wb, eta)``,
    ``stage_end(state, ab)``."""

    def __init__(self, mcfg: ModelConfig, ccfg: CoDAConfig):
        self.mcfg, self.ccfg = mcfg, ccfg

    def window_step(self, state: CoDAState, wb, eta):
        return window_step(self.mcfg, self.ccfg, state, wb, eta)

    def stage_end(self, state: CoDAState, ab) -> CoDAState:
        return stage_end(self.mcfg, self.ccfg, state, ab, resync=False)


def make_executor(mcfg: ModelConfig, ccfg: CoDAConfig, executor: str = "vmap"):
    """``"vmap"`` — the single-device worker-batched executor.
    ``"shard_map"`` (workers over devices) is not ported yet."""
    if executor == "vmap":
        return BatchedExecutor(mcfg, ccfg)
    if executor == "shard_map":
        raise NotImplementedError("executor='shard_map' is not ported yet "
                                  "(ROADMAP Queue 1 item 10, distributed "
                                  "executor)")
    raise ValueError(f"unknown executor {executor!r}")


def fit(state: CoDAState, mcfg: ModelConfig, ccfg: CoDAConfig,
        sched: schedules.ScheduleConfig, n_stages: int,
        sample_window: Callable[[int], Any],
        sample_alpha_batch: Callable[[int], Any], *,
        eval_every: int = 0,
        eval_fn: Callable[[CoDAState], float] | None = None,
        executor: Any = "vmap") -> FitResult:
    """Run CoDA for ``n_stages`` proximal-point stages from ``state`` (the
    reference draws its state from a PRNG key in this place; here it comes
    from ``init_state`` or is carried across with ``params.py``).

    ``sample_window(I)`` returns a batch dict with leading [I, K, B, ...];
    ``sample_alpha_batch(m)`` one with [K, m, ...].  They are called in the
    reference's order (each window, then one alpha batch per stage), so a
    caller can replay the reference's draws.

    ``eval_fn(state)`` runs after every ``eval_every``-th window of each
    stage, and its value is appended to ``history`` after that window's
    loss, as the reference does.

    ``step_seconds`` records, per window, its host time over its local steps,
    taken after the per-window loss readout (which synchronises with the
    device).
    """
    exe = executor if hasattr(executor, "window_step") else \
        make_executor(mcfg, ccfg, executor)
    stage_list = schedules.stages(sched, n_stages)
    history, step_seconds = [], []
    rounds = iters = 0
    for st in stage_list:
        n_windows = -(-st.T // st.I)
        for w in range(1, n_windows + 1):
            t0 = time.perf_counter()
            wb = sample_window(st.I)
            state, losses = exe.window_step(state, wb, st.eta)
            rounds += 1
            iters += st.I
            history.append((st.s, iters, float(torch.mean(losses))))
            step_seconds.append((time.perf_counter() - t0) / st.I)
            if eval_fn is not None and eval_every and w % eval_every == 0:
                history.append((st.s, iters, float(eval_fn(state))))
        state = exe.stage_end(state, sample_alpha_batch(st.m))
        rounds += 1
    return FitResult(state, history, rounds, iters, step_seconds)
