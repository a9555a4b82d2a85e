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
forward over ``[K, B, ...]`` inputs, the objective's loss over the ``[K, B]``
scores (one ``auc_loss`` launch for ``auc``), autograd of ``losses.sum()`` (the workers are
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

Ported: ``algorithm="coda"`` and ``"codasca"`` (``core/codasca.py``)
with every objective (``auc``, ``pauc_dro``, ``bce``) over every family
(mlp, cnn, dense, moe, vlm, hybrid, audio and ssm), in fp32 or bf16 parameters
(``param_dtype``; token batches ``[K, B, S]``, with a vlm's ``patches`` or
an audio model's ``frames``; ``use_window`` and ``impl`` reach ``M.score`` as in
the reference; an moe local step adds ``moe_aux_coef`` times the
load-balance loss and dispatches by capacity, its stage-end α batches by
``cfg.moe.dispatch`` through K5), every optimizer (sgd, momentum, sm3,
shampoo_blocked) on every family, the streaming sketch, plain or
int8-compressed averaging, fault injection with the masked averaging
(``core/faults.py``, ``core/bucketing.py``), server momentum, crash-resume
checkpoints in ``fit``, and both executors: the worker-batched one (the
reference's ``VmapExecutor``) and the distributed one
(``core/coda_sharded.py``: the workers over ``torch.distributed`` ranks,
with the overlapped ring averaging of ``overlap_chunks``).
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing, objective, optimizer, schedules
from repro_torch.core.faults import FaultPlan
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


CoDAState = dict[str, Any]


def _stack(params, K: int):
    return tree_map(lambda x: x[None].expand((K,) + x.shape).clone(), params)


def init_state(mcfg: ModelConfig, ccfg: CoDAConfig, *,
               generator: torch.Generator | None = None,
               device: str | torch.device = "cpu") -> CoDAState:
    """A fresh state: one replica of ``M.init_params`` stacked K times,
    ``ref_params`` in buffers of its own, the fp32 server-momentum buffer
    ``srv_m`` when β > 0, the zero sketch counts when ``stream_bins > 0``,
    the optimizer's initial state, and CODASCA's zero control variates."""
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
    if ccfg.server_momentum:
        state["srv_m"] = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                                        device=x.device), state["params"])
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
    if ccfg.algorithm == "codasca":
        from repro_torch.core import codasca
        state = codasca.extend_state(state)
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


def server_momentum_step(state: CoDAState, start_params, beta: float) -> CoDAState:
    """Server momentum on the averaged iterate (CODASCA's server update):

        m ← β·m + (x̄ − x_start),    x ← x_start + m

    in fp32, where ``start_params`` is the synced iterate the window started
    from and ``state["params"]`` the fresh average.  The buffer ``srv_m`` is
    a function of synced iterates, so it is replicated and never shipped."""
    m = tree_map(lambda m_, xb, xs: beta * m_ + (xb.to(torch.float32) - xs.to(torch.float32)),
                 state["srv_m"], state["params"], start_params)
    new = dict(state)
    new["srv_m"] = m
    new["params"] = tree_map(lambda xs, m_, xb: (xs.to(torch.float32) + m_).to(xb.dtype),
                             start_params, m, state["params"])
    return new


def average(state: CoDAState, compress: str | None = None) -> CoDAState:
    """Periodic model averaging over the worker axis (params and duals, and
    the sketch deltas when the sketch is on): ``bucketing.average_state``
    with every worker on this device."""
    return bucketing.average_state(state, compress,
                                   n_workers=tree_leaves(state["params"])[0].shape[0])


def run_window(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState, window_batch, eta,
               *, wa=None, ring=None, communicate: bool = True, faults=None):
    """``I`` local steps + (optionally) one averaging, then server momentum
    when β > 0.  ``window_batch`` leaves: [I, K, per_worker_batch, ...].
    ``faults`` ({"weights": [K], "resync": [K]} f32, ``core/faults.py``)
    switches the averaging to the exact masked participant mean
    (``bucketing.masked_average_state``).  ``wa`` / ``ring``: the
    averaging's wire when the K rows are one rank's share of the workers
    (``core/coda_sharded.py``); the local steps issue no collective.
    Returns (state, losses [I, K])."""
    I = window_batch["labels"].shape[0]
    start_params = state["params"] if communicate and ccfg.server_momentum else None
    losses = []
    for i in range(I):
        state, loss = local_step(mcfg, ccfg, state,
                                 {k: v[i] for k, v in window_batch.items()},
                                 eta)
        losses.append(loss)
    if communicate:
        compress = ccfg.avg_compress or None
        if faults is not None:
            state = bucketing.masked_average_state(state, faults, compress, wa=wa, ring=ring)
        else:
            state = bucketing.average_state(state, compress, wa=wa, ring=ring,
                                            n_workers=ccfg.n_workers)
        if ccfg.server_momentum:          # rejected with faults at config time
            state = server_momentum_step(state, start_params, ccfg.server_momentum)
    return state, torch.stack(losses)


def window_step(mcfg: ModelConfig, ccfg: CoDAConfig, state: CoDAState,
                window_batch, eta, *, communicate: bool = True, faults=None):
    """``run_window`` on one device: (state, losses [I], each the mean over
    workers)."""
    state, losses = run_window(mcfg, ccfg, state, window_batch, eta,
                               communicate=communicate, faults=faults)
    return state, losses.mean(dim=1)


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
              *, resync: bool = True, wa=None):
    """Re-estimate the stage duals on every worker, worker-mean them, and
    move the proximal references to the (averaged) iterate.  ``resync=False``
    (what the executors pass) skips the redundant re-average: every window
    already ends in one.  ``wa``: the worker group (``bucketing.Wire``) of a
    sharded state, whose rows are this rank's: the means over them meet in
    one ``all_reduce`` of the stage-dual scalars."""
    obj = objective.for_config(ccfg)
    if resync:
        state = average(state)
    upd = estimate_stage_duals(mcfg, ccfg, state["params"], state["duals"],
                               batch)
    if wa is not None and upd:
        vals = torch.stack([torch.mean(v) for v in upd.values()])
        vals = bucketing.div(wa.all_reduce(vals), wa.size)
        upd = {f: v.reshape(1) for f, v in zip(upd, vals)}
    else:
        upd = {f: torch.mean(v, dim=0, keepdim=True) for f, v in upd.items()}
    new_duals = dict(state["duals"])
    for f, v in upd.items():
        new_duals[f] = v.expand(state["duals"][f].shape).contiguous()
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


def mask_payload_bytes(state: CoDAState) -> int:
    """Extra f32 bytes of the masked window: the weight lane Σu (4), and
    for CODASCA the participant-count lane Σm (4 more)."""
    return 8 if "cv_params" in state else 4


def window_payload_by_dtype(state: CoDAState, compress: str | None = None, *,
                            masked: bool = False) -> dict[str, int]:
    """Window-payload bytes per dtype bucket, keyed by the reference's HLO
    dtype tags (``f32``, ``bf16``): the totals of ``bucketing.bucket_layout``
    (CODASCA doubles each leaf's bytes, the sketch and the mask lanes ride
    the f32 bucket).  Uncompressed layouts only."""
    if compress:
        raise ValueError("per-dtype payload is only defined for "
                         "uncompressed averaging")
    return {tag: b["bytes"] for tag, b in bucketing.bucket_layout(state, masked=masked).items()}


def window_payload_bytes(state: CoDAState, compress: str | None = None, *,
                         masked: bool = False) -> int:
    """Bytes one worker ships in the single window averaging: CoDA's
    ``model_bytes`` (twice that for CODASCA, whose variates ride the same
    buckets), plus the sketch deltas when the sketch is on, plus the mask
    lanes when ``masked``."""
    mult = 2 if "cv_params" in state else 1
    return (mult * model_bytes(state, compress) + streaming_payload_bytes(state)
            + (mask_payload_bytes(state) if masked else 0))


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
    # per-worker window-payload bytes split by schedule position, as the
    # reference splits them: a round whose averaging is the first of a
    # window pair (an overlapping executor's) is ``overlapped``, every other
    # round ``exposed``; the sum is ``comm_bytes``'s total
    exposed_bytes: int = 0
    overlapped_bytes: int = 0


class BatchedExecutor:
    """The single-device executor: the worker axis is a batched tensor axis
    (the reference's ``VmapExecutor``): ``window_step(state, wb, eta, *,
    faults=None)``, ``stage_end(state, ab)``.  With fault injection on, a
    window needs its fault vectors, and without it refuses them.  It holds
    every worker, so ``place`` and ``gather`` return the state as it is,
    and it is its own rank 0."""

    rank = 0

    def __init__(self, mcfg: ModelConfig, ccfg: CoDAConfig):
        self.mcfg, self.ccfg = mcfg, ccfg
        if ccfg.algorithm == "codasca":
            from repro_torch.core import codasca
            self._wstep = codasca.window_step
        else:
            self._wstep = window_step

    def place(self, state: CoDAState) -> CoDAState:
        return state

    def gather(self, tree):
        return tree

    def barrier(self) -> None:
        pass

    def mean_loss(self, losses) -> float:
        return float(torch.mean(losses))

    def window_step(self, state: CoDAState, wb, eta, *, faults=None):
        if self.ccfg.faults_enabled:
            if faults is None:
                raise ValueError(
                    "CoDAConfig enables fault injection; window_step needs "
                    "the per-window fault vectors (coda.fit builds them "
                    "from the FaultPlan)")
        elif faults is not None:
            raise ValueError(
                "fault vectors passed but CoDAConfig has fault injection "
                "disabled (set participation / straggler / crash knobs)")
        return self._wstep(self.mcfg, self.ccfg, state, wb, eta, faults=faults)

    def stage_end(self, state: CoDAState, ab) -> CoDAState:
        return stage_end(self.mcfg, self.ccfg, state, ab, resync=False)


def make_executor(mcfg: ModelConfig, ccfg: CoDAConfig, executor: str = "vmap", *,
                  mesh=None, policy: str = "replica"):
    """``"vmap"`` — the single-device worker-batched executor.
    ``"shard_map"`` — the workers over the ranks of ``mesh``
    (``launch/mesh.make_worker_mesh``; core/coda_sharded.py)."""
    if executor == "vmap":
        return BatchedExecutor(mcfg, ccfg)
    if executor == "shard_map":
        if mesh is None:
            raise ValueError("executor='shard_map' needs a mesh "
                             "(see launch/mesh.py)")
        from repro_torch.core import coda_sharded
        return coda_sharded.ShardedExecutor(mcfg, ccfg, mesh, policy=policy)
    raise ValueError(f"unknown executor {executor!r}")


def fit(state: CoDAState, mcfg: ModelConfig, ccfg: CoDAConfig,
        sched: schedules.ScheduleConfig, n_stages: int,
        sample_window: Callable[[int], Any],
        sample_alpha_batch: Callable[[int], Any], *,
        eval_every: int = 0,
        eval_fn: Callable[[CoDAState], float] | None = None,
        executor: Any = "vmap",
        fault_plan: FaultPlan | None = None,
        ckpt_dir: str = "", ckpt_every: int = 0, resume: bool = False,
        rng: np.random.Generator | None = None) -> FitResult:
    """Run CoDA (or CODASCA) for ``n_stages`` proximal-point stages from
    ``state``, the whole [K, ...] state (the reference draws it from a PRNG
    key in this place; here it comes from ``init_state`` or is carried
    across with ``params.py``), or a state the executor has already
    placed.  ``executor``: ``"vmap"`` or a built executor (for the
    sharded one, ``make_executor(..., "shard_map", mesh=, policy=)``); the
    executor ``place``s the state, so
    under the sharded executor each rank trains, and ``FitResult.state``
    holds, its own workers' rows.

    ``sample_window(I)`` returns a batch dict with leading [I, K, B, ...];
    ``sample_alpha_batch(m)`` one with [K, m, ...].  They are called in the
    reference's order (each window, or one ``sample_window(2·I)`` per
    window pair, then one alpha batch per stage), so a caller can replay
    the reference's draws; every rank draws the same global batches.

    When the executor overlaps (``CoDAConfig(overlap_chunks > 0)`` on the
    sharded executor) the loop feeds window PAIRS ([2, I, K, ...]), whose
    averagings run as rings; an odd trailing window runs alone.  Each
    pair's first payload is counted in ``overlapped_bytes``, the rest in
    ``exposed_bytes``, as the reference counts them.

    ``eval_fn(state)`` runs after every ``eval_every``-th window of each
    stage (a pair evaluates once if either of its windows is one), and its
    value is appended to ``history`` after that window's loss, as the
    reference does.  A history loss is the mean over all K workers.

    Fault tolerance: with ``ccfg.faults_enabled`` (or an explicit
    ``fault_plan``) every window gets its seed-replayed fault vectors
    (``FaultPlan.window`` of the global window count) and the executor runs
    the masked averaging; each window then ships ``mask_payload_bytes``
    more.

    Checkpoints: ``ckpt_dir`` + ``ckpt_every`` save ``{"state"}`` (the
    whole [K, ...] state, gathered; rank 0 writes it) and the reference's
    loop counters (``stage``, ``w``, ``rounds``, ``iters``, ``gw``,
    ``exposed``, ``overlapped``, ``history``) every ``ckpt_every`` windows,
    at window boundaries, with the samplers' numpy ``rng`` (its
    ``bit_generator.state``, as ``rng``): ``ckpt_dir`` needs ``rng``.
    ``resume=True`` restores the latest checkpoint (none: a cold start) on
    every rank and continues bitwise as the uninterrupted run would: the
    state, the sampler's stream, the counters and the fault schedule all
    resume exactly.

    ``step_seconds`` records, per window run by this call, its host time
    over its local steps (a pair's time split evenly over its two windows),
    taken after the loss readout (which synchronises with the device).
    """
    exe = executor if hasattr(executor, "window_step") else \
        make_executor(mcfg, ccfg, executor)
    stage_list = schedules.stages(sched, n_stages)
    if fault_plan is None and ccfg.faults_enabled:
        fault_plan = FaultPlan.from_config(ccfg)
    masked = fault_plan is not None
    history, step_seconds = [], []
    rounds = iters = exposed = overlapped = 0
    gw = 0                    # global window count: fault schedule + ckpt steps
    start_stage = start_w = 0
    payload = window_payload_bytes(state, ccfg.avg_compress or None, masked=masked)
    stage_payload = stage_payload_bytes(ccfg)
    pairs = getattr(exe, "overlap_pairs", False)
    device = tree_leaves(state["params"])[0].device
    if ckpt_dir:
        if rng is None:
            raise ValueError(
                "fit(ckpt_dir=...) needs rng=, the numpy Generator the samplers "
                "draw from: a checkpoint without its state cannot resume the "
                "same windows")
        from repro_torch.checkpoint import checkpoint as ckpt
        # the whole [K, ...] state's shapes and dtypes, to restore into
        template = tree_map(lambda l: torch.empty((ccfg.n_workers,) + l.shape[1:],
                                                  dtype=l.dtype, device="meta"), state)
    state = exe.place(state)
    if ckpt_dir and resume:
        step = ckpt.latest_step(ckpt_dir)
        if step is not None:
            restored = ckpt.restore(ckpt_dir, step, {"state": template}, device=device)
            state = exe.place(restored["state"])
            del restored
            meta = ckpt.load_metadata(ckpt_dir, step)
            start_stage, start_w = meta["stage"], meta["w"]
            rounds, iters, gw = meta["rounds"], meta["iters"], meta["gw"]
            exposed, overlapped = meta["exposed"], meta["overlapped"]
            history = [tuple(h) for h in meta["history"]]
            rng.bit_generator.state = meta["rng"]

    def window_faults(w0: int, n: int) -> dict:
        """Fault vectors of windows w0..w0+n−1 ([2, K] leaves for a pair)."""
        us, rs = zip(*(fault_plan.window(w0 + j) for j in range(n)))
        out = {"weights": np.stack(us), "resync": np.stack(rs)}
        return {k: torch.from_numpy(v[0] if n == 1 else v).to(device) for k, v in out.items()}

    for si, st in enumerate(stage_list):
        if si < start_stage:
            continue
        n_windows = -(-st.T // st.I)
        w = start_w if si == start_stage else 0
        while w < n_windows:
            t0 = time.perf_counter()
            done = 2 if pairs and w + 1 < n_windows else 1
            fl = window_faults(gw, done) if masked else None
            if done == 2:
                wb = {k: v.reshape((2, st.I) + v.shape[1:])
                      for k, v in sample_window(2 * st.I).items()}
                state, losses = exe.window_pair_step(state, wb, st.eta, faults=fl)
                overlapped += payload
            else:
                state, losses = exe.window_step(state, sample_window(st.I), st.eta,
                                                faults=fl)
            rounds += done
            iters += done * st.I
            exposed += payload
            w += done
            gw += done
            history.append((st.s, iters, exe.mean_loss(losses)))
            step_seconds += [(time.perf_counter() - t0) / (done * st.I)] * done
            # a pair completes TWO windows: it evaluates once if either of
            # them hits the cadence (no mid-pair state exists to evaluate)
            if eval_fn is not None and eval_every and any(
                    j % eval_every == 0 for j in range(w - done + 1, w + 1)):
                history.append((st.s, iters, float(eval_fn(state))))
            if ckpt_dir and ckpt_every and gw % ckpt_every == 0:
                meta = {"stage": si, "w": w, "rounds": rounds, "iters": iters, "gw": gw,
                        "exposed": exposed, "overlapped": overlapped,
                        "history": [list(h) for h in history],
                        "rng": rng.bit_generator.state}
                whole = exe.gather(state)
                if exe.rank == 0:
                    ckpt.save(ckpt_dir, gw, {"state": whole}, meta)
                del whole
                exe.barrier()
        state = exe.stage_end(state, sample_alpha_batch(st.m))
        rounds += 1
        exposed += stage_payload          # the stage-end fp32 dual scalars
    return FitResult(state, history, rounds, iters, step_seconds,
                     exposed_bytes=exposed, overlapped_bytes=overlapped)
