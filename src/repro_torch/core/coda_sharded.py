"""Sharded CoDA executor: the K workers over ``torch.distributed`` ranks,
counterpart of ``repro.core.coda_sharded``.

The worker-batched executor (``coda.BatchedExecutor``) simulates the K
workers as a batched tensor axis on one device.  Here each rank (one card
under NCCL, one CPU process under gloo) holds a contiguous block of
K_loc = K / R workers' rows, in worker order, as the reference's
shard_map lays its tiled leading axis (``sharding/rules.py``), and runs
the paper's Algorithm 2 literally:

  * the I local primal-dual steps issue **zero** collectives: each rank
    steps its own rows (``coda.run_window`` / ``codasca.run_window``);
  * the window averaging is **one** ``all_reduce`` per dtype bucket: the
    params and dual leaves (CODASCA: and the fresh control variates; the
    masked window: and its f32 weight lanes; the sketch: its count rows),
    pre-reduced over the rank's rows and concatenated into one flat
    buffer per dtype (``core/bucketing.py``), whose bytes are
    ``coda.window_payload_by_dtype``;
  * ``avg_compress="int8"``: an s8 ``all_gather`` and an f32 ``all_gather``
    of the scales instead;
  * ``overlap_chunks=C``: ``fit`` feeds window pairs, and each averaging
    runs as C independent chunked rings per dtype bucket of
    ``batch_isend_irecv`` hops in the reference's hop order
    (``bucketing.ring_hop_count`` hops on each rank).  As in the
    reference's fused pair, the first window's chains run under the second
    window's local steps (``bucketing.PendingAverage``: a side CUDA stream
    under NCCL, a worker thread under gloo), which wait on an averaged leaf
    only where they first read it, on the chunks that cover it; the second
    window's own rings, with nothing after them, stay exposed;
  * ``stage_end``: one ``all_reduce`` of the stage-dual scalars.

Every collective is counted in ``bucketing.collectives``; the losses that
``fit`` reports and a checkpoint's state are gathered under ``readout``.
When K does not divide the worker axes (K = 1 on 4 ranks, ``fsdp`` on one
pod) every rank runs all K workers and nothing crosses the wire.

Every rank draws the same global window (``fit``'s samplers are seeded
numpy) and keeps its own rows, so a run's draws are the reference's
whatever R is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bucketing, coda
from repro_torch.launch.mesh import axis_sizes
from repro_torch.sharding import rules
from repro_torch.tree import tree_leaves, tree_map


def _worker_group(mesh, axes: tuple):
    """The process group of the worker axes (the mesh's model axis has
    extent 1, so two worker axes span every rank)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    sizes = axis_sizes(mesh)
    if sizes["pod"] * sizes["data"] != dist.get_world_size():
        raise ValueError(f"worker axes {axes} do not span the mesh {sizes}")
    return dist.group.WORLD


class ShardedExecutor:
    """Rank-parallel CoDA with the surface of ``coda.BatchedExecutor``.

    ``window_step`` returns this rank's per-worker losses [I, K_loc] (not
    the batched executor's worker mean [I]): reducing them would cost a
    collective inside the window; ``mean_loss`` gathers them for ``fit``'s
    history.  ``donate``: as ``coda.BatchedExecutor``'s (each window, pair
    and stage end consumes its state and writes in place)."""

    def __init__(self, mcfg: ModelConfig, ccfg: coda.CoDAConfig, mesh, *,
                 policy: str = "replica", donate: bool = True):
        self.mcfg, self.ccfg, self.mesh, self.policy = mcfg, ccfg, mesh, policy
        self.donate = donate
        self.worker_axes = rules.worker_partition(mesh, policy, ccfg.n_workers)
        if ccfg.overlap_chunks and len(self.worker_axes) > 1:
            raise ValueError(
                "overlap_chunks needs the worker axis on ONE mesh axis (a "
                f"ring has a single total order); partition {self.worker_axes} "
                f"spans {len(self.worker_axes)} axes — use the fsdp policy or a "
                "single-pod mesh")
        self.rank = dist.get_rank()
        # the last pair's summary, and its units in the order its second
        # window first read them: the next pair runs them in that order
        self.overlap_summary: dict = {}
        self._unit_order: list = []
        self.rows = rules.worker_rows(mesh, policy, ccfg.n_workers)
        self.wire = bucketing.Wire(_worker_group(mesh, self.worker_axes)) \
            if self.worker_axes else None
        if ccfg.algorithm == "codasca":
            from repro_torch.core import codasca
            self._run = codasca.run_window
        else:
            self._run = coda.run_window
        if self.overlap_pairs:
            bucketing.warm_reads()

    def _ring_spec(self):
        """The RingSpec of the overlapped averaging, or None when overlap
        is off or there is no wire (the replicated partitions)."""
        if not self.ccfg.overlap_chunks or not self.worker_axes:
            return None
        return bucketing.RingSpec(self.wire.size, self.ccfg.overlap_chunks, self.wire)

    @property
    def overlap_pairs(self) -> bool:
        """True when ``fit`` should feed window pairs (overlap on and a
        wire to overlap)."""
        return self._ring_spec() is not None

    # -- placement --------------------------------------------------------
    def place(self, state: coda.CoDAState) -> coda.CoDAState:
        """This rank's rows of a whole [K, ...] state (a state already
        placed is returned as it is)."""
        K, lead = self.ccfg.n_workers, tree_leaves(state)[0].shape[0]
        if lead == self.rows.stop - self.rows.start and lead != K:
            return state
        if lead != K:
            raise ValueError(f"state leading axis {lead}, expected K={K} workers")
        return rules.shard_state(state, self.mesh, self.policy)

    def gather(self, tree):
        """The whole [K, ...] tree from every rank's rows, on every rank
        (a ``readout``: no part of a window)."""
        if self.wire is None:
            return tree
        return tree_map(lambda l: self.wire.all_gather(l, kind="readout"), tree)

    def barrier(self) -> None:
        """Wait for every rank (rank 0's checkpoint is written before any
        rank reads the directory again)."""
        bucketing.collectives["readout"]["calls"] += 1
        dist.barrier()

    def mean_loss(self, losses: torch.Tensor) -> float:
        """The mean over all K workers of a window's [I, K_loc] losses."""
        if self.wire is not None:
            losses = self.wire.all_gather(losses.transpose(0, 1), kind="readout")
        return float(torch.mean(losses))

    def _batch(self, batch, worker_dim: int):
        return rules.shard_batch(batch, self.mesh, self.policy, self.ccfg.n_workers,
                                 worker_dim=worker_dim)

    def _faults(self, faults, paired: bool):
        """The per-window fault vectors cut to this rank's workers ([K],
        or [2, K] under a pair)."""
        if faults is None:
            return None
        return {k: v[:, self.rows] if paired else v[self.rows] for k, v in faults.items()}

    def _check_faults(self, faults, what: str):
        if self.ccfg.faults_enabled:
            if faults is None:
                raise ValueError(
                    f"CoDAConfig enables fault injection; {what} needs the per-window "
                    "fault vectors (coda.fit builds them from the FaultPlan)")
        elif faults is not None:
            raise ValueError(
                "fault vectors passed but CoDAConfig has fault injection "
                "disabled (set participation / straggler / crash knobs)")

    # -- window -----------------------------------------------------------
    def _take(self, state):
        return coda.take_state(state) if self.donate else state

    def _one_window(self, st, bt, eta, *, communicate, ring, fl):
        """One window on this rank's rows of ``bt`` (consuming ``st`` when
        donating)."""
        return self._run(self.mcfg, self.ccfg, self._take(st), bt, eta, wa=self.wire,
                         ring=ring, communicate=communicate, faults=fl, inplace=self.donate)

    def window_step(self, state, wb, eta, *, communicate: bool = True, faults=None):
        """I local steps on this rank's rows, then one blocking averaging.
        ``wb`` leaves: the global [I, K, B, ...].  Returns (state, losses
        [I, K_loc])."""
        self._check_faults(faults, "window_step")
        return self._one_window(state, self._batch(wb, 1), eta, communicate=communicate,
                                ring=None, fl=self._faults(faults, paired=False))

    def window_pair_step(self, state, wb2, eta, *, communicate: bool = True, faults=None):
        """Two windows, each averaging run as chunked rings
        (``CoDAConfig.overlap_chunks``), the first under the second's local
        steps.  ``wb2`` leaves [2, I, K, B, ...]; fault vectors [2, K].
        Returns (state, losses [2I, K_loc]); ``overlap_summary`` describes
        the first averaging's units and leaves."""
        self._check_faults(faults, "window_pair_step")
        ring, bt2, fl2 = self._ring_spec(), self._batch(wb2, 2), self._faults(faults, True)
        pending = bucketing.PendingAverage(self._unit_order)
        state = self._take(state)
        out = []
        for i in range(2):
            state, losses = self._run(
                self.mcfg, self.ccfg, state, {k: v[i] for k, v in bt2.items()}, eta,
                wa=self.wire, ring=ring, communicate=communicate,
                faults=None if fl2 is None else {k: v[i] for k, v in fl2.items()},
                defer_to=pending if i == 0 and communicate else None,
                pending=pending if i == 1 else None, inplace=self.donate)
            out.append(losses)
        self.overlap_summary, self._unit_order = pending.summary, pending.read_order
        return state, torch.cat(out)

    # -- stage boundary ---------------------------------------------------
    def stage_end(self, state, ab):
        """Every worker's stage-dual re-estimates, their mean over all K
        workers (one all_reduce of the stage-dual scalars), and the proximal
        references moved to the iterate."""
        return coda.stage_end(self.mcfg, self.ccfg, self._take(state), self._batch(ab, 0),
                              resync=False, wa=self.wire, inplace=self.donate)
