"""Which CoDA workers a rank holds, counterpart of the shard_map half of
``repro.sharding.rules`` (``_fits``, ``worker_partition`` and the meaning
of ``shardmap_state_specs`` / ``shardmap_batch_specs``).

The reference lays the state's leading worker axis over the worker mesh
axes as shard_map's tiled leading axis: the rank at coordinate c along
those axes (row-major) holds the contiguous rows [c·K_loc, (c+1)·K_loc),
K_loc = K / (their extent), in worker order.  Here that meaning is a
slice of the state or of a batch.  When K does not divide the worker axes
(K = 1 on 4 ranks, ``fsdp`` on one pod) the worker axis is replicated:
every rank holds all K rows and no collective runs.

The GSPMD half (``param_spec``, ``tree_shardings``, ``state_shardings``,
``batch_shardings``, ``serve_shardings``, ``policy_for``) serves the
reference's dry run and is not ported (ROADMAP Queue 1 item 13b).
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes, coda_worker_axes
from repro_torch.tree import tree_leaves, tree_map


def _fits(dim: int, axes, mesh) -> bool:
    if axes is None:
        return False
    axes = axes if isinstance(axes, tuple) else (axes,)
    if not axes:
        return False
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        if a not in sizes:
            return False
        n *= sizes[a]
    return dim % n == 0 and dim >= n


def worker_partition(mesh, policy: str, K: int) -> tuple:
    """The mesh axes the worker axis is actually laid over: the policy's
    worker axes when K divides their extent, else () (replicated)."""
    sizes = axis_sizes(mesh)
    wa = coda_worker_axes(policy, multi_pod="pod" in sizes)
    wa = tuple(a for a in wa if a in sizes)
    return wa if wa and _fits(K, wa, mesh) else ()


def worker_rows(mesh, policy: str, K: int) -> slice:
    """This rank's contiguous block of worker rows."""
    wa = worker_partition(mesh, policy, K)
    if not wa:
        return slice(0, K)
    sizes = axis_sizes(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    block, n = 0, 1
    for a in wa:                     # row-major over the worker axes
        block = block * sizes[a] + coord[a]
        n *= sizes[a]
    k_loc = K // n
    return slice(block * k_loc, (block + 1) * k_loc)


def shard_state(state, mesh, policy: str):
    """``shardmap_state_specs``' meaning: every leaf's leading worker axis
    cut to this rank's rows (a copy, so the whole state can be freed)."""
    K = tree_leaves(state)[0].shape[0]
    rows = worker_rows(mesh, policy, K)
    if rows == slice(0, K):
        return state
    return tree_map(lambda l: l[rows].clone(), state)


def shard_batch(batch, mesh, policy: str, K: int, *, worker_dim: int = 1):
    """``shardmap_batch_specs``' meaning: window batches [I, K, B, ...]
    (``worker_dim=1``), pairs [2, I, K, ...] (2) and stage-end α batches
    [K, m, ...] (0) cut to this rank's workers."""
    rows = worker_rows(mesh, policy, K)
    if rows == slice(0, K):
        return batch
    idx = (slice(None),) * worker_dim + (rows,)
    return tree_map(lambda l: l[idx], batch)
