"""Sharding rules, counterpart of ``repro.sharding.rules``, in two halves.

**The GSPMD half** (``param_spec``, ``tree_shardings``, ``state_shardings``,
``batch_shardings``, ``serve_shardings``, ``policy_for``) names how each
leaf of a parameter tree, a CoDA state, a batch or a serving cache lies on
a mesh of the reference's axis names; the dry run (``launch/dryrun.py``)
reads it to give each device's bytes.  A spec is a tuple with one entry a
dimension: ``None`` (replicated), an axis name, or a tuple of axis names
(PartitionSpec's meaning, without jax).  Two policies: ``replica`` (the
worker axis over (pod, data), tensor-parallel dims over ``model``) and
``fsdp`` for the giant MoEs (workers over pod only, experts over ``data``,
dense ``d_model`` dims also over ``data``).  Every rule is
divisibility-guarded: an axis that does not divide its dimension is
dropped (replicated).  A leaf is named by its path in the tree (dict keys,
list indices), as the reference names it by its pytree key path: a leaf
inside ``layers`` or ``encoder`` carries a leading stacked-layer axis
unless a list index is on its path (the xLSTM's per-layer list).

**The shard_map half** says which CoDA workers a rank holds (``_fits``,
``worker_partition`` and the meaning of ``shardmap_state_specs`` /
``shardmap_batch_specs``).  The reference lays the state's leading worker axis over the worker mesh
axes as shard_map's tiled leading axis: the rank at coordinate c along
those axes (row-major) holds the contiguous rows [c·K_loc, (c+1)·K_loc),
K_loc = K / (their extent), in worker order.  Here that meaning is a
slice of the state or of a batch.  When K does not divide the worker axes
(K = 1 on 4 ranks, ``fsdp`` on one pod) the worker axis is replicated:
every rank holds all K rows and no collective runs.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes, coda_worker_axes
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# weights whose LAST dim is the tensor-parallel output dim: [.., d_in, d_out]
_OUT_PARALLEL = {"wq", "wk", "wv", "wz", "w_gate", "w_up", "w_in", "in_proj",
                 "x_proj", "dt_proj", "lm_head"}
# weights whose FIRST trailing dim is the tensor-parallel (contracted) dim
_IN_PARALLEL = {"wo", "w_down", "w_out", "out_proj"}
# 1-d vectors laid out along the tensor-parallel dim
_VEC_PARALLEL = {"bq", "bk", "bv", "conv_b", "dt_bias", "D", "b_in"}


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
    cut to this rank's rows (a copy, so the whole state can be freed; an
    optimizer step counter keeps its host value)."""
    from repro_torch.core.optimizer import carry_host_count
    K = tree_leaves(state)[0].shape[0]
    rows = worker_rows(mesh, policy, K)
    if rows == slice(0, K):
        return state
    return tree_map(lambda l: carry_host_count(l, l[rows].clone()), state)


def shard_batch(batch, mesh, policy: str, K: int, *, worker_dim: int = 1):
    """``shardmap_batch_specs``' meaning: window batches [I, K, B, ...]
    (``worker_dim=1``), pairs [2, I, K, ...] (2) and stage-end α batches
    [K, m, ...] (0) cut to this rank's workers."""
    rows = worker_rows(mesh, policy, K)
    if rows == slice(0, K):
        return batch
    idx = (slice(None),) * worker_dim + (rows,)
    return tree_map(lambda l: l[idx], batch)


# --------------------------------------------------------------------------
# the GSPMD half: parameter trees, CoDA state, batches, serving
# --------------------------------------------------------------------------
def tree_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in ``tree_leaves`` order; a path is the dict keys
    (str) and list indices (int) down to the leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_with_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, c in enumerate(tree) for x in tree_with_paths(c, prefix + (i,))]
    return [(prefix, tree)]


def _canon(axes):
    """A one-axis tuple is that axis, as PartitionSpec writes it."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _guard(shape, spec, mesh) -> list:
    return [_canon(axes) if axes is not None and _fits(dim, axes, mesh) else None
            for dim, axes in zip(shape, spec)]


def _trailing_rule(name: str, nd: int, policy: str, in_moe_experts: bool) -> list:
    """Spec of the trailing (per-layer, per-worker) dims of one leaf."""
    fs = "data" if policy == "fsdp" else None  # FSDP weight-shard axis
    if in_moe_experts:
        # [E, d, ff] / [E, ff, d]: experts over "data" (expert parallelism)
        ea = "data" if policy == "fsdp" else None
        if name in ("w_gate", "w_up"):
            return [ea, None, "model"]
        if name == "w_down":
            return [ea, "model", None]
        return [None] * nd
    if name == "table":          # embedding [V, d]
        return ["model", fs]
    if name == "A_log":          # [di, N]
        return ["model", None]
    if name == "conv_w":         # [K, di]
        return [None, "model"]
    if name == "r":              # sLSTM recurrent [4, H, hd, hd]
        return [None] * nd
    if name in ("projector", "enc_in"):
        return [None, "model"]
    if name in _OUT_PARALLEL and nd == 2:
        return [fs, "model"]
    if name in _IN_PARALLEL and nd == 2:
        return ["model", fs]
    if name in _VEC_PARALLEL and nd == 1:
        return ["model"]
    return [None] * nd


def param_spec(path: tuple, leaf, mesh, policy: str, *, worker_axes=()) -> tuple:
    """The spec of one parameter leaf from its path (``rules.py:81-110``):
    a leading worker axis when ``worker_axes`` is given, the stacked-layer
    axis of a leaf inside ``layers`` / ``encoder`` that no list index
    reaches, then the name's trailing rule."""
    keys = ["#" if isinstance(e, int) else e for e in path]
    names = [e for e in path if isinstance(e, str)]
    name = names[-1] if names else ""
    stacked_layers = ("layers" in keys or "encoder" in keys) and "#" not in keys
    in_moe_experts = "moe" in keys and "dense" not in keys and name != "router"
    shape = tuple(leaf.shape)
    spec, rest = [], list(shape)
    if worker_axes:
        wa = tuple(a for a in worker_axes if a in axis_sizes(mesh))
        spec.append(wa or None)
        rest = rest[1:]
    if stacked_layers and rest:
        spec.append(None)  # the L dim
        rest = rest[1:]
    spec += _trailing_rule(name, len(rest), policy, in_moe_experts and len(rest) >= 3)
    return tuple(_guard(shape, spec, mesh))


def tree_shardings(tree, mesh, policy: str, *, worker_axes=()):
    """``tree``'s structure with each leaf's ``param_spec``."""
    return tree_unflatten(tree, [param_spec(p, l, mesh, policy, worker_axes=worker_axes)
                                 for p, l in tree_with_paths(tree)])


def state_shardings(state, mesh, policy: str, multi_pod: bool) -> dict:
    """Specs of every CoDA-state field (``rules.py:124-140``): a subtree
    (params, references, momentum, variates, duals, optimizer state)
    through ``tree_shardings`` with the leading worker axis; a bare [K]
    leaf over the worker axes when they divide it."""
    wa = coda_worker_axes(policy, multi_pod)
    out = {}
    for k, v in state.items():
        if not hasattr(v, "shape"):
            out[k] = tree_shardings(v, mesh, policy, worker_axes=wa)
        else:
            out[k] = (_canon(tuple(wa)),) if wa and _fits(v.shape[0], tuple(wa), mesh) \
                else (None,)
    return out


def batch_shardings(batch, mesh, policy: str, multi_pod: bool):
    """Window batches [I, K, B, ...] (``rules.py:143-157``): the worker dim
    over the worker axes; under ``fsdp`` the per-worker batch also over
    ``data``."""
    wa = coda_worker_axes(policy, multi_pod)
    bax = "data" if policy == "fsdp" else None

    def spec(l):
        s = [None] * l.dim()
        if l.dim() >= 2 and wa and _fits(l.shape[1], tuple(wa), mesh):
            s[1] = _canon(tuple(wa))
        if l.dim() >= 3 and bax and _fits(l.shape[2], (bax,), mesh):
            s[2] = bax
        return tuple(s)

    return tree_map(spec, batch)


def serve_shardings(tree, mesh, cache_shard: str = "heads"):
    """Serving activations and caches (``rules.py:160-190``): the batch dim
    over (pod, data) when it divides; a KV cache [B, S, KV, hd] over
    ``model`` on its heads (else head_dim) with ``cache_shard="heads"``, on
    its sequence with ``"seq"`` (and a per-slot scale [B, S, KV] on its
    sequence too)."""
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)

    def spec(l):
        s = [None] * l.dim()
        if l.dim() >= 1 and axes and _fits(l.shape[0], axes, mesh):
            s[0] = _canon(axes)
        if l.dim() == 4:
            if cache_shard == "seq" and _fits(l.shape[1], ("model",), mesh):
                s[1] = "model"
            elif _fits(l.shape[2], ("model",), mesh):
                s[2] = "model"
            elif _fits(l.shape[3], ("model",), mesh):
                s[3] = "model"
        if l.dim() == 3 and cache_shard == "seq" and _fits(l.shape[1], ("model",), mesh):
            s[1] = "model"
        return tuple(s)

    return tree_map(spec, tree)


def policy_for(arch_name: str) -> str:
    """The giant MoEs cannot give every 16-chip group a replica."""
    return "fsdp" if arch_name in ("arctic-480b", "dbrx-132b") else "replica"


def shard_shape(shape, spec, mesh) -> tuple:
    """One device's block of a leaf of ``shape`` laid out by ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))   # unnamed dims: replicated
    for dim, axes in zip(shape, spec):
        n = 1
        for a in (() if axes is None else axes if isinstance(axes, tuple) else (axes,)):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


def spec_leaves(tree, specs) -> list[tuple]:
    """Each leaf of ``tree`` with its spec from ``specs``, a tree of the
    same structure whose leaves are spec tuples (walked along ``tree``'s
    structure: a spec is a tuple too)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c, sc in zip(tree, specs, strict=True) for x in spec_leaves(c, sc)]
    return [(tree, specs)]


def device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``: each leaf's
    block times its element size."""
    total = 0
    for l, s in spec_leaves(tree, specs):
        n = 1
        for d in shard_shape(l.shape, s, mesh):
            n *= d
        total += n * l.element_size()
    return total
