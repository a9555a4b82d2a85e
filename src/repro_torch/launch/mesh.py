"""Worker meshes over ``torch.distributed`` ranks, counterpart of
``repro.launch.mesh``.

A rank is one process: one card under NCCL (rank r drives ``cuda:r``), or
one CPU process under gloo, which is how the tests and ``--device cpu
--force-host-devices N`` run N ranks on one host.  The reference's
``force_host_device_count`` splits one CPU into N XLA devices; here N is
the number of gloo ranks ``run_ranks`` starts.  The mesh has the
reference's axis names, built by ``init_device_mesh``; its ``model`` axis
always has extent 1, so every rank holds whole workers.

``run_ranks`` starts the ranks: the calling process is rank 0 and gets
``fn``'s result; ranks 1.. are spawned processes.  Every process group has
a timeout and every spawned rank a join deadline, so a deadlock fails
instead of hanging, and a failed rank fails the run: nothing falls back to
another backend or to the CPU.

``abstract_mesh`` is the dry run's mesh: axis names and sizes, no
process group and no devices (``launch/dryrun.py`` reads the reference's
(16, 16) and (2, 16, 16) meshes through it).
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0       # process-group init and every collective


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: extent} in mesh order (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as a plain record of axis names and sizes, readable where a
    ``DeviceMesh`` is (``mesh_dim_names``, ``shape``; ``axis_sizes``)."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def axis_names(self) -> tuple:
        return self.mesh_dim_names

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def abstract_mesh(shape, axis_names) -> AbstractMesh:
    """The counterpart of the reference's ``abstract_mesh`` (``mesh.py:62``)."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    return AbstractMesh(shape, axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes as abstract meshes: (16, 16) over
    (data, model), and (2, 16, 16) over (pod, data, model) with
    ``multi_pod``."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def make_worker_mesh(n_devices: int = 0, *, multi_pod: bool = False):
    """The shard_map executor's mesh over every rank of the default group:
    ``(data=R, model=1)`` single-pod, ``(pod=2, data=R/2, model=1)``
    multi-pod (an odd R raises).  ``n_devices``, when given, must be R."""
    from torch.distributed.device_mesh import init_device_mesh
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a worker mesh spans every rank: n_devices={n}, world size "
                         f"{dist.get_world_size()}")
    if multi_pod:
        if n % 2:
            raise ValueError(f"multi_pod needs an even device count, got {n}")
        return init_device_mesh(_device_type(), (2, n // 2, 1),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(_device_type(), (n, 1), mesh_dim_names=("data", "model"))


def make_host_mesh():
    """The degenerate one-rank mesh with the same axis names."""
    return make_worker_mesh(1)


def coda_worker_axes(policy: str, multi_pod: bool):
    """Which mesh axes the CoDA worker axis is laid over: ``replica`` — K =
    pod × data; ``fsdp`` — only the pod axis (K = 2 multi-pod, K = 1
    single-pod)."""
    if policy == "replica":
        return ("pod", "data") if multi_pod else ("data",)
    if policy == "fsdp":
        return ("pod",) if multi_pod else ()
    raise ValueError(policy)


def n_workers(mesh, policy: str) -> int:
    sizes = axis_sizes(mesh)
    k = 1
    for a in coda_worker_axes(policy, multi_pod="pod" in sizes):
        k *= sizes[a]
    return max(k, 1)


# --------------------------------------------------------------------------
# ranks
# --------------------------------------------------------------------------
def init_rank(backend: str, rank: int, world_size: int, init_method: str = "env://",
              timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group; under NCCL rank r drives cuda:r."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    kw = {} if init_method == "env://" else {"rank": rank, "world_size": world_size}
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)


def _rank_entry(fn, rank: int, world_size: int, init_method: str, backend: str,
                timeout_s: float, args: tuple):
    if rank:                                    # only rank 0 prints
        sys.stdout = open(os.devnull, "w")
    threads = torch.get_num_threads()
    if backend == "gloo":                       # the host's cores shared by the ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    init_rank(backend, rank, world_size, init_method, timeout_s)
    try:
        return fn(rank, *args)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def run_ranks(fn, world_size: int, args: tuple = (), *, backend: str,
              timeout_s: float = TIMEOUT_S):
    """Run ``fn(rank, *args)`` on ``world_size`` ranks of a fresh process
    group and return rank 0's result.  This process is rank 0; the others
    are spawned (``fn`` must then be a module-level function) and print
    nothing.  The group meets through a file store in a temporary
    directory, removed at the end; a rank that fails or outlives the
    deadline fails the run, and every spawned rank is stopped."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init, backend, timeout_s, args))
             for r in range(1, world_size)]
    try:
        for p in procs:
            p.start()
        out = _rank_entry(fn, 0, world_size, init, backend, timeout_s, args)
        for r, p in enumerate(procs, 1):
            p.join(timeout_s)
            if p.is_alive():
                raise TimeoutError(f"rank {r} still running {timeout_s:.0f} s after rank 0 "
                                   "finished")
            if p.exitcode:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
