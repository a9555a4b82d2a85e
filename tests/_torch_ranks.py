"""Helpers for the tests that run the port on real gloo ranks and the
reference's ``ShardedExecutor`` beside it (tests/test_torch_sharded.py,
tests/test_torch_coda.py, tests/test_torch_train.py)."""
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 300

# What the reference needs to run its shard_map executor under jax 0.9,
# put first in the reference's subprocess (src/repro stays untouched):
#   * shard_map takes ``check_vma`` where the reference passes
#     ``check_rep``: ``repro.core.coda_sharded._shard_map`` renames it;
#   * its launcher indexes the sharded final state (``x[0]``), which jax
#     0.9 refuses on an array laid over a mesh: ``coda.fit`` hands the
#     launcher its state on the host instead (the launcher only scores it).
REFERENCE_UNDER_JAX_09 = """
import jax
import repro.core.coda_sharded as _CS
from repro.core import coda as _CODA
_shard_map, _fit = _CS._shard_map, _CODA.fit


def _renamed(*a, **kw):
    if "check_rep" in kw:
        kw["check_vma"] = kw.pop("check_rep")
    return _shard_map(*a, **kw)


def _fit_on_host(*a, **kw):
    res = _fit(*a, **kw)
    res.state = jax.device_get(res.state)
    return res


_CS._shard_map, _CODA.fit = _renamed, _fit_on_host
"""


def env() -> dict:
    return dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def run_ranks(script: str, world: int, store: pathlib.Path, *args: str) -> list[str]:
    """``script`` on ``world`` gloo ranks, each a subprocess with argv rank,
    world, the file store, then ``args``, all within one deadline; every
    rank must exit 0 and print ``RANK OK``.  Returns their outputs."""
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), str(store),
                               *args], cwd=ROOT, env=env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline, outs = time.monotonic() + TIMEOUT, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "RANK OK" in so, f"rank {r}/{world}:\n{so}\n{se[-4000:]}"
    return [so for so, _ in outs]
