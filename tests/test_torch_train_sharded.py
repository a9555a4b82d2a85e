"""The distributed executor's flags through both launchers on 2 ranks
(``--executor shard_map`` with the mesh, policy, overlap, int8, multi-pod,
CODASCA and fault flags): the port's printed mesh, schedule, bytes and
overlap lines against the reference launcher's."""
import json
import os
import re
import subprocess
import sys

import pytest

from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHARDED_FLAGS = [
    ("--executor", "shard_map"),
    ("--policy", "fsdp"),
    ("--overlap",),
    ("--overlap-chunks", "2", "--overlap"),
    ("--force-host-devices", "2", "--compress", "int8"),
    ("--multi-pod",),
    ("--algorithm", "codasca", "--executor", "shard_map"),
    ("--participation", "0.5", "--overlap"),
]
SHORT = ("--stages", "2", "--t0", "8", "--interval", "4", "--n-data", "512")

_PORT_RUNS = """
import json, sys
from repro_torch.launch import train
for argv in json.loads(sys.argv[1]):
    print("=== run", flush=True)
    train.main(["--device", "cpu", *argv])
    sys.stdout.flush()
"""


def _sharded_argv(flags):
    """``flags`` with whichever of ``--executor shard_map`` and
    ``--force-host-devices 2`` they lack, and the short schedule."""
    extra = [] if "--executor" in flags else ["--executor", "shard_map"]
    extra += [] if "--force-host-devices" in flags else ["--force-host-devices", "2"]
    return [*flags, *extra, *SHORT]


@pytest.fixture(scope="module")
def sharded_runs():
    """Every flag set through both launchers, each package's 8 runs in one
    subprocess (the two subprocesses at once): the outputs split by run."""
    from _torch_ranks import REFERENCE_UNDER_JAX_09, env
    argvs = json.dumps([_sharded_argv(f) for f in SHARDED_FLAGS])
    ref = REFERENCE_UNDER_JAX_09 + """
import json, sys
from repro.launch import train
for argv in json.loads(sys.argv[1]):
    print("=== run", flush=True)
    sys.argv = ["train", *argv]
    train.main()
    sys.stdout.flush()
"""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", "import os\nos.environ['XLA_FLAGS'] = "
         "'--xla_force_host_platform_device_count=2'\n" + ref if name == "ref" else
         _PORT_RUNS, argvs], cwd=ROOT, env=env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in ("ref", "port")}
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, f"{name}:\n{so[-2000:]}\n{se[-4000:]}"
            out[name] = so.split("=== run\n")[1:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len(out["ref"]) == len(out["port"]) == len(SHARDED_FLAGS)
    return out


def _lines(text):
    """The lines both launchers print alike (the data are each package's
    own draws): mesh, fault injection, the iterations and rounds of
    ``done:``, bytes/round and the overlap split's numbers."""
    keep = []
    for line in text.splitlines():
        if line.startswith(("mesh:", "fault injection:", "bytes/round/worker=")):
            keep.append(line)
        elif line.startswith("done:"):
            keep.append(re.match(r"done: \d+ iters, \d+ comm rounds", line).group(0))
        elif line.startswith("overlap:"):
            keep.append(re.findall(r"[\d,]{2,}|chunks=\d+", line))
    return keep


@pytest.mark.parametrize("i", range(len(SHARDED_FLAGS)),
                         ids=[" ".join(f) for f in SHARDED_FLAGS])
def test_sharded_flags_run_both_launchers_alike(sharded_runs, i):
    """The distributed executor's flags on 2 ranks: the port's launcher
    prints the reference's ``mesh: {...} policy=... devices=2`` line, the
    same schedule (iterations, comm rounds), bytes/round/worker and
    schedule total, and under ``--overlap`` the same overlapped and
    exposed bytes."""
    ours, theirs = _lines(sharded_runs["port"][i]), _lines(sharded_runs["ref"][i])
    assert ours == theirs, (ours, theirs)
    assert any(str(line).startswith("mesh:") for line in ours)
    assert re.search(r"^done: .* test AUC=\d\.\d{4}$", sharded_runs["port"][i], re.M)
    if "--overlap" in SHARDED_FLAGS[i]:
        assert any(isinstance(line, list) for line in ours)
