"""``python -m repro_torch.launch.train --device cpu`` end to end in a
subprocess (small stages), and the distributed executor's flags on both
launchers (CODASCA, the fault knobs, server momentum and the checkpoints:
tests/test_torch_codasca.py, tests/test_torch_checkpoint.py)."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("args,leaves", [
    (("--stages", "2", "--t0", "8", "--n-data", "1024"), 6),
    (("--arch", "resnet50", "--smoke", "--stages", "1", "--t0", "4",
      "--interval", "2", "--batch", "4", "--n-data", "128"), 25),
])
def test_launcher_runs_on_cpu(args, leaves):
    out = _run(*args)
    assert out.returncode == 0, out.stderr
    assert re.search(r"^dataset: n=\d+ p_pos=0\.\d+ workers=4$", out.stdout, re.M)
    assert re.search(rf"^model: \S+ params/worker=[\d,]+ leaves={leaves} device=cpu$",
                     out.stdout, re.M)
    done = re.search(r"^done: (\d+) iters, (\d+) comm rounds, [\d.]+s, "
                     r"test AUC=(\d\.\d+)$", out.stdout, re.M)
    assert done, out.stdout
    assert 0.0 <= float(done.group(3)) <= 1.0
    assert re.search(r"^bytes/round/worker=[\d,]+ \(schedule total [\d,]+\)$",
                     out.stdout, re.M)
    if leaves == 6:  # mlp defaults: 24,961 fp32 params + 3 fp32 duals
        assert f"bytes/round/worker={(24961 + 3) * 4:,} " in out.stdout


# state bytes per worker for the mlp defaults, as the reference prints them
# for the same flags: momentum = 24,961 params + the int32 step counter;
# sm3 = one accumulator per trailing axis; shampoo = [nb, 32, 32] stats and
# preconditioners per leaf
@pytest.mark.parametrize("args,line", [
    (("--optimizer", "momentum", "--opt-dtype", "bf16"),
     "optimizer: momentum (bf16) state=49,926 B/worker (local only — never on the wire)"),
    (("--optimizer", "sm3"),
     "optimizer: sm3 (fp32) state=3,340 B/worker (local only — never on the wire)"),
    (("--optimizer", "shampoo_blocked"),
     "optimizer: shampoo_blocked (fp32) state=6,389,772 B/worker (local only — never on the wire)"),
])
def test_launcher_runs_each_optimizer_on_cpu(args, line):
    out = _run("--stages", "1", "--t0", "8", "--interval", "4", "--n-data", "512", *args)
    assert out.returncode == 0, out.stderr
    assert line in out.stdout.splitlines(), out.stdout
    assert re.search(r"^done: 8 iters, 3 comm rounds, [\d.]+s, test AUC=\d\.\d+$",
                     out.stdout, re.M), out.stdout
    assert f"bytes/round/worker={(24961 + 3) * 4:,} " in out.stdout  # never the opt state


@pytest.mark.parametrize("backend", ["sketch", "exact"])
def test_launcher_metric_reports_on_cpu(backend):
    """``--metrics`` with an eval every window: the reference's report lines;
    the sketch adds its 2·bins·4 bytes to the window payload."""
    out = _run("--stages", "1", "--t0", "8", "--interval", "4", "--n-data", "512",
               "--metrics", backend, "--metric-interval", "1")
    assert out.returncode == 0, out.stderr
    evals = re.findall(r"^\[train\] eval (\d): streaming auc=\d\.\d{4}(?: ±\d\.\d{4})? "
                       rf"\({backend}\) n=(\d+) state=(\d+)B$", out.stdout, re.M)
    if backend == "sketch":
        # 4 local steps × K=4 workers × B=32 scores per window
        assert evals == [("1", "512", "16384"), ("2", "1024", "16384")], out.stdout
        assert re.search(r"^\[train\] final train-stream: streaming auc=\d\.\d{4} "
                         r"±\d\.\d{4} \(sketch\) n=1024 state=16384B", out.stdout, re.M)
        assert re.search(r"^\[train\] final: worker auc \[(\S+ ){3}\S+\] spread=",
                         out.stdout, re.M)
        assert f"bytes/round/worker={(24961 + 3) * 4 + 2 * 2048 * 4:,} " in out.stdout
    else:
        assert [e[0] for e in evals] == ["1", "2"], out.stdout


# the distributed executor's flags, each run on 2 ranks (gloo processes for
# the port, 2 forced host devices for the reference) with a short schedule
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


def test_launcher_refuses_missing_cuda(monkeypatch):
    """The default device is cuda; without a card the launcher raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        train.main(["--stages", "1"])


def test_schedule_and_payload_equal_the_references_with_skew_and_int8():
    """Non-IID shards, an int8 payload and a window at every step, with
    eight workers: the same iterations, communication rounds, bytes per
    round per worker and schedule total as the reference's launcher with
    the same flags (its JAX runs on the CPU)."""
    flags = ("--workers", "8", "--dirichlet-alpha", "0.1", "--compress", "int8",
             "--interval", "0", "--stages", "2", "--t0", "16")
    ours = _run(*flags)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    theirs = subprocess.run([sys.executable, "-m", "repro.launch.train", *flags], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=300)
    assert ours.returncode == 0, ours.stderr
    assert theirs.returncode == 0, theirs.stderr
    pattern = (r"^done: (\d+) iters, (\d+) comm rounds, .*\n"
               r"bytes/round/worker=([\d,]+) \(schedule total ([\d,]+)\)$")
    got, want = (re.search(pattern, out.stdout, re.M) for out in (ours, theirs))
    assert got and want, (ours.stdout, theirs.stdout)
    assert got.groups() == want.groups() == ("64", "66", "25,000", "1,600,008")
    assert re.search(r"^non-IID shards \(Dirichlet α=0\.1\): sizes=\[(\d+, ){7}\d+\]",
                     ours.stdout, re.M), ours.stdout


@pytest.mark.parametrize("objective,duals", [("pauc_dro", 4), ("bce", 0)])
def test_launcher_objectives_print_the_references_lines(objective, duals):
    """``--objective`` with ``--pauc-beta``: the same iterations,
    communication rounds, bytes per round per worker (24,961 fp32 params
    plus the objective's fp32 duals: a, b, α, λ for pauc_dro, none for bce)
    and schedule total as the reference's launcher with the same flags, and
    its ``done:`` line with the ``test pauc@β=`` suffix for pauc_dro."""
    flags = ("--objective", objective, "--pauc-beta", "0.2", "--stages", "2", "--t0", "16",
             "--n-data", "1024")
    ours = _run(*flags)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    theirs = subprocess.run([sys.executable, "-m", "repro.launch.train", *flags], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=300)
    assert ours.returncode == 0, ours.stderr
    assert theirs.returncode == 0, theirs.stderr
    suffix = r", test pauc@0\.2=(?P<pauc>\d\.\d{4})" if objective == "pauc_dro" else ""
    pattern = (r"^done: (?P<iters>\d+) iters, (?P<rounds>\d+) comm rounds, [\d.]+s, "
               rf"test AUC=\d\.\d{{4}}{suffix}\n"
               r"bytes/round/worker=(?P<bytes>[\d,]+) \(schedule total (?P<total>[\d,]+)\)$")
    got, want = (re.search(pattern, out.stdout, re.M) for out in (ours, theirs))
    assert got and want, (ours.stdout, theirs.stdout)
    keys = ("iters", "rounds", "bytes", "total")
    assert [got[k] for k in keys] == [want[k] for k in keys]
    assert got["bytes"] == f"{(24961 + duals) * 4:,}"
    if objective == "pauc_dro":
        assert 0.0 <= float(got["pauc"]) <= 1.0
