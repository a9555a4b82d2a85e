"""``python -m repro_torch.launch.train --device cpu`` end to end in a
subprocess (small stages), and the launcher's refusal of flags whose
features are not ported yet."""
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


@pytest.mark.parametrize("flag,item", [
    (("--algorithm", "codasca"), "Queue 1 item 8"),
    (("--objective", "pauc_dro"), "Queue 1 item 3"),
    (("--optimizer", "sm3"), "Queue 1 item 7"),
    (("--executor", "shard_map"), "Queue 1 item 10"),
    (("--participation", "0.5"), "Queue 1 item 8"),
    (("--ckpt-dir", "ck"), "Queue 1 item 9"),
    (("--metrics", "sketch"), "Queue 1 item 6"),
    (("--overlap",), "Queue 1 item 10"),
])
def test_launcher_rejects_unported_flags(flag, item, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", *flag])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported to repro_torch yet" in err and item in err


def test_launcher_refuses_missing_cuda(monkeypatch):
    """The default device is cuda; without a card the launcher raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        train.main(["--stages", "1"])
