"""repro_torch and chip_smoke.py never import jax or the reference package.

Two checks: a subprocess that imports repro_torch and runs one CPU local
step of the mlp, one of the dense transformer (and a prefill), one of the
moe transformer (an eval score and a prefill through the sorted dispatch)
a short serving-engine run, a ``pauc_dro`` and a ``bce`` local step on bf16
parameters over hard-negative data, a ``bce_step``, the quickstart
module, a CODASCA window under faults and one with server momentum, a
checkpoint round trip, and one window of the distributed executor on 2 gloo
ranks (``core/coda_sharded.py``, ``launch/mesh.py``, ``sharding/rules.py``
through the launcher) must leave ``jax`` and ``repro`` out of
``sys.modules``; and an AST
scan of every module of the port and of chip_smoke.py finds no import of
either (imports of ``repro_torch`` itself are allowed).
"""
import ast
import pathlib
import subprocess
import sys

from _torch_threads import one_thread_env
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent

_STEP = """
import sys
import numpy as np
import torch
import repro_torch
from repro_torch.configs import mlp_config
from repro_torch.core import coda
from repro_torch.data import DataConfig, ShardedDataset
from repro_torch.launch import train  # noqa: F401
mcfg = mlp_config(n_features=8, d=16)
ccfg = coda.CoDAConfig(n_workers=2, p_pos=0.7)
ds = ShardedDataset(DataConfig(kind="features", n_features=8), 256, 2, target_p=0.7)
st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0))
batch = {k: v[0] for k, v in ds.sample_window(1, 8).items()}
st, losses = coda.local_step(mcfg, ccfg, st, batch, 0.1)
assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
# the dense family: a transformer local step through attention (K4's plain
# version on the CPU) and one prefill
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
tcfg = get_smoke_config("stablelm-1.6b")
ds = ShardedDataset(DataConfig(kind="tokens", vocab_size=tcfg.vocab_size, seq_len=8),
                    64, 2, target_p=0.7)
st = coda.init_state(tcfg, ccfg, generator=torch.Generator().manual_seed(0))
batch = {k: v[0] for k, v in ds.sample_window(1, 4).items()}
st, losses = coda.local_step(tcfg, ccfg, st, batch, 0.1)
assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
s, logits, (kc, vc) = M.prefill_step(tcfg, st["params"], {"tokens": batch["tokens"]})
assert kc.shape == (2, 2, 4, 8, 4, 64) and logits.shape == (2, 4, 512)
# the moe family: a local step (capacity dispatch), an eval score and a
# prefill (sorted dispatch through grouped_matmul's plain version), then
# the serving engine on one replica
from repro_torch.launch import serve  # noqa: F401
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import loadgen  # noqa: F401
from repro_torch.tree import tree_map
mcfg = get_smoke_config("dbrx-132b")
st = coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0))
st, losses = coda.local_step(mcfg, ccfg, st, batch, 0.1)
assert losses.shape == (2,) and bool(torch.isfinite(losses).all())
s, aux = M.score(mcfg, st["params"], {"tokens": batch["tokens"]})
assert s.shape == (2, 4) and aux.shape == (2,)
s, logits, (kc, vc) = M.prefill_step(mcfg, st["params"], {"tokens": batch["tokens"]})
assert kc.shape == (2, 2, 4, 8, 2, 128)
eng = ServingEngine(mcfg, tree_map(lambda x: x[:1], st["params"]), slots=2, max_len=16)
req = Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)
eng.add_request(req)
eng.run()
assert req.status == "done" and len(req.generated) == 2
# the other objectives on bf16 parameters, the hard-negative data, the
# baselines and the quickstart twin's module
from repro_torch import quickstart  # noqa: F401
from repro_torch.core import baselines
fcfg = mlp_config(n_features=8, d=16)
ds = ShardedDataset(DataConfig(kind="features", n_features=8, hard_neg_frac=0.25), 256, 2,
                    target_p=0.7)
batch = {k: v[0] for k, v in ds.sample_window(1, 8).items()}
for obj in ("pauc_dro", "bce"):
    c = coda.CoDAConfig(n_workers=2, p_pos=0.7, objective=obj, param_dtype=torch.bfloat16)
    st = coda.init_state(fcfg, c, generator=torch.Generator().manual_seed(0))
    st, losses = coda.local_step(fcfg, c, st, batch, 0.1)
    assert bool(torch.isfinite(losses).all()) and st["params"]["mlp"][0]["w"].dtype == torch.bfloat16
p = baselines.bce_init(fcfg, 2, generator=torch.Generator().manual_seed(0))
p, loss = baselines.bce_step(fcfg, p, batch, 0.1)
assert bool(torch.isfinite(loss))
# CODASCA under faults (the masked averaging), server momentum, and a
# checkpoint round trip
import tempfile
from repro_torch.checkpoint import checkpoint
from repro_torch.core import faults
for kw in (dict(participation=0.5), dict(server_momentum=0.9)):
    c = coda.CoDAConfig(n_workers=2, p_pos=0.7, algorithm="codasca", **kw)
    st = coda.init_state(fcfg, c, generator=torch.Generator().manual_seed(0))
    fl = None
    if c.faults_enabled:
        u, r = faults.FaultPlan.from_config(c).window(0)
        fl = {"weights": torch.from_numpy(u), "resync": torch.from_numpy(r)}
    st, losses = coda.make_executor(fcfg, c).window_step(st, ds.sample_window(2, 8), 0.1,
                                                         faults=fl)
    assert bool(torch.isfinite(losses).all()) and "cg_params" in st
with tempfile.TemporaryDirectory() as d:
    checkpoint.save(d, 1, {"state": st})
    back = checkpoint.restore(d, 1, {"state": st})["state"]
    assert torch.equal(back["srv_m"]["score_head"]["w"], st["srv_m"]["score_head"]["w"])
# the distributed executor: one window on 2 gloo ranks through the launcher
from repro_torch.core import bucketing, coda_sharded  # noqa: F401
from repro_torch.launch import mesh  # noqa: F401
from repro_torch.sharding import rules  # noqa: F401
out = train.main(["--device", "cpu", "--executor", "shard_map", "--force-host-devices", "2",
                  "--stages", "1", "--t0", "4", "--interval", "4", "--n-data", "256"])
assert out["mesh"] == {"data": 2, "model": 1} and out["collectives"]["all_reduce"]["calls"] == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_cpu_step_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _STEP], cwd=ROOT,
                         env=one_thread_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in ("jax", "jaxlib", "repro", "flax", "optax")]
    assert not bad, bad
