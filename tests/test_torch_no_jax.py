"""repro_torch and chip_smoke.py never import jax or the reference package.

Two checks: a subprocess that imports repro_torch and runs one CPU local
step must leave ``jax`` and ``repro`` out of ``sys.modules``; and an AST
scan of every module of the port and of chip_smoke.py finds no import of
either (imports of ``repro_torch`` itself are allowed).
"""
import ast
import os
import pathlib
import subprocess
import sys

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_cpu_step_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _STEP], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH="src"),
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
