"""The JAX package's public functions in the port: ``sample_online``,
``bucket_sizes``, ``ModelConfig.param_count``/``active_param_count``,
``ALL_ARCHS`` and ``Objective.eval_metric`` against the reference's on
shared inputs, and a walk over both packages' public names that fails on
any name of ``src/repro`` with neither a counterpart in ``src/repro_torch``
nor an entry, with its reason, in ``BY_DESIGN``.

Tolerances: none — the draws, counts, tuples and messages are equal (the
features bitwise: the same fp32 operations on the same draws).
"""
import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import bucketing as JB
from repro.core import objective as JObj
from repro.data import synthetic as JSyn
from repro_torch import configs as C
from repro_torch.core import bucketing as B
from repro_torch.core import objective as Obj
from repro_torch.data import synthetic as Syn
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


# --------------------------------------------------------------------------
# sample_online
# --------------------------------------------------------------------------
class _Replay:
    """A stand-in for ``np.random.Generator`` that hands out prescribed
    draws in order: the reference's own, so the port's arithmetic on them
    can be held against the reference's bitwise."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, shape):
        a = self.draws.pop(0)
        assert a.shape == tuple(np.atleast_1d(shape)), (a.shape, shape)
        return a

    def random(self, shape, dtype=np.float64):
        return self._next(shape).astype(dtype)

    def standard_normal(self, shape, dtype=np.float64):
        return self._next(shape).astype(dtype)

    def integers(self, lo, hi, shape):
        a = self._next(shape)
        assert a.min() >= lo and a.max() < hi
        return a


def _reference_draws(key, jd, shape):
    """The draws ``repro.data.synthetic.sample_online(key, jd, shape)`` makes,
    in the order the port's ``sample_online`` asks for them, flattened to
    the port's [n, ...] rows (the labels' uniforms keep ``shape``)."""
    kl, kx = jax.random.split(key)
    n = int(np.prod(shape))
    draws = [np.asarray(jax.random.uniform(kl, shape))]
    if jd.kind == "tokens":
        k1, k2, k3 = jax.random.split(kx, 3)
        full = shape + (jd.seq_len,)
        n_motif = max(1, int(jd.vocab_size * jd.motif_frac))
        draws += [np.asarray(jax.random.randint(k1, full, 0, jd.vocab_size)).reshape(n, -1),
                  np.asarray(jax.random.randint(k2, full, 0, n_motif)).reshape(n, -1),
                  np.asarray(jax.random.uniform(k3, full)).reshape(n, -1)]
    elif jd.kind == "images":
        hw = jd.image_hw
        draws.append(np.asarray(jax.random.normal(kx, shape + (hw * hw, 3)))
                     .reshape(n, hw * hw, 3))
    elif jd.hard_neg_frac > 0.0:
        kn, kh = jax.random.split(kx)
        draws += [np.asarray(jax.random.normal(kn, shape + (jd.n_features,)))
                  .reshape(n, -1), np.asarray(jax.random.uniform(kh, shape)).reshape(n)]
    else:
        draws.append(np.asarray(jax.random.normal(kx, shape + (jd.n_features,)))
                     .reshape(n, -1))
    return draws


@pytest.mark.parametrize("kw,shape", [
    (dict(kind="features", n_features=12, signal=1.5, p_pos=0.3), (3, 4, 8)),
    (dict(kind="features", n_features=10, signal=2.0, p_pos=0.5, hard_neg_frac=0.25), (5, 16)),
    (dict(kind="images", image_hw=4, signal=0.8, p_pos=0.6), (2, 3, 5)),
    (dict(kind="tokens", vocab_size=97, seq_len=12, signal=1.2, p_pos=0.4), (4, 6)),
])
def test_sample_online_equals_the_reference_on_its_draws(kw, shape):
    """The reference's ``sample_online`` and the port's, the port fed the
    reference's draws: the same labels and the same input bits."""
    key = jax.random.PRNGKey(len(shape) + len(kw))
    want = JSyn.sample_online(key, JSyn.DataConfig(**kw), shape)
    got = Syn.sample_online(_Replay(_reference_draws(key, JSyn.DataConfig(**kw), shape)),
                            Syn.DataConfig(**kw), shape)
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.shape == w.shape, name
        if name == "tokens":
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == np.float32 == w.dtype
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.71])
def test_sample_online_label_share_is_binomial(p):
    """With a real generator: float32 0/1 labels of the asked shape whose
    share of positives lies within 5 standard deviations of p (n = 8192),
    and every input row drawn for its label (positives shifted up)."""
    shape = (8, 4, 256)
    batch = Syn.sample_online(np.random.default_rng(3), Syn.DataConfig(p_pos=p, n_features=16),
                              shape)
    y = batch["labels"]
    assert y.shape == shape and y.dtype == torch.float32
    assert set(torch.unique(y).tolist()) == {0.0, 1.0}
    n = y.numel()
    assert abs(float(y.mean()) - p) <= 5 * (p * (1 - p) / n) ** 0.5
    x = batch["features"]
    assert x.shape == shape + (16,)
    assert float(x[y > 0.5].mean()) > 0.2 and float(x[y < 0.5].mean()) < -0.2


def test_online_and_fixed_data_share_the_draw():
    """``sample_online`` and ``ShardedDataset`` run one ``_draw``: the same
    generator state and labels give the same inputs."""
    dcfg = Syn.DataConfig(kind="tokens", vocab_size=50, seq_len=7)
    a = Syn.sample_online(np.random.default_rng(5), dcfg, (6,))
    rng = np.random.default_rng(5)
    labels = (rng.random((6,)) < dcfg.p_pos).astype(np.float32)
    want = Syn._draw(rng, dcfg, labels)
    np.testing.assert_array_equal(a["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(a["labels"].numpy(), labels)


# --------------------------------------------------------------------------
# bucket_sizes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtypes", [
    ("f32", "f32", "f32"),
    ("bf16", "f32", "bf16", "f32", "f32"),
    ("bf16",),
    ("f32", "bf16", "bf16", "bf16"),
])
def test_bucket_sizes_equal_the_references(dtypes):
    """Mixed fp32/bf16 [K, n_i] row blocks: the same element count per
    dtype bucket, in the same (first-appearance) order."""
    rng = np.random.default_rng(len(dtypes))
    K = 3
    widths = [int(n) for n in rng.integers(1, 40, len(dtypes))]
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    jmats = [jnp.zeros((K, n), jd[d]) for n, d in zip(widths, dtypes)]
    tmats = [torch.zeros((K, n), dtype=td[d]) for n, d in zip(widths, dtypes)]
    want = [(str(jnp.dtype(k)), v) for k, v in JB.bucket_sizes(jmats).items()]
    got = [(str(k).replace("torch.", ""), v) for k, v in B.bucket_sizes(tmats).items()]
    assert got == want


def test_ring_reduction_buckets_are_bucket_sizes():
    """The ring's chunks tile each dtype bucket's ``bucket_sizes`` total."""
    rows = [torch.zeros((2, n), dtype=d) for n, d in
            ((5, torch.float32), (7, torch.bfloat16), (9, torch.float32))]
    red = B._RingReduction(rows, B.RingSpec(size=2, chunks=3), mean=True)
    spans = {}
    for u in red.units:
        spans.setdefault(u.bucket, []).append((u.lo, u.hi))
    assert [max(hi for _, hi in s) for s in spans.values()] == list(B.bucket_sizes(rows).values())


# --------------------------------------------------------------------------
# configs and the objective
# --------------------------------------------------------------------------
def test_all_archs_is_the_references():
    assert C.ALL_ARCHS == JC.ALL_ARCHS
    assert C.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS


@pytest.mark.parametrize("arch", JC.ALL_ARCHS)
def test_param_counts_equal_the_references(arch):
    """Full width: the total and the active (top-k experts) counts."""
    cfg, jcfg = C.get_config(arch), JC.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("name", ["auc", "pauc_dro", "bce"])
def test_eval_metric_raises_as_the_references(name):
    with pytest.raises(AttributeError) as want:
        JObj.REGISTRY[name](p_pos=0.3).eval_metric
    with pytest.raises(AttributeError) as got:
        Obj.REGISTRY[name](p_pos=0.3).eval_metric
    assert str(got.value) == str(want.value).replace("repro.metrics", "repro_torch.metrics")


# --------------------------------------------------------------------------
# the public names of both packages
# --------------------------------------------------------------------------
# a reference name the port does under another name: {name: "module:attr"},
# the attribute path resolved below
COUNTERPARTS = {
    # analysis/audit.py: the rules read recorded runs, not compiled programs
    "CompiledProgram": "repro_torch.analysis.audit:Program",
    "PallasLaunch": "repro_torch.analysis.audit:KernelLaunch",
    "alignments": "repro_torch.analysis.audit:KernelLaunch.tiles",
    "blocks": "repro_torch.analysis.audit:KernelLaunch.tiles",
    "capture": "repro_torch.analysis.audit:run_program",
    "compile_count": "repro_torch.analysis.audit:library_loads",
    "overlapped_window_problems": "repro_torch.analysis.audit:ring_problems",
    "assert_window_payload": "repro_torch.analysis.audit:window_payload_problems",
    "assert_overlapped_window": "repro_torch.analysis.audit:ring_problems",
    "rule_donation": "repro_torch.analysis.audit:rule_buffer_reuse",
    "alias_count": "repro_torch.analysis.audit:moved_leaves",
    "entry_param_count": "repro_torch.analysis.audit:storage_map",
    "rule_pallas_static": "repro_torch.analysis.audit:rule_kernel_static",
    # analysis/hlo.py's roofline hardware: the port's card
    "ici_bw": "repro_torch.analysis.roofline:Hardware.link_bw",
    "V5E": "repro_torch.analysis.roofline:H100",
    # core
    "axis": "repro_torch.core.bucketing:RingSpec.wire",
    "grad_step": "repro_torch.core.coda:grad_step_scores",
    "server_momentum_step": "repro_torch.core.bucketing:average_plan",
    "merge_sketch": "repro_torch.core.bucketing:average_state",
    "VmapExecutor": "repro_torch.core.coda:BatchedExecutor",
    "window_fn": "repro_torch.core.coda_sharded:ShardedExecutor.window_step",
    "window_pair_fn": "repro_torch.core.coda_sharded:ShardedExecutor.window_pair_step",
    "stage_fn": "repro_torch.core.coda_sharded:ShardedExecutor.stage_end",
    # launch/dryrun.py
    "slstm_flop_correction": "repro_torch.launch.dryrun:slstm_step_flops",
    # data/synthetic.py: the reference's field default, which no caller sets
    "motif_frac": "repro_torch.data.synthetic:MOTIF_FRAC",
}

_NO_JAXPR = ("a jaxpr or XLA compile fact: the port runs eagerly and its audit reads "
             "recorded runs (Program), so there is none to read")
_NO_HLO = ("parses optimized HLO text: the port has no HLO; its collectives are recorded "
           "as they run (bucketing.wire_log) and R1 reads that record")
_XLA_KNOB = ("flags.py: a knob that shapes XLA's tracing or lowering; the port's eager "
             "ops and its meta-device dry run trace nothing")
# a reference name with no counterpart, and why
BY_DESIGN = {
    "hlo_text": _NO_JAXPR, "jaxpr": _NO_JAXPR, "cost": _NO_JAXPR,
    "donated_args": _NO_JAXPR, "nondonated_args": _NO_JAXPR, "aliased_args": _NO_JAXPR,
    "iter_eqns": _NO_JAXPR, "jaxpr_problems": _NO_JAXPR,
    "interpret": ("the Pallas interpret mode: a CUDA kernel has none; on the CPU the "
                  "wrapper runs the plain version (KernelLaunch.impl and .device say which)"),
    "collective_ops": _NO_HLO, "verify_window_payload": _NO_HLO,
    "permute_chain_components": _NO_HLO, "verify_overlapped_window": _NO_HLO,
    "DRYRUN_UNROLL": _XLA_KNOB, "MOE_SHARDING_CONSTRAINTS": _XLA_KNOB,
    "scan_unroll": _XLA_KNOB, "attn_chunk": _XLA_KNOB, "mlstm_chunk": _XLA_KNOB,
    "ARTIFACT_DIR": ("the reference's dry run writes under benchmarks/artifacts; the port's "
                     "writes where --out says and nothing under benchmarks/"),
    "build_lowering": "lowers a step to HLO for XLA's cost analysis; the port counts on "
                      "the meta device (launch/dryrun.count_flops)",
    "force_host_device_count": ("sets XLA's host device count; the port's ranks are "
                                "processes (launch/mesh.run_ranks)"),
    "shardmap_state_specs": ("shard_map in_specs; a rank holds its block of workers' rows "
                             "(ShardedExecutor.place)"),
    "shardmap_batch_specs": ("shard_map in_specs; a rank draws its block of workers' "
                             "batches (ShardedExecutor.place)"),
}


def _names(root: pathlib.Path, *, public: bool) -> dict:
    """{name: [file:line]} of what a package defines at module and class
    level (never inside a function body): functions, classes, methods,
    dataclass fields and class attributes, and module-level assignments.
    ``public``: the reference's side — no name with a leading underscore,
    and of the module-level assignments only the upper-case constants."""
    out = {}
    for f in sorted(root.rglob("*.py")):
        rel = f"{f.relative_to(root)}"

        def walk(body, in_class):
            for n in body:
                names = []
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    names = [n.name]
                elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
                    names = [n.target.id] if in_class or not public else []
                elif isinstance(n, ast.Assign):
                    names = [t.id for t in n.targets if isinstance(t, ast.Name)
                             and (not public or (not in_class and t.id.isupper()))]
                for name in names:
                    if not (public and name.startswith("_")):
                        out.setdefault(name, []).append(f"{rel}:{n.lineno}")
                if isinstance(n, ast.ClassDef):
                    walk(n.body, True)

        walk(ast.parse(f.read_text()).body, False)
    return out


def _resolve(target: str):
    mod, attr = target.split(":")
    obj = importlib.import_module(mod)
    for part in attr.split("."):
        if hasattr(obj, "__dataclass_fields__") and part in obj.__dataclass_fields__:
            return obj.__dataclass_fields__[part]
        obj = getattr(obj, part)
    return obj


def test_the_walk_reads_module_and_class_level_only(tmp_path):
    """A name bound only inside a function body (a local, a loop target, a
    nested helper) is not a definition; module and class level are, and
    the public side drops private names and lower-case module variables."""
    (tmp_path / "m.py").write_text(
        "TOP = 1\n_hidden = 2\nlow = 3\n"
        "def f():\n    capture = 1\n    for cost in ():\n        pass\n"
        "    def helper():\n        pass\n"
        "class C:\n    field: int = 0\n    attr = 1\n    def method(self):\n"
        "        axis = 0\n")
    assert set(_names(tmp_path, public=False)) == {"TOP", "_hidden", "low", "f", "C", "field",
                                                   "attr", "method"}
    assert set(_names(tmp_path, public=True)) == {"TOP", "f", "C", "field", "method"}


def test_every_public_name_has_a_counterpart_or_a_reason():
    """A public name of ``src/repro`` is defined in ``src/repro_torch`` under
    its own name (at module or class level of any module: a function's
    local of that name does not count), or under the one ``COUNTERPARTS``
    names, or stays unported for the reason ``BY_DESIGN`` gives."""
    ref = _names(SRC / "repro", public=True)
    port = _names(SRC / "repro_torch", public=False)
    missing = {n: at for n, at in ref.items()
               if n not in port and n not in COUNTERPARTS and n not in BY_DESIGN}
    assert not missing, f"public names of src/repro with no counterpart in the port: {missing}"


def test_the_tables_name_only_unported_reference_names():
    """Every entry is a public name of the reference that the port does not
    define under that name, and every counterpart exists."""
    ref = _names(SRC / "repro", public=True)
    port = _names(SRC / "repro_torch", public=False)
    assert not set(COUNTERPARTS) & set(BY_DESIGN)
    for name in (*COUNTERPARTS, *BY_DESIGN):
        assert name in ref, f"{name} is no public name of src/repro"
        assert name not in port, f"{name} is defined in the port: drop its table entry"
    for name, target in COUNTERPARTS.items():
        assert _resolve(target) is not None, (name, target)
