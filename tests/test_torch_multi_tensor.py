"""K2 and K3 as multi-tensor launches: ``prox_update_multi`` /
``opt_update_multi`` (``kernels/prox_update.py``, ``kernels/opt_update.py``)
and the tree entries ``ops.prox_update_tree`` / ``ops.opt_update_tree`` that
the optimizers call once a local step.

On the CPU (small trees from a seed: fp32 leaves, bf16 leaves, bf16 leaves
with an fp32 step, bf16 momentum buffers, an empty leaf):

  * the tree form equals the port's plain version leaf by leaf bitwise
    (bf16 bits compared as int16), in place and out of place, and the JAX
    reference's per-leaf ``repro.kernels.ref.prox_update_ref`` /
    ``opt_update_ref``: bitwise where the arithmetic is the same (fp32 K2,
    bf16 leaves with an fp32 step, K3 momentum in every dtype, precond's ν),
    else at tests/test_torch_kernels.py's and tests/test_torch_optimizer.py's
    tolerances (bf16 K2 2e-2: one bf16 ulp where a double rounding lands on
    the other side; precond's v' 1e-6: the two 1/√x differ by an ulp);
  * the launch geometry (one launch for ResNet50's 153 leaves and for bf16
    stablelm-1.6b's 17 mixed leaves, more past the table's capacity) and
    its constants against ``csrc/coda_kernels.cu``;
  * the cross-leaf aliasing check (a written leaf overlapping another
    leaf's input raises; disjoint views of one buffer pass), against the
    pairwise definition;
  * the host table (``leaf_rows``, ``pointer_table``) and its cache, and
    one tree call a step from every optimizer.

On the card (``cuda``, skipped here; run them with ``PYTHONPATH=src python
-m pytest --noconftest -q -m cuda tests/test_torch_multi_tensor.py``): the
kernels bitwise their plain versions on mixed, misaligned and past-capacity
trees, the exact launch counts, the geometry query, one launch a local step.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import audit as A
from repro_torch.kernels import ops, ref
from repro_torch.kernels import opt_update as K3
from repro_torch.kernels import prox_update as K2
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

F32, BF16 = torch.float32, torch.bfloat16
# (shape, v's dtype, g's dtype): fp32, bf16, bf16 with an fp32 step, an
# empty leaf, a scalar-per-worker leaf
PROX_TREE = [((4, 3, 5), F32, F32), ((4, 7), BF16, BF16), ((4, 33), BF16, F32),
             ((4,), F32, F32), ((4, 0), F32, F32), ((4, 2, 9), BF16, BF16)]
# (shape, v's dtype, the buffer's dtype)
MOMENTUM_TREE = [((4, 3, 5), F32, F32), ((4, 7), F32, BF16), ((4, 33), BF16, BF16),
                 ((4,), BF16, F32), ((4, 0), F32, F32), ((4, 2, 9), F32, BF16)]
PRECOND_TREE = [((4, 3, 5), F32, F32), ((4, 33), BF16, F32), ((4,), F32, F32),
                ((4, 0), BF16, F32)]


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t


def _same(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _draw(rng, shape, dtype, positive=False):
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(np.abs(x) if positive else x).to(dtype)


def _prox_tree(seed):
    rng = np.random.default_rng(seed)
    leaves = [(_draw(rng, s, v), _draw(rng, s, g), _draw(rng, s, v)) for s, v, g in PROX_TREE]
    return [{f"w{i}": leaf[k] for i, leaf in enumerate(leaves)} for k in range(3)]


def _opt_tree(seed, spec, mode):
    rng = np.random.default_rng(seed)
    leaves = [(_draw(rng, s, v), _draw(rng, s, v), _draw(rng, s, v),
               _draw(rng, s, b, positive=mode == "precond")) for s, v, b in spec]
    vs, gs, v0s = ({f"w{i}": leaf[k] for i, leaf in enumerate(leaves)} for k in range(3))
    return vs, gs, v0s, [leaf[3] for leaf in leaves]


def _seeds(n):
    from repro_torch.core.optimizer import leaf_seeds
    return leaf_seeds(torch.full((4,), 3, dtype=torch.int32), n)


@pytest.fixture(scope="module")
def jref():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jax_ref
    return jnp, jax_ref


def _j(jnp, t):
    """``t`` as a jax array of the same dtype and values."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == BF16 else jnp.float32)


def _np(x):
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# the tree forms against the plain version and the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("inplace", [False, True])
def test_prox_tree_is_bitwise_the_plain_version_and_the_reference(jref, inplace):
    jnp, jax_ref = jref
    v, g, v0 = _prox_tree(0)
    want = {k: ref.prox_update_ref(v[k], g[k], v0[k], 0.05, 0.5) for k in v}
    jwant = {k: jax_ref.prox_update_ref(_j(jnp, v[k]), _j(jnp, g[k]), _j(jnp, v0[k]), 0.05, 0.5)
             for k in v}
    given = dict(v) if inplace else None
    got = ops.prox_update_tree(v, g, v0, 0.05, 0.5, inplace=inplace)
    for k, (_, vdt, gdt) in zip(v, PROX_TREE):
        assert _same(got[k], want[k]), k
        if inplace:
            assert got[k] is given[k]
        if vdt == BF16 and gdt == BF16:
            np.testing.assert_allclose(got[k].float().numpy(), _np(jwant[k]), atol=2e-2)
        else:
            np.testing.assert_array_equal(got[k].float().numpy(), _np(jwant[k]))


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mode", ["momentum", "precond"])
def test_opt_tree_is_bitwise_the_plain_version_and_the_reference(jref, mode, inplace):
    jnp, jax_ref = jref
    spec = MOMENTUM_TREE if mode == "momentum" else PRECOND_TREE
    v, g, v0, bufs = _opt_tree(1, spec, mode)
    coef = 0.9 if mode == "momentum" else 1e-6
    seeds = _seeds(len(bufs))
    keys = list(v)
    want = [ref.opt_update_ref(v[k], g[k], v0[k], b, 0.05, 0.5, coef, seeds[i], mode=mode)
            for i, (k, b) in enumerate(zip(keys, bufs))]
    jwant = [jax_ref.opt_update_ref(_j(jnp, v[k]), _j(jnp, g[k]), _j(jnp, v0[k]), _j(jnp, b),
                                    0.05, 0.5, coef, jnp.uint32(int(seeds[i])), mode=mode)
             for i, (k, b) in enumerate(zip(keys, bufs))]
    given = (dict(v), list(bufs))
    nv, nb = ops.opt_update_tree(v, g, v0, bufs, 0.05, 0.5, coef, seeds, mode=mode,
                                 inplace=inplace)
    for i, k in enumerate(keys):
        assert _same(nv[k], want[i][0]) and _same(nb[i], want[i][1]), k
        if inplace:
            assert nv[k] is given[0][k] and nb[i] is given[1][i]
        # the buffer (the rounding bits of a bf16 one included) bitwise the
        # reference's; v' bitwise for momentum, within an ulp of rsqrt for precond
        np.testing.assert_array_equal(_bits(nb[i]).numpy(),
                                      np.asarray(jwant[i][1]).view(
                                          np.int16 if nb[i].dtype == BF16 else np.float32))
        if mode == "momentum":
            np.testing.assert_array_equal(nv[k].float().numpy(), _np(jwant[i][0]))
        else:
            np.testing.assert_allclose(nv[k].float().numpy(), _np(jwant[i][0]), rtol=0,
                                       atol=1e-6 if nv[k].dtype == F32 else 2e-2)


def test_multi_wrappers_on_cpu_take_the_plain_version():
    """The wrappers themselves compute the plain version leaf by leaf for
    CPU tensors and launch nothing; the one-leaf entries are the one-leaf
    case."""
    v, g, v0 = (list(t.values()) for t in _prox_tree(2))
    n0, m0 = K2.launches, K3.launches
    got = K2.prox_update_multi(v, g, v0, 0.05, 0.5)
    assert all(_same(a, ref.prox_update_ref(*x, 0.05, 0.5)) for a, x in zip(got, zip(v, g, v0)))
    assert _same(K2.prox_update(v[1], g[1], v0[1], 0.05, 0.5), got[1])
    ov, og, ov0, ob = _opt_tree(3, MOMENTUM_TREE, "momentum")
    ov, og, ov0 = (list(t.values()) for t in (ov, og, ov0))
    seeds = _seeds(len(ob))
    nv, nb = K3.opt_update_multi(ov, og, ov0, ob, 0.05, 0.5, 0.9, seeds, mode="momentum")
    one = K3.opt_update(ov[2], og[2], ov0[2], ob[2], 0.05, 0.5, 0.9, seeds[2:3],
                        mode="momentum")
    assert _same(one[0], nv[2]) and _same(one[1], nb[2])
    assert (K2.launches, K3.launches) == (n0, m0)
    assert K2.prox_update_multi([], [], [], 0.05, 0.5) == []


def test_tree_entries_check_every_leaf():
    v, g, v0 = _prox_tree(4)
    g["w0"] = g["w0"][:, :2]
    with pytest.raises(ValueError, match="one shape"):
        K2.prox_update_multi(list(v.values()), list(g.values()), list(v0.values()), 0.1, 0.5)
    ov, og, ov0, ob = _opt_tree(5, PRECOND_TREE, "precond")
    ob[1] = ob[1].to(BF16)                   # precond takes an fp32 cover only
    with pytest.raises(ValueError, match="precond"):
        K3.opt_update_multi(list(ov.values()), list(og.values()), list(ov0.values()), ob,
                            0.1, 0.5, 1e-6, _seeds(len(ob)), mode="precond")
    with pytest.raises(ValueError, match="one length"):
        K2.prox_update_multi(list(v.values()), list(g.values())[:2], list(v0.values()), 0.1,
                             0.5)


# --------------------------------------------------------------------------
# the launch geometry
# --------------------------------------------------------------------------
def _csrc_constant(name: str) -> int:
    src = (Path(K2.__file__).parent / "csrc" / "coda_kernels.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_geometry_mirrors_the_kernel_constants():
    assert K2.THREADS == _csrc_constant("kMultiThreads")
    assert K2.VECS_PER_THREAD == _csrc_constant("kVecsPerThread")
    assert K2.MAX_LEAVES == _csrc_constant("kMaxLeaves")
    assert K2.TILE == {False: 256 * 4 * 4, True: 256 * 4 * 8}


@pytest.mark.parametrize("tree,leaves", [("mlp", 6), ("resnet50", 153),
                                         ("stablelm-1.6b:2:bfloat16", 17)])
@pytest.mark.parametrize("kernel", ["prox_update", "opt_update"])
def test_a_step_is_one_launch(kernel, tree, leaves):
    mod = K2 if kernel == "prox_update" else K3
    spec = A.step_leaves(kernel, tree)
    geo = mod.launch_geometry(spec["sizes"], spec["codes"])
    assert len(spec["sizes"]) == leaves and geo["launches"] == 1
    assert geo["chunks"] == [list(range(leaves))]
    tile = lambda c: mod.TILE[c != 0] if mod is K2 else K2.TILE[c >= 2]
    assert geo["grid"] == (sum(-(-n // tile(c)) for n, c in zip(spec["sizes"], spec["codes"])),)
    if tree.endswith("bfloat16"):            # bf16 matrices beside fp32 norms, one launch
        assert len(set(spec["codes"])) == 2
    rec = A.launch_record(kernel, {"tree": tree})
    assert A.launch_problems(rec) == [] and rec.per_call == 1


@pytest.mark.parametrize("n,launches", [(385, 1), (386, 2), (770, 3)])
def test_past_the_capacity_a_step_takes_more_launches(n, launches):
    sizes = [100 + i for i in range(n)]
    sizes[5] = 0                                   # an empty leaf takes no room
    geo = K2.launch_geometry(sizes, [i % 3 for i in range(n)])
    live = [i for i in range(n) if sizes[i]]
    want = -(-len(live) // K2.MAX_LEAVES)
    assert geo["launches"] == want == launches
    assert [i for c in geo["chunks"] for i in c] == live
    assert all(len(c) <= K2.MAX_LEAVES for c in geo["chunks"])
    assert len(geo["grids"]) == want and geo["grid"] == (max(geo["grids"]),)


# --------------------------------------------------------------------------
# in place: the cross-leaf aliasing check
# --------------------------------------------------------------------------
def _pairwise_overlap(lo, hi, written) -> bool:
    spans = [(a, b, w) for a, b, w in zip(lo, hi, written) if b > a]
    return any((w1 or w2) and a1 < b2 and a2 < b1
               for i, (a1, b1, w1) in enumerate(spans) for a2, b2, w2 in spans[i + 1:])


@pytest.mark.parametrize("seed", range(8))
def test_spans_overlap_is_the_pairwise_definition(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 12))
        lo = rng.integers(0, 60, n)
        hi = lo + rng.integers(0, 12, n)
        written = rng.random(n) < 0.4
        assert K2.spans_overlap(lo, hi, written) == _pairwise_overlap(lo, hi, written)


def test_a_written_leaf_overlapping_another_leafs_input_raises():
    flat = torch.randn(64)
    v = [flat[:16].view(4, 4), flat[16:32].view(4, 4)]        # disjoint views: fine
    g = [torch.randn(4, 4), torch.randn(4, 4)]
    v0 = [torch.randn(4, 4), torch.randn(4, 4)]
    K2.prox_update_multi(v, g, v0, 0.05, 0.5, inplace=True)
    ops.prox_update_tree(v, g, v0, 0.05, 0.5, inplace=True, impl="ref")
    g_over = [g[0], flat[8:24].view(4, 4)]                      # leaf 1's g reads leaf 0's v
    for call in (lambda: K2.prox_update_multi(v, g_over, v0, 0.05, 0.5, inplace=True),
                 lambda: ops.prox_update_tree(v, g_over, v0, 0.05, 0.5, inplace=True,
                                              impl="ref")):
        with pytest.raises(ValueError, match="overlaps"):
            call()
    v_over = [flat[:16].view(4, 4), flat[12:28].view(4, 4)]     # two written leaves meet
    with pytest.raises(ValueError, match="overlaps"):
        K2.prox_update_multi(v_over, g, v0, 0.05, 0.5, inplace=True)
    # out of place nothing is written into them
    K2.prox_update_multi(v, g_over, v0, 0.05, 0.5)
    # K3: a buffer over another leaf's g, and over the seeds
    bufs = [torch.zeros(4, 4), torch.zeros(4, 4)]
    seeds = _seeds(2)
    K3.opt_update_multi(v, g, v0, bufs, 0.05, 0.5, 0.9, seeds, mode="momentum", inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        K3.opt_update_multi(v, g, v0, [bufs[0], g[0]], 0.05, 0.5, 0.9, seeds,
                            mode="momentum", inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        ops.opt_update_tree(v, g, v0, [bufs[0], v[0]], 0.05, 0.5, 0.9, seeds,
                            mode="momentum", inplace=True, impl="ref")
    with pytest.raises(ValueError, match="contiguous"):
        K2.prox_update_multi([v[0].t(), v[1]], [g[0].t(), g[1]], [v0[0].t(), v0[1]], 0.05,
                             0.5, inplace=True)


# --------------------------------------------------------------------------
# the host's table
# --------------------------------------------------------------------------
def test_leaf_rows_is_one_pointer_a_tensor_and_checks_in_place():
    v, g, v0 = (list(t.values()) for t in _prox_tree(6))
    plan = K2._prox_plan(v, g, v0)
    assert K2._prox_plan(v, g, v0) is plan                     # cached per signature
    assert K2._prox_plan(v[:3], g[:3], v0[:3]) is not plan
    g_nc = [g[0].transpose(0, -1).contiguous().transpose(0, -1)] + g[1:]   # g[0]'s values
    assert not g_nc[0].is_contiguous()
    rv, rg, rv0 = K2.leaf_rows([v, g_nc, v0], inplace=True, written=(0,), what="prox_update")
    assert all(a is b for a, b in zip(rv + rv0, v + v0))       # contiguous ones as they are
    assert all(x.is_contiguous() and torch.equal(x, y) for x, y in zip(rg, g_nc))
    ptrs = K2.pointer_table([rv, rg, rv0, rv])                 # the kernel's row, in place
    assert ptrs.shape == (len(v), 4) and ptrs.dtype == np.int64
    assert [int(p) for p in ptrs[:, 0]] == [x.data_ptr() for x in v] == \
        [int(p) for p in ptrs[:, 3]]
    assert [int(p) for p in ptrs[:, 1]] == [x.data_ptr() for x in rg]
    assert [int(n) for n in plan.meta[:, 0]] == [x.numel() for x in v]
    meta = np.concatenate([m for _, m in plan.chunks])
    assert [int(n) for n in meta[:, 0]] == [x.numel() for x in v if x.numel()]
    assert [int(c) for c in meta[:, 1]] == [K2.CODES[(x.dtype, y.dtype)]
                                            for x, y in zip(v, g) if x.numel()]
    # the tree's empty leaf leaves the launch's rows to be picked; a launch of
    # every leaf in order takes the host table as it is
    assert plan.chunks[0][0] is not None
    live = [i for i, x in enumerate(v) if x.numel()]
    whole = K2._prox_plan(*([c[i] for i in live] for c in (v, g, v0)))
    assert [idx for idx, _ in whole.chunks] == [None]
    with pytest.raises(ValueError, match="contiguous"):
        K2.leaf_rows([[v[0].transpose(0, -1).contiguous().transpose(0, -1)] + v[1:], g, v0],
                     inplace=True, written=(0,), what="prox_update")
    with pytest.raises(ValueError, match="overlaps"):           # checked before the copies
        K2.leaf_rows([v, [g_nc[0], v[1]] + g[2:], v0], inplace=True, written=(0,),
                     what="prox_update")


def test_every_optimizer_makes_one_tree_call_a_step(monkeypatch):
    """A local step of every optimizer reaches K2 or K3 once, over every
    leaf (on the card: one launch; here the plain version, counted)."""
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda as C
    calls = []

    def counting(mod):
        inner = mod.plain_multi

        def plain_multi(vs, *a, **kw):
            calls.append((mod.__name__.rsplit(".", 1)[-1], len(vs)))
            return inner(vs, *a, **kw)
        monkeypatch.setattr(mod, "plain_multi", plain_multi)

    counting(K2)
    counting(K3)
    mcfg = mlp_config(n_features=8, d=16)
    rng = np.random.default_rng(7)
    y = (rng.random((4, 8)) < 0.6).astype(np.float32)
    batch = {"features": torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32)),
             "labels": torch.from_numpy(y)}
    for opt, kernel in (("sgd", "prox_update"), ("momentum", "opt_update"),
                        ("sm3", "opt_update"), ("shampoo_blocked", "prox_update")):
        ccfg = C.CoDAConfig(n_workers=4, p_pos=0.6, optimizer=opt, shampoo_block=8)
        for donate in (False, True):
            st = C.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0))
            calls.clear()
            C.local_step(mcfg, ccfg, st, batch, 0.3, inplace=donate)
            assert calls == [(kernel, 6)], (opt, donate, calls)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _offset(t, off):
    """``t``'s values at an element offset ``off`` into a buffer of their own:
    a leaf that is not 16-byte aligned."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


# (elements, v dtype, g or buffer dtype, element offset): tails, a leaf of one
# tile, misaligned leaves, an empty leaf, leaves of many tiles
CARD_SIZES = [(5, 0), (4096, 0), (4097, 0), (8193, 1), (777, 3), (0, 0), (65536, 0),
              (100_000, 2), (12345, 0)]


def _card_prox_case(dev, seed, n_leaves=None, sizes=CARD_SIZES):
    rng = np.random.default_rng(seed)
    kinds = [(F32, F32), (BF16, BF16), (BF16, F32)]
    cols = [[], [], []]
    for i, (n, off) in enumerate(sizes if n_leaves is None else
                                 [(int(rng.integers(1, 5000)), i % 3) for i in range(n_leaves)]):
        vdt, gdt = kinds[i % 3]
        for col, dt in zip(cols, (vdt, gdt, vdt)):
            col.append(_offset(_draw(rng, (n,), dt).to(dev), off if col is cols[0] else 0))
    return cols


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True])
def test_prox_multi_kernel_is_bitwise_the_plain_version_on_card(cuda_device, inplace):
    v, g, v0 = _card_prox_case(cuda_device, 0)
    want = [ref.prox_update_ref(a, b, c, 0.05, 0.5) for a, b, c in zip(v, g, v0)]
    n0 = K2.launches
    got = K2.prox_update_multi(v, g, v0, 0.05, 0.5, inplace=inplace)
    assert K2.launches - n0 == 1
    assert all(_same(a, b) for a, b in zip(got, want))
    if inplace:
        assert all(a is b for a, b in zip(got, v))


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mode", ["momentum", "precond"])
def test_opt_multi_kernel_is_bitwise_the_plain_version_on_card(cuda_device, mode, inplace):
    rng = np.random.default_rng(1)
    kinds = ([(F32, F32), (F32, BF16), (BF16, BF16), (BF16, F32)] if mode == "momentum"
             else [(F32, F32), (BF16, F32)])
    cols = [[], [], [], []]
    for i, (n, off) in enumerate(CARD_SIZES):
        vdt, bdt = kinds[i % len(kinds)]
        for k, dt in enumerate((vdt, vdt, vdt, bdt)):
            x = _draw(rng, (n,), dt, positive=k == 3 and mode == "precond").to(cuda_device)
            cols[k].append(_offset(x, off if k in (0, 3) else 0))
    seeds = _seeds(len(CARD_SIZES)).to(cuda_device) | 0x80000000     # uint32s past 2³¹
    coef = 0.9 if mode == "momentum" else 1e-6
    want = [ref.opt_update_ref(*x, 0.05, 0.5, coef, seeds[i], mode=mode)
            for i, x in enumerate(zip(*cols))]
    n0 = K3.launches
    nv, nb = K3.opt_update_multi(*cols, 0.05, 0.5, coef, seeds, mode=mode, inplace=inplace)
    assert K3.launches - n0 == 1
    assert all(_same(a, w[0]) and _same(b, w[1]) for a, b, w in zip(nv, nb, want))


@pytest.mark.cuda
def test_past_the_capacity_the_kernel_splits_on_card(cuda_device):
    v, g, v0 = _card_prox_case(cuda_device, 2, n_leaves=K2.MAX_LEAVES + 17)
    want = [ref.prox_update_ref(a, b, c, 0.05, 0.5) for a, b, c in zip(v, g, v0)]
    n0 = K2.launches
    got = K2.prox_update_multi(v, g, v0, 0.05, 0.5, inplace=True)
    assert K2.launches - n0 == 2
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_the_librarys_aliasing_check_is_the_pairwise_definition_on_card(cuda_device, seed):
    """``coda_multi_apart``, the in-place launches' check, on random host
    tables in both kernels' layouts (it reads no tensor, so the addresses
    need not be real): it says overlap exactly where the pairwise
    definition does."""
    from repro_torch.kernels import _build
    lib = _build.load()
    rng = np.random.default_rng(seed)
    for _ in range(500):
        kernel = int(rng.integers(1, 3))
        n, (cols, mcols) = int(rng.integers(1, 7)), ((4, 2) if kernel == 1 else (6, 3))
        ptrs = rng.integers(1, 3000, (n, cols)).astype(np.int64)
        if kernel == 1:
            ptrs[:, 3] = ptrs[:, 0]                                   # out = v: in place
        else:
            ptrs[:, 4], ptrs[:, 5] = ptrs[:, 0], ptrs[:, 3]           # and out_buf = buf
        meta = np.zeros((n, mcols), np.int64)
        meta[:, 0], meta[:, 1] = rng.integers(0, 20, n), rng.integers(0, 3 + (kernel == 2), n)
        if kernel == 2:
            meta[:, 2] = np.arange(n)
        lo, hi, written = [], [], []
        for p, (m, c) in zip(ptrs, meta[:, :2]):
            vb = 2 if (c != 0 if kernel == 1 else c >= 2) else 4    # v's bytes an element
            roles = ([(p[0], vb, True), (p[1], 2 if c == 1 else 4, False), (p[2], vb, False)]
                     if kernel == 1 else
                     [(p[0], vb, True), (p[1], vb, False), (p[2], vb, False),
                      (p[3], 2 if c in (1, 3) else 4, True)])
            for a, b, w in roles:
                lo, hi, written = lo + [a], hi + [a + m * b], written + [w]
        seeds, n_bytes = None, 0
        if kernel == 2 and rng.random() < 0.5:
            seeds, n_bytes = int(rng.integers(1, 3000)), 8 * n
            lo, hi, written = lo + [seeds], hi + [seeds + n_bytes], written + [False]
        got = lib.coda_multi_apart(kernel, n, ptrs.ctypes.data, meta.ctypes.data, seeds,
                                   n_bytes)
        assert got == int(_pairwise_overlap(lo, hi, written))


@pytest.mark.cuda
def test_a_written_leaf_overlapping_another_leafs_input_raises_on_card(cuda_device):
    """The library's check holds the CPU's rule on the card, across the
    launches of a tree past the table's capacity too."""
    flat = torch.randn(64, device=cuda_device)
    v = [flat[:16].view(4, 4), flat[16:32].view(4, 4)]
    g = [torch.randn(4, 4, device=cuda_device) for _ in range(2)]
    v0 = [torch.randn(4, 4, device=cuda_device) for _ in range(2)]
    K2.prox_update_multi(v, g, v0, 0.05, 0.5, inplace=True)
    g_over = [g[0], flat[8:24].view(4, 4)]
    with pytest.raises(ValueError, match="overlaps"):
        K2.prox_update_multi(v, g_over, v0, 0.05, 0.5, inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        K2.prox_update_multi([flat[:16].view(4, 4), flat[12:28].view(4, 4)], g, v0, 0.05, 0.5,
                             inplace=True)
    K2.prox_update_multi(v, g_over, v0, 0.05, 0.5)
    bufs = [torch.zeros(4, 4, device=cuda_device) for _ in range(2)]
    store = torch.zeros(16, dtype=torch.int64, device=cuda_device)
    seeds = store[:2].copy_(_seeds(2))
    K3.opt_update_multi(v, g, v0, bufs, 0.05, 0.5, 0.9, seeds, mode="momentum", inplace=True)
    with pytest.raises(ValueError, match="overlaps"):
        K3.opt_update_multi(v, g, v0, [bufs[0], g[0]], 0.05, 0.5, 0.9, seeds,
                            mode="momentum", inplace=True)
    over_seeds = store[:8].view(torch.float32).view(4, 4)        # a buffer over the seeds
    with pytest.raises(ValueError, match="overlaps"):
        K3.opt_update_multi(v, g, v0, [bufs[0], over_seeds], 0.05, 0.5, 0.9, seeds,
                            mode="momentum", inplace=True)
    # past the capacity: the last leaf's g reads the first leaf's v, two launches apart
    n = K2.MAX_LEAVES + 5
    big = torch.randn(n, 8, device=cuda_device)
    vs = list(big.unbind(0))
    gs = [torch.randn(8, device=cuda_device) for _ in range(n - 1)] + [big[0]]
    v0s = [torch.randn(8, device=cuda_device) for _ in range(n)]
    n0 = K2.launches
    with pytest.raises(ValueError, match="overlaps"):
        K2.prox_update_multi(vs, gs, v0s, 0.05, 0.5, inplace=True)
    assert K2.launches == n0                                        # nothing launched


@pytest.mark.cuda
@pytest.mark.parametrize("tree", ["mlp", "resnet50", "stablelm-1.6b:2:bfloat16",
                                  "resnet50+bf16buf"])
def test_the_geometry_query_is_the_wrappers_on_card(cuda_device, tree):
    for kernel in ("prox_update", "opt_update"):
        if kernel == "prox_update" and "+" in tree:
            continue
        rec = A.launch_record(kernel, {"tree": tree})
        rec.query = A.kernel_query(rec)
        assert A.launch_problems(rec) == []
    past = A.launch_record("opt_update", {"sizes": (7,) * 800, "codes": (0, 1, 2, 3) * 200})
    past.query = A.kernel_query(past)
    assert past.query["launches"] == 3 and A.launch_problems(past) == []


@pytest.mark.cuda
@pytest.mark.parametrize("opt,kernel", [("sgd", "prox_update"), ("momentum", "opt_update"),
                                        ("sm3", "opt_update"),
                                        ("shampoo_blocked", "prox_update")])
def test_a_local_step_is_one_launch_on_card(cuda_device, opt, kernel):
    """A local step launches its optimizer's kernel once, over every leaf;
    the optimizer step from one state and one gradient is bitwise the same
    with the kernels and with the plain versions, in place and not."""
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda as C
    from repro_torch.core import optimizer as Opt
    from repro_torch.tree import tree_leaves, tree_map
    mcfg = mlp_config(n_features=8, d=16)
    rng = np.random.default_rng(8)
    y = (rng.random((4, 8)) < 0.6).astype(np.float32)
    batch = {"features": torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32)
                                          ).to(cuda_device),
             "labels": torch.from_numpy(y).to(cuda_device)}
    mod = K2 if kernel == "prox_update" else K3
    ccfg = C.CoDAConfig(n_workers=4, p_pos=0.6, optimizer=opt, shampoo_block=8,
                        opt_dtype=BF16 if opt == "momentum" else F32)
    st = C.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0),
                      device=cuda_device)
    n0 = mod.launches
    st, _ = C.local_step(mcfg, ccfg, st, batch, 0.3, inplace=True)
    assert mod.launches - n0 == 1
    gp = tree_map(lambda x: torch.randn_like(x), st["params"])
    o = Opt.for_config(ccfg)
    for donate in (False, True):
        out = {}
        for impl in ("auto", "ref"):
            c = C.CoDAConfig(n_workers=4, p_pos=0.6, optimizer=opt, shampoo_block=8,
                             opt_dtype=ccfg.opt_dtype, impl=impl)
            params, refp = (tree_map(torch.clone, st[k]) for k in ("params", "ref_params"))
            opt_state = tree_map(torch.clone, st["opt"]) if "opt" in st else None
            n0 = mod.launches
            out[impl] = o.step(c, opt_state, params, gp, refp, 0.3, inplace=donate)
            assert mod.launches - n0 == (impl == "auto")
        got, want = (tree_leaves([p, s or []]) for p, s in (out["auto"], out["ref"]))
        assert len(got) == len(want) and all(_same(a, b) for a, b in zip(got, want))
