"""repro_torch.core.optimizer and the opt_update plain version vs
repro.core.optimizer / repro.kernels, mirroring tests/test_optimizer.py.

Inputs are numpy arrays from a seed; the reference's states are carried
across with ``repro_torch.params`` (HWIO↔OIHW for the cnn).  Tolerances
and why:

  * stochastic-rounding bits, leaf seeds, sketch-free bookkeeping, state
    bytes: exact;
  * ``opt_update_ref`` momentum vs the reference's eager oracle: bitwise
    (the same fp32 operations in the same order, the same hash);
  * precond: ν bitwise; v' atol 1e-6 — the port's 1/√x (IEEE sqrt, then
    division) and ``jax.lax.rsqrt`` on the CPU are each within 1 ulp of the
    correctly rounded value, so d may differ by 2 ulp;
  * against the Pallas kernel in interpret mode: the reference's own idiom
    (rtol = atol = 1e-6; 1e-2 for a bf16 buffer) — that program is compiled
    separately and XLA may contract its multiply-adds into FMAs;
  * one ``apply_grads`` from a carried-across state (eager on both sides):
    momentum bitwise; sm3 accumulators bitwise and params atol 1e-6 (the
    rsqrt above); shampoo params atol 1e-5 and preconditioners atol 1e-4
    (15 Newton–Schulz rounds of batched fp32 matmuls summed in another
    order);
  * a whole ``fit`` (fp32 optimizer state) against the reference's jitted
    ``fit`` on replayed windows: losses rtol 1e-4, params atol 1e-4 (XLA's
    FMA contraction, compounded over 32 steps).  bf16 state is held bitwise
    one step at a time above: through a jitted reference, a last-bit fp32
    difference re-rolls a stochastic-rounding hash.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import mlp_config as jax_mlp_config
from repro.core import coda as JC
from repro.core import optimizer as JOpt
from repro.core import schedules as JS
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.kernels import ref as jref
from repro_torch import params as P
from repro_torch.configs import get_smoke_config, mlp_config
from repro_torch.core import coda as C
from repro_torch.core import optimizer as Opt
from repro_torch.core import schedules as S
from repro_torch.kernels import ops, ref
from repro_torch.tree import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

NF = 8
ARCHS = {"mlp": (mlp_config(n_features=NF, d=16), jax_mlp_config(n_features=NF, d=16)),
         "cnn": (get_smoke_config("resnet50"), jax_smoke_config("resnet50"))}


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _window(arch, seed, I, K, B):
    rng = np.random.default_rng(seed)
    y = (rng.random((I, K, B)) < 0.7).astype(np.float32)
    if arch == "mlp":
        x = rng.standard_normal((I, K, B, NF)).astype(np.float32) + 0.3 * (2 * y[..., None] - 1)
        return {"features": x, "labels": y}
    x = rng.standard_normal((I, K, B, 64, 3)).astype(np.float32) + 0.2 * (2 * y[..., None, None] - 1)
    return {"images": x, "labels": y}


def _pair(arch="mlp", K=4, seed=0, **kw):
    """(reference config, reference numpy state, port config, port state)
    from the same initial weights."""
    mcfg, jmcfg = ARCHS[arch]
    jkw = {k: _JDT.get(v, v) if k == "opt_dtype" else v for k, v in kw.items()}
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, **jkw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, **kw)
    jst = _np(JC.init_state(jax.random.PRNGKey(seed), jmcfg, jccfg))
    return jccfg, jst, ccfg, P.state_from_jax(mcfg, ccfg, jst)


def _flat(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _close(got, want, atol, what=""):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        if atol == 0:
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=what)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# sgd has no state; payload is optimizer-independent
# --------------------------------------------------------------------------
def test_sgd_state_has_no_opt_entry_and_payload_is_optimizer_independent():
    _, jst, _, st = _pair()
    assert set(st) == {"params", "duals", "ref_params", "ref_duals"}
    base = C.window_payload_bytes(st)
    assert base == JC.window_payload_bytes(jst)
    assert C.opt_state_bytes(st) == 0
    for name in ("momentum", "sm3", "shampoo_blocked"):
        _, jst, _, st = _pair(optimizer=name, shampoo_block=8)
        assert "opt" in st, name
        assert C.window_payload_bytes(st) == base, name
        assert C.opt_state_bytes(st) == JC.opt_state_bytes(jst) > 0, name


@pytest.mark.parametrize("compress", [None, "int8"])
def test_momentum_beta0_fp32_reproduces_sgd_bitwise(compress):
    kw = {"avg_compress": compress} if compress else {}
    _, _, ccfg_s, st_s = _pair(**kw)
    _, _, ccfg_m, st_m = _pair(optimizer="momentum", opt_beta=0.0, **kw)
    wb = _t(_window("mlp", 0, 3, 4, 8))
    out_s, loss_s = C.window_step(ARCHS["mlp"][0], ccfg_s, st_s, wb, 0.1)
    out_m, loss_m = C.window_step(ARCHS["mlp"][0], ccfg_m, st_m, wb, 0.1)
    _equal({k: out_m[k] for k in out_s}, out_s)
    assert torch.equal(loss_s, loss_m)


def test_opt_update_coef0_is_prox_update_bitwise():
    rng = np.random.default_rng(0)
    v, g, v0 = (torch.from_numpy(rng.standard_normal(257).astype(np.float32))
                for _ in range(3))
    m = torch.zeros(257)
    for impl in ("ref", "auto"):
        nv, nm = ops.opt_update(v, g, v0, m, 0.1, 0.5, 0.0, 7, mode="momentum",
                                impl=impl)
        assert torch.equal(nv, ref.prox_update_ref(v, g, v0, 0.1, 0.5))
        assert torch.equal(nm, g)


# --------------------------------------------------------------------------
# optimizer state is strictly local
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,kw", [
    ("momentum", {}),
    ("sm3", {}),
    ("shampoo_blocked", {"shampoo_block": 8, "precond_every": 2}),
])
def test_averaging_never_touches_opt_state(name, kw):
    """After a communicating window the opt subtree is bitwise the silent
    window's, the params are replicated, and the per-worker accumulators
    still differ across workers."""
    mcfg = ARCHS["mlp"][0]
    for compress in ([None] if name == "shampoo_blocked" else [None, "int8"]):
        extra = {"avg_compress": compress} if compress else {}
        _, _, ccfg, st0 = _pair(optimizer=name, **kw, **extra)
        wb = _t(_window("mlp", 1, 3, 4, 8))
        synced, _ = C.window_step(mcfg, ccfg, st0, wb, 0.1)
        silent, _ = C.window_step(mcfg, ccfg, st0, wb, 0.1, communicate=False)
        _equal(synced["opt"], silent["opt"])
        assert int(synced["opt"]["t"][0]) == 3
        for leaf in tree_leaves(synced["params"]):
            assert torch.equal(leaf, leaf[:1].expand_as(leaf))
        bufs = [l for l in tree_leaves(synced["opt"]["leaves"]) if l.dim() > 1]
        assert any(not torch.equal(l[0], l[1]) for l in bufs), name


# --------------------------------------------------------------------------
# bf16 accumulators
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["momentum", "sm3"])
def test_bf16_opt_state_drift_is_bounded(name):
    mcfg = ARCHS["mlp"][0]
    _, _, c32, st32 = _pair(optimizer=name)
    _, _, c16, st16 = _pair(optimizer=name, opt_dtype=torch.bfloat16)
    wb = _t(_window("mlp", 2, 3, 4, 8))
    for _ in range(4):
        st32, _ = C.window_step(mcfg, c32, st32, wb, 0.1)
        st16, _ = C.window_step(mcfg, c16, st16, wb, 0.1)
    for a, b in zip(tree_leaves(st16["params"]), tree_leaves(st32["params"])):
        assert float((a - b).abs().max()) < 2e-2, name
    assert C.opt_state_bytes(st16) < C.opt_state_bytes(st32)


@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_bf16_halves_opt_state_bytes_and_abstract_matches_concrete(arch):
    """Shape-only bytes (``meta`` tensors) equal the real state's and the
    reference's; bf16 halves them."""
    mcfg, jmcfg = ARCHS[arch]
    for name in ("momentum", "sm3", "shampoo_blocked"):
        sizes = {}
        for dt in (torch.float32, torch.bfloat16):
            ccfg = C.CoDAConfig(n_workers=4, optimizer=name, opt_dtype=dt, shampoo_block=8)
            jccfg = JC.CoDAConfig(n_workers=4, optimizer=name, opt_dtype=_JDT[dt],
                                  shampoo_block=8)
            st = C.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0))
            sizes[dt] = C.opt_state_bytes(st)
            jst = jax.eval_shape(lambda: JC.init_state(jax.random.PRNGKey(0), jmcfg, jccfg))
            assert sizes[dt] == JC.opt_state_bytes(jst), (name, dt)
            assert Opt.abstract_state_bytes(ccfg, st["params"]) == sizes[dt]
        assert sizes[torch.float32] / sizes[torch.bfloat16] >= 1.9, name


def test_registry_names_and_config_validation():
    assert set(Opt.names()) == set(JOpt.names()) == {
        "sgd", "momentum", "sm3", "shampoo_blocked"}
    for bad, match in [({"optimizer": "adam"}, "unknown optimizer"),
                       ({"optimizer": "sm3", "opt_dtype": torch.float16}, "opt_dtype"),
                       ({"shampoo_block": 0}, "shampoo_block"),
                       ({"precond_every": 0}, "precond_every"),
                       ({"opt_beta": 1.0}, "opt_beta"),
                       ({"opt_eps": 0.0}, "opt_eps")]:
        with pytest.raises(ValueError, match=match):
            C.CoDAConfig(n_workers=2, **bad)


# --------------------------------------------------------------------------
# the kernel's plain version: seeds, hash, fused update
# --------------------------------------------------------------------------
def test_leaf_seeds_match_reference():
    for t0 in (0, 1, 7, 123456789, 2**31 - 1):
        t = np.full(4, t0, np.int32)
        got = Opt.leaf_seeds(torch.from_numpy(t), 160).numpy()
        want = [int(JOpt._leaf_seed(jnp.asarray(t), i)) for i in range(160)]
        assert got.tolist() == want, t0


def _edge_patterns(rng):
    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00800000,
                        0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
                        0x7FFFFFFF, 0xFFFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF], np.uint32)
    high = rng.integers(0, 1 << 16, 300, dtype=np.uint32) << 16
    low = np.array([0x7FFF, 0x8000, 0xFFFF], np.uint32).repeat(100)
    return np.concatenate([special, high | low]).view(np.float32)


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 + 5, 2**32 - 1])
def test_stochastic_round_bits_match_reference(seed):
    """Random values, ±0, subnormals, ±inf, NaNs, and low halves at 0x7FFF,
    0x8000 and 0xFFFF: the bf16 bits equal the reference's."""
    rng = np.random.default_rng(seed % 1000)
    x = np.concatenate([rng.standard_normal(20000).astype(np.float32) * 10,
                        _edge_patterns(rng)])
    want = np.asarray(jref.stochastic_round(jnp.asarray(x), jnp.uint32(seed),
                                            jnp.bfloat16)).view(np.uint16)
    for s in (seed, torch.tensor(seed, dtype=torch.int64)):
        got = ref.stochastic_round(torch.from_numpy(x), s, torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    same = ref.stochastic_round(torch.from_numpy(x), seed, torch.float32)
    np.testing.assert_array_equal(same.numpy().view(np.uint32), x.view(np.uint32))


def _opt_inputs(n, mode, v_dtype, buf_dtype):
    rng = np.random.default_rng(n)
    v, g, v0 = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    buf = (rng.standard_normal(n) if mode == "momentum"
           else np.abs(rng.standard_normal(n))).astype(np.float32)
    jv, jg, jv0 = (jnp.asarray(a, v_dtype) for a in (v, g, v0))
    jb = jnp.asarray(buf, buf_dtype)
    tv, tg, tv0, tb = (torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        for a in (jv, jg, jv0, jb))
    return (jv, jg, jv0, jb), (tv, tg, tv0, tb)


@pytest.mark.parametrize("mode,v_dtype,buf_dtype", [
    ("momentum", jnp.float32, jnp.float32),
    ("momentum", jnp.float32, jnp.bfloat16),
    ("momentum", jnp.bfloat16, jnp.bfloat16),
    ("precond", jnp.float32, jnp.float32),
])
@pytest.mark.parametrize("n", [64, 1000, 4097])
def test_opt_update_ref_matches_reference(mode, v_dtype, buf_dtype, n):
    """Against the reference's oracle (bitwise, but v' in precond: 2 ulp of
    rsqrt) and against its Pallas kernel in interpret mode."""
    jargs, targs = _opt_inputs(n, mode, v_dtype, buf_dtype)
    coef = 0.9 if mode == "momentum" else 1e-6
    seed = 12345 + n
    got_v, got_b = ref.opt_update_ref(*targs, 0.1, 0.5, coef, seed, mode=mode)
    assert got_v.dtype == targs[0].dtype and got_b.dtype == targs[3].dtype
    got_v, got_b = got_v.float().numpy(), got_b.float().numpy()
    want_v, want_b = jref.opt_update_ref(*jargs, 0.1, 0.5, coef, jnp.uint32(seed),
                                         mode=mode)
    np.testing.assert_array_equal(got_b, np.asarray(want_b, np.float32))
    if mode == "momentum":
        np.testing.assert_array_equal(got_v, np.asarray(want_v, np.float32))
    else:
        np.testing.assert_allclose(got_v, np.asarray(want_v), rtol=0, atol=1e-6)
    kv, kb = jops.opt_update(*jargs, 0.1, 0.5, coef, jnp.uint32(seed), mode=mode,
                             impl="pallas")
    vtol = 1e-2 if v_dtype == jnp.bfloat16 else 1e-6
    btol = 1e-2 if buf_dtype == jnp.bfloat16 else 1e-6
    np.testing.assert_allclose(got_v, np.asarray(kv, np.float32), rtol=vtol, atol=vtol)
    np.testing.assert_allclose(got_b, np.asarray(kb, np.float32), rtol=btol, atol=btol)


def test_inv_sqrt_psd_matches_reference():
    rng = np.random.default_rng(3)
    g = rng.standard_normal((3, 4, 8, 5)).astype(np.float32)
    a = np.einsum("knbi,knci->knbc", g, g)
    got = Opt._inv_sqrt_psd(torch.from_numpy(a), 1e-6).numpy()
    want = np.asarray(JOpt._inv_sqrt_psd(jnp.asarray(a), 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# one apply_grads per optimizer from a carried-across state (mlp and cnn)
# --------------------------------------------------------------------------
# the cnn's kinds of leaves in the reference's layout (one replica): HWIO
# convolutions, 3×3 and 1×1 with cin ≠ cout, GroupNorm vectors, the head
CNN_SHAPES = {"backbone": {"stem": {"w": (3, 3, 3, 8), "gn": {"bias": (8,), "scale": (8,)}},
                           "stages": [[{"w1": (1, 1, 8, 4), "w2": (3, 3, 4, 4),
                                        "wproj": (1, 1, 8, 16)}]]},
              "score_head": {"w": (16, 1), "b": (1,)}}


def _random_state(arch, K, rng, jccfg):
    """A reference CoDA state (numpy) with random parameters, duals and a
    random, non-trivial optimizer state, for ``arch``'s kinds of leaves."""
    if arch == "mlp":
        shapes = jax.tree_util.tree_map(
            lambda l: l.shape, jax.eval_shape(lambda: JM.init_params(
                jax.random.PRNGKey(0), ARCHS["mlp"][1])))
    else:
        shapes = CNN_SHAPES
    is_shape = lambda x: isinstance(x, tuple) and all(isinstance(d, int) for d in x)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal((K,) + s)).astype(np.float32), shapes,
        is_leaf=is_shape)
    noise = lambda l: (l + 0.01 * rng.standard_normal(l.shape)).astype(np.float32)
    duals = {k: (0.1 * rng.standard_normal(K)).astype(np.float32) for k in ("a", "alpha", "b")}
    opt = jax.eval_shape(lambda p: JOpt.for_config(jccfg).init(jccfg, p), params)
    return {"params": params, "duals": duals,
            "ref_params": jax.tree_util.tree_map(noise, params),
            "ref_duals": {k: noise(duals[k]) for k in ("a", "b")},
            "opt": _random_opt_state(rng, opt, jccfg.optimizer)}


def _random_opt_state(rng, opt, name):
    """Random contents of the right kind for an opt tree of shapes: signed
    momentum, non-negative SM3 accumulators, PSD Shampoo statistics."""
    def fill(x):
        if name == "momentum":
            r = 0.1 * rng.standard_normal(x.shape)
        elif name == "sm3":
            r = 0.01 * np.abs(rng.standard_normal(x.shape))
        else:   # [K, nb, b, b]: a sum of outer products
            g = rng.standard_normal(x.shape[:-1] + (3,))
            r = 0.01 * np.einsum("...bi,...ci->...bc", g, g)
        return np.asarray(jnp.asarray(r, x.dtype))

    return {"t": np.full(opt["t"].shape, 5, np.int32),
            "leaves": jax.tree_util.tree_map(fill, opt["leaves"])}


CASES = [("momentum", torch.float32, {}), ("momentum", torch.bfloat16, {}),
         ("sm3", torch.bfloat16, {}), ("shampoo_blocked", torch.float32, {"shampoo_block": 8})]


@pytest.mark.parametrize("arch", ["mlp", "cnn"])
@pytest.mark.parametrize("name,dt,kw", CASES, ids=[f"{c[0]}-{str(c[1])[6:]}" for c in CASES])
def test_apply_grads_matches_reference(arch, name, dt, kw):
    """A random state with a non-trivial optimizer state (numpy, in the
    reference's layout) is carried across, and the same gradients go
    through both ``apply_grads`` (eager).  On the cnn's leaves this holds the
    OIHW layout of momentum buffers, the reference axis order of SM3's
    accumulators (and of their bf16 rounding seeds) and the reference
    flattening of Shampoo's blocks."""
    mcfg = ARCHS[arch][0]
    K = 2
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, optimizer=name, opt_dtype=_JDT[dt], **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, optimizer=name, opt_dtype=dt, **kw)
    rng = np.random.default_rng(4)
    jst = _random_state(arch, K, rng, jccfg)
    jgp = jax.tree_util.tree_map(
        lambda l: (0.1 * rng.standard_normal(l.shape)).astype(np.float32), jst["params"])
    jgd = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
           for k, v in jst["duals"].items()}
    want = _np(JC.apply_grads(jccfg, _jnp(jst), (_jnp(jgp), _jnp(jgd)), jnp.float32(0.05)))
    port = P.state_from_jax(mcfg, ccfg, jst)
    gd = {k: torch.from_numpy(v) for k, v in jgd.items()}
    got = P.state_to_jax(mcfg, C.apply_grads(ccfg, port, (P.from_jax_params(mcfg, jgp), gd),
                                             0.05), ccfg)
    assert int(got["opt"]["t"][0]) == int(want["opt"]["t"][0]) == 6
    if name == "momentum":
        _close(got, want, 0, name)
    elif name == "sm3":
        _close(got["opt"], want["opt"], 0, "sm3 accumulators")
        _close(got["params"], want["params"], 1e-6, "sm3 params")
        _close(got["duals"], want["duals"], 0, "duals")
    else:
        _close([l["s"] for l in got["opt"]["leaves"]],
               [l["s"] for l in want["opt"]["leaves"]], 0, "shampoo stats")
        _close([l["p"] for l in got["opt"]["leaves"]],
               [l["p"] for l in want["opt"]["leaves"]], 1e-4, "shampoo preconditioners")
        _close(got["params"], want["params"], 1e-5, "shampoo params")


# --------------------------------------------------------------------------
# the whole slice: fit per optimizer on replayed windows
# --------------------------------------------------------------------------
def _replayed_fit(K, I, B, jccfg, ccfg, n_stages=2):
    """The reference's fit on recorded windows, and the port's replaying them
    from the same initial state."""
    mcfg, jmcfg = ARCHS["mlp"]
    key = jax.random.PRNGKey(7)
    kw = dict(n_workers=K, eta0=0.5, T0=8, I0=I)
    windows, alphas = [], []

    def record(store, n, lead, seed_base):
        rng = np.random.default_rng(seed_base + len(store))
        y = (rng.random(lead + (n,)) < 0.7).astype(np.float32)
        x = rng.standard_normal(lead + (n, NF)).astype(np.float32) + 0.5 * (2 * y[..., None] - 1)
        store.append({"features": x, "labels": y})
        return _jnp(store[-1])

    jres = JC.fit(key, jmcfg, jccfg, JS.ScheduleConfig(**kw), n_stages,
                  sample_window=lambda k, i: record(windows, B, (i, K), 0),
                  sample_alpha_batch=lambda k, m: record(alphas, m, (K,), 1000))
    st0 = P.state_from_jax(mcfg, ccfg, _np(JC.init_state(key, jmcfg, jccfg)))
    wit, ait = iter(windows), iter(alphas)
    res = C.fit(st0, mcfg, ccfg, S.ScheduleConfig(**kw), n_stages,
                sample_window=lambda i: _t(next(wit)),
                sample_alpha_batch=lambda m: _t(next(ait)))
    assert next(wit, None) is None and next(ait, None) is None
    assert (res.iterations, res.comm_rounds) == (jres.iterations, jres.comm_rounds)
    assert [h[:2] for h in res.history] == [h[:2] for h in jres.history]
    return jres, res


FIT_CASES = [("momentum", torch.float32, {}), ("sm3", torch.float32, {}),
             ("shampoo_blocked", torch.float32, {"shampoo_block": 8, "precond_every": 2})]


@pytest.mark.parametrize("name,dt,kw", FIT_CASES, ids=[c[0] for c in FIT_CASES])
def test_fit_matches_reference_per_optimizer(name, dt, kw):
    K = 4
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.7, optimizer=name, opt_dtype=_JDT[dt], **kw)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.7, optimizer=name, opt_dtype=dt, **kw)
    jres, res = _replayed_fit(K, 4, 16, jccfg, ccfg)
    assert (res.iterations, res.comm_rounds) == (32, 10)
    np.testing.assert_allclose([h[2] for h in res.history], [h[2] for h in jres.history],
                               rtol=1e-4, atol=1e-6)
    got = P.state_to_jax(ARCHS["mlp"][0], res.state, ccfg)
    want = _np(jres.state)
    _close(got["params"], want["params"], 1e-4, "params")
    _close(got["duals"], want["duals"], 1e-4, "duals")
    assert int(got["opt"]["t"][0]) == int(want["opt"]["t"][0]) == 32
