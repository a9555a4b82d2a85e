"""Kernel dispatch of repro_torch (kernels/ops.py), in the manner of
tests/test_kernels_dispatch.py: every (impl, device) pair, unknown impls
raise, and "auto" on CPU tensors never reaches the kernel build."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import auc_loss as auc_mod
from repro_torch.kernels import opt_update as opt_mod
from repro_torch.kernels import prox_update as prox_mod
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)


@pytest.mark.parametrize("device,impl,want", [
    ("cuda", "auto", True),      # the hand-written kernel on the card
    ("cpu", "auto", False),      # the plain version on the CPU
    ("cuda", "kernel", True),
    ("cuda", "ref", False),
    ("cpu", "ref", False),
])
def test_dispatch_per_device(device, impl, want):
    assert ops.dispatch(impl, torch.device(device)) is want


def test_kernel_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch("kernel", torch.device("cpu"))
    h = torch.rand(2, 8)
    d = torch.zeros(2)
    with pytest.raises(ValueError):
        ops.auc_loss(h, h, d, d, d, 0.5, impl="kernel")
    with pytest.raises(ValueError):
        ops.prox_update_tree({"w": h}, {"w": h}, {"w": h}, 0.1, 0.5,
                             impl="kernel")
    with pytest.raises(ValueError):
        ops.opt_update(h, h, h, h, 0.1, 0.5, 0.9, 7, mode="momentum",
                       impl="kernel")


@pytest.mark.parametrize("impl", ["pallas", "", "Auto", "triton"])
def test_dispatch_rejects_unknown_impl(impl):
    with pytest.raises(ValueError, match="unknown impl"):
        ops.dispatch(impl, torch.device("cpu"))


def test_auto_on_cpu_never_touches_build(monkeypatch):
    """"auto" and "ref" on CPU tensors give the plain version's numbers
    without building, loading or launching anything."""
    def boom(*a, **k):
        raise AssertionError("CPU dispatch reached the CUDA build")

    monkeypatch.setattr(_build, "build", boom)
    monkeypatch.setattr(_build, "load", boom)
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.random((3, 64), dtype=np.float32))
    y = torch.from_numpy((rng.random((3, 64)) < 0.7).astype(np.float32))
    a, b, al = (torch.from_numpy(rng.normal(0, 0.3, 3).astype(np.float32))
                for _ in range(3))
    n0, m0, o0 = auc_mod.launches, prox_mod.launches, opt_mod.launches
    for impl in ("auto", "ref"):
        got = ops.auc_loss(h, y, a, b, al, 0.7, impl=impl)
        for g, w in zip(got, ref.auc_loss_ref(h, y, a, b, al, 0.7)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        got = ops.prox_update_tree({"w": h}, {"w": y}, {"w": h}, 0.1, 0.5,
                                   impl=impl)
        torch.testing.assert_close(got["w"], ref.prox_update_ref(h, y, h, 0.1, 0.5),
                                   rtol=0, atol=0)
        for mode, buf in (("momentum", h.to(torch.bfloat16)), ("precond", y)):
            got = ops.opt_update(h, y, h, buf, 0.1, 0.5, 0.9, 7, mode=mode, impl=impl)
            want = ref.opt_update_ref(h, y, h, buf, 0.1, 0.5, 0.9, 7, mode=mode)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g, w)
    # the kernel wrappers themselves take the plain version for CPU tensors
    auc_mod.auc_loss(h, y, a, b, al, 0.7)
    prox_mod.prox_update(h, y, h, 0.1, 0.5)
    opt_mod.opt_update(h, y, h, y, 0.1, 0.5, 0.9, 7, mode="momentum")
    assert (auc_mod.launches, prox_mod.launches, opt_mod.launches) == (n0, m0, o0)


def test_wrappers_check_their_inputs():
    h = torch.rand(2, 8)
    d = torch.zeros(2)
    with pytest.raises(ValueError, match=r"\[K, T\]"):
        auc_mod.auc_loss(h[0], h[0], d, d, d, 0.5)
    with pytest.raises(ValueError, match="alpha"):
        auc_mod.auc_loss(h, h, d, d, 0.0, 0.5)
    with pytest.raises(ValueError, match="one shape"):
        prox_mod.prox_update(h, h[:1], h, 0.1, 0.5)
    with pytest.raises(ValueError, match="float32 or all"):
        prox_mod.prox_update(h, h.double(), h, 0.1, 0.5)
    with pytest.raises(ValueError, match="one shape"):
        opt_mod.opt_update(h, h, h, h[:1], 0.1, 0.5, 0.9, 7, mode="momentum")
    with pytest.raises(ValueError, match="float32 or all"):
        opt_mod.opt_update(h, h.bfloat16(), h, h, 0.1, 0.5, 0.9, 7, mode="momentum")
    with pytest.raises(ValueError, match="precond"):   # the cover is fp32 only
        opt_mod.opt_update(h, h, h, h.bfloat16(), 0.1, 0.5, 1e-6, 7, mode="precond")
    with pytest.raises(ValueError, match="unknown opt_update mode"):
        opt_mod.opt_update(h, h, h, h, 0.1, 0.5, 0.9, 7, mode="adam")


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    """The library name carries a hash of the source and flags, so an edited
    kernel is rebuilt instead of loading a stale binary."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "SOURCE", src)
    first = _build.library_path()
    src.write_text("// two")
    assert _build.library_path() != first
    assert first.name.startswith("libcoda_") and first.suffix == ".so"
