"""chip_smoke.py's fp32 twin of a model with bf16 weights (``hidden_fp32``,
``prefill_fp32``, ``last_fp32``: each layer's weights widened to fp32
while it runs, so that a model which fits only in bf16 gets its fp32
result) walks the layers itself.  These tests pin it to the port's own
forward on the smoke configs, on the CPU:

  * ``prefill_fp32`` against ``prefill_step(impl="ref")`` on the widened
    weights: bitwise (the same operations on the same values);
  * ``last_fp32`` on right-padded sequences of two lengths against
    ``serve_step`` fed one token at a time (what the engine reports as
    ``Request.score``, and its logits): atol = rtol = 2e-3, decode against
    the parallel forward as in tests/test_torch_serving.py.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import decode as D
from repro_torch.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (this module's autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               os.path.join(ROOT, "chip_smoke.py"))
CS = sys.modules["chip_smoke"] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

ARCHS = ["stablelm-1.6b", "chatglm3-6b", "qwen2.5-14b", "dbrx-132b", "hymba-1.5b"]


def _bf16_params(cfg, seed=0):
    p = M.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                      dtype=torch.bfloat16)
    return tree_map(lambda x: x[None], p)                       # K = 1


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-2b"])
def test_prefill_fp32_equals_prefill_step_on_widened_weights(arch):
    cfg = get_smoke_config(arch)
    p = _bf16_params(cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 2, 12)))}
    if cfg.family == "vlm":             # fp32 patches, as the launcher's stub
        batch["patches"] = torch.from_numpy(
            rng.standard_normal((1, 2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        s, logits, (k, v) = CS.prefill_fp32(cfg, p, batch)
        ws, wlogits, (wk, wv) = M.prefill_step(cfg, CS._f32(p), batch, impl="ref")
    assert s.dtype == logits.dtype == torch.float32
    assert k.dtype == v.dtype == torch.bfloat16
    for got, want in ((s, ws), (logits, wlogits), (k, wk), (v, wv)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_last_fp32_equals_serve_steps(arch):
    cfg = get_smoke_config(arch)
    p = _bf16_params(cfg, seed=2)
    p32 = CS._f32(p)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9)]
    with torch.no_grad():
        logits, score = CS.last_fp32(cfg, p, seqs)
        for i, q in enumerate(seqs):
            cache = D.init_cache(cfg, 1, 16, use_window=False, dtype=torch.float32)
            for t, tok in enumerate(q):
                want, wscore, cache = D.serve_step(
                    cfg, p32, cache, torch.tensor([[tok]]),
                    torch.tensor([t], dtype=torch.int32), use_window=False, impl="ref")
            np.testing.assert_allclose(logits[i].numpy(), want[0].float().numpy(),
                                       atol=2e-3, rtol=2e-3)
            np.testing.assert_allclose(float(score[i]), float(wscore[0]), atol=2e-3,
                                       rtol=2e-3)


def test_settled_positions_stop_at_the_first_flip_below():
    """A routing flip at (layer l, position q) unsettles every position from
    q on in the layers above l, and nothing in layers up to l."""
    L, B, S, k = 3, 2, 5, 2
    base = torch.arange(L * B * S * k).reshape(L, B * S, k)
    other = base.clone()
    other[0, 2, 1] += 1000            # layer 0, sequence 0, position 2
    third = base.clone()
    third[1, S + 4, 0] += 1000        # layer 1, sequence 1, position 4
    got = CS.settled((base, other, third), B, S)
    want = torch.ones((L, B, S), dtype=torch.bool)
    want[1:, 0, 2:] = False
    want[2:, 1, 4:] = False
    assert torch.equal(got, want)
    assert bool(CS.settled((base, base.clone()), B, S).all())


def test_recorded_sees_every_route_and_k5_call(monkeypatch):
    """``recorded`` returns the K5 calls' shapes and one [T, k] expert set a
    moe layer, and puts the model's own functions back.  The dispatch is
    sent to K5's wrapper as on the card; on CPU tensors it runs the plain
    version."""
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    monkeypatch.setattr(ops, "dispatch", lambda impl, device: impl == "auto")
    cfg = get_smoke_config("dbrx-132b")
    p = _bf16_params(cfg)
    route, gmm = moe.route, md.grouped_matmul
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 2, 6)))
    with torch.no_grad():
        (s, _, _), shapes, routes = CS.recorded(
            lambda: M.prefill_step(cfg, p, {"tokens": tokens}), routes=True)
        want, _, _ = M.prefill_step(cfg, p, {"tokens": tokens})
    assert moe.route is route and md.grouped_matmul is gmm
    assert torch.equal(s, want)
    k = cfg.moe.top_k
    assert routes.shape == (cfg.n_layers, 12, k)
    assert bool((routes[..., 1:] > routes[..., :-1]).all())
    assert shapes == {(12 * k, cfg.d_model, cfg.d_ff, "bfloat16"),
                      (12 * k, cfg.d_ff, cfg.d_model, "bfloat16")}
