"""sgd on xlstm-350m at full width: the reference and the port side by side.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/xlstm_stability.py \
        [--layers 8] [--eta 0.5 0.05] [--steps 8]

On the CPU (it imports both packages, like the tests): the reference's
jitted ``coda.local_step`` and the port's, from the same initial state (the
reference's, carried across with ``repro_torch.params``) on the same seeded
token batch, at full width (d_model 1024, 4 heads, mLSTM heads of 512) with
the depth and the vocabulary cut (``--layers``, vocabulary 512) so that it
fits a CPU.  Each step prints both packages' per-worker losses, whether
every parameter is still finite, and the range of the first mLSTM layer's
input-gate pre-activations in the port.  At the launcher's eta0 = 0.5 both
go NaN within a few steps: the input gate grows until a row's exp(-m)
overflows in ``apply_mlstm``, and the backward multiplies 0 by inf.

First it prints how far apart the first step's gradients are: the port's
from the reference's, and the reference's from itself with the mLSTM's
chunk at 16 instead of 64 (the same function summed in another order),
each as the largest max |difference| / max |gradient| over the leaves.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import coda as JC
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import coda as C
from repro_torch.models import xlstm as X


def finite(tree) -> bool:
    return all(bool(np.isfinite(np.asarray(x)).all()) for x in jax.tree_util.tree_leaves(tree))


def input_gate_range(cfg, params, batch) -> tuple[float, float]:
    """min and max of the first layer's ig = x @ wi + bi on ``batch``."""
    from repro_torch.models.embeddings import apply_norm, embed
    lp = params["layers"][0]
    with torch.no_grad():
        x = apply_norm(cfg, lp["norm1"], embed(params["embed"], batch["tokens"]))
        ig = X._mlstm_qkv(cfg, lp["core"], x)[3]
    return float(ig.min()), float(ig.max())


def _setup(layers: int, K: int, B: int, S: int):
    cut = {"n_layers": layers, "vocab_size": 512}
    jcfg = dataclasses.replace(jax_get_config("xlstm-350m"), **cut)
    cfg = dataclasses.replace(get_config("xlstm-350m"), **cut)
    jccfg = JC.CoDAConfig(n_workers=K, p_pos=0.71)
    ccfg = C.CoDAConfig(n_workers=K, p_pos=0.71)
    jst = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JC.init_state(k, jcfg, jccfg))(jax.random.PRNGKey(0)))
    st = P.state_from_jax(cfg, ccfg, jst)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cut["vocab_size"], (K, B, S)).astype(np.int32),
             "labels": (rng.random((K, B)) < 0.71).astype(np.float32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jcfg, cfg, jccfg, ccfg, jst, st, batch, tb


def worst_rel(a, b) -> float:
    return max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))
               if np.abs(y).max() > 0)


def gradient_spread(layers: int, K: int = 2, B: int = 16, S: int = 64):
    from repro import flags
    jcfg, cfg, jccfg, ccfg, jst, st, batch, tb = _setup(layers, K, B, S)
    grads = lambda: jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda s_, b_: JC.grad_step(jcfg, jccfg, s_, b_))(jst, batch)[1][0])
    ref = grads()
    _, (gp, _), _ = C.grad_step_scores(cfg, ccfg, st, tb)
    chunk = flags.mlstm_chunk
    flags.mlstm_chunk = lambda s, default=256: 16
    try:
        ref16 = grads()
    finally:
        flags.mlstm_chunk = chunk
    print(f"layers {layers}: the first step's gradients, max |difference| / max |gradient| "
          f"over the leaves: port vs reference {worst_rel(P.to_jax_params(cfg, gp), ref):.3g}; "
          f"reference chunk 16 vs 64 {worst_rel(ref16, ref):.3g}", flush=True)


def run(layers: int, eta: float, steps: int, K: int = 2, B: int = 16, S: int = 64):
    jcfg, cfg, jccfg, ccfg, jst, st, batch, tb = _setup(layers, K, B, S)
    step = jax.jit(lambda s_, b_: JC.local_step(jcfg, jccfg, s_, b_, eta))
    js = jax.tree_util.tree_map(jax.numpy.asarray, jst)
    print(f"layers {layers}, eta {eta}: K={K}, B={B}, S={S}, d_model {cfg.d_model}")
    for i in range(steps):
        lo, hi = input_gate_range(cfg, st["params"], tb)
        js, jl = step(js, batch)
        st, pl = C.local_step(cfg, ccfg, st, tb, eta)
        print(f"  step {i}: reference losses {np.round(np.asarray(jl), 5).tolist()} "
              f"finite {finite(js['params'])} | port losses "
              f"{np.round(pl.detach().numpy(), 5).tolist()} "
              f"finite {finite(P.to_jax_params(cfg, st['params']))} | port layer-0 input gate "
              f"in [{lo:.1f}, {hi:.1f}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--eta", type=float, nargs="+", default=[0.5, 0.05])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(4)
    gradient_spread(args.layers)
    for eta in args.eta:
        run(args.layers, eta, args.steps)


if __name__ == "__main__":
    main()
