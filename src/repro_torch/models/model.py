"""Top-level model for the ported families ``mlp`` and ``cnn``
(counterpart of ``repro.models.model``).

``score(cfg, params, batch)`` is the scoring function h(w; x) ∈ [0, 1]
that CoDA maximizes AUC for: backbone → linear → sigmoid.  Every parameter
leaf carries a leading worker axis K and every input a leading ``[K, B]``:
the K replicas run as batched matmuls (mlp) or one grouped convolution
(cnn).  The public layouts are the reference's: mlp weights ``[d_in,
d_out]``, images ``[K, B, hw·hw, 3]``.  The other families arrive with the
model zoo (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import resnet

FAMILIES = ("mlp", "cnn")


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported "
                                  "yet (ROADMAP Queue 1 item 11, model zoo)")


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                dtype=torch.float32, device="cpu"):
    """One replica's parameters (no K axis), drawn on the CPU from
    ``generator`` with the reference's initialisers, then moved to
    ``device``.  The numbers differ from ``jax.random``'s; carry the
    reference's weights across with ``params.py`` to compare the two."""
    _check_family(cfg)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    d = cfg.d_model
    randn = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float32)
    p = {}
    if cfg.family == "cnn":
        p["backbone"] = resnet.init_resnet(cfg, generator=gen, dtype=dtype,
                                           device=device)
    else:
        dims = [cfg.n_features] + [d] * cfg.n_layers
        p["mlp"] = [{"w": (randn(di, do) * di ** -0.5).to(dtype=dtype, device=device),
                     "b": torch.zeros((do,), dtype=dtype, device=device)}
                    for di, do in zip(dims[:-1], dims[1:])]
    p["score_head"] = {
        "w": (randn(d, 1) * d ** -0.5).to(dtype=dtype, device=device),
        # the score bias stays fp32 whatever param_dtype is (model.py:62)
        "b": torch.zeros((1,), dtype=torch.float32, device=device)}
    return p


def backbone(cfg: ModelConfig, params, batch):
    """Returns (hidden [K, B, d], moe_aux [K] zeros) — the reference keeps a
    length-1 sequence axis that its mean-pool removes; here it is left out.
    The reference's ``use_window``/``train``/``impl`` arguments change
    nothing for these two families and are not taken."""
    _check_family(cfg)
    if cfg.family == "cnn":
        images = batch["images"]
        K, B, s, _ = images.shape
        hw = int(round(s ** 0.5))
        x = resnet.apply_resnet(cfg, params["backbone"],
                                images.reshape(K, B, hw, hw, 3))
    else:
        x = batch["features"]
        for lp in params["mlp"]:
            x = torch.relu(torch.bmm(x, lp["w"]) + lp["b"][:, None, :])
    return x, torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)


def score(cfg: ModelConfig, params, batch):
    """h(w; x) ∈ [0,1] per example.  Returns (scores [K, B], moe_aux [K])."""
    h, aux = backbone(cfg, params, batch)
    sh = params["score_head"]
    logit = torch.bmm(h, sh["w"])[..., 0].to(torch.float32) + sh["b"][:, :1]
    return torch.sigmoid(logit), aux
