"""Jax-free copy of ``repro.configs.base``: ``ModelConfig``, ``MoEConfig``
(field for field), ``mlp_config``, and the dry run's four global input
shapes (``ShapeSpec``, ``SHAPES``) with ``input_specs``, which gives their
stand-ins as ``meta`` tensors (the reference module imports jax).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (``repro.configs.base``).

    ``dispatch`` selects the eval/decode dispatch (training always uses
    capacity dispatch, which drops over-capacity tokens):
      * "sorted"   — dropless sort-based dispatch: [T·k, d] rows sorted by
                     expert and the ragged grouped GEMM (K5) over them;
      * "capacity" — the padded [E, C = T, d] scatter dispatch.
    """

    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic keeps a dense (always-on) residual MLP next to the experts.
    dense_residual: bool = False
    dense_d_ff: int = 0
    dispatch: str = "sorted"

    def __post_init__(self):
        if self.dispatch not in ("sorted", "capacity"):
            raise ValueError(
                f"unknown moe dispatch {self.dispatch!r} (want sorted | capacity)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (see ``repro.configs.base``)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""
    head_dim: int = 0
    rope: str = "1d"
    rope_fraction: float = 1.0
    rope_base: float = 10000.0
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "swiglu"
    window: int = 4096
    window_mode: str = "none"
    global_attn_every: int = 0
    moe: MoEConfig | None = None
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    slstm_every: int = 0
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    decoder_fraction: int = 4
    n_patches: int = 0
    tie_embeddings: bool = False
    n_features: int = 0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family not in ("dense", "moe", "vlm", "audio", "hybrid", "ssm",
                               "cnn", "mlp"):
            raise ValueError(f"unknown family {self.family!r}")

    def param_count(self) -> int:
        """Total parameter count N of one worker replica (``base.py:108``)."""
        from repro_torch.models import model as _model

        return _model.count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token reaches: an MoE counts only its top-k experts
        (``base.py:114``)."""
        from repro_torch.models import model as _model

        return _model.count_params(self, active_only=True)


def mlp_config(n_features: int = 64, d: int = 128, n_layers: int = 2) -> ModelConfig:
    """Tiny MLP scorer (the launcher's default model)."""
    return ModelConfig(name="mlp", family="mlp", n_layers=n_layers, d_model=d,
                       n_heads=1, n_kv_heads=1, d_ff=d, vocab_size=0,
                       rope="none", n_features=n_features)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One of the four assigned global input shapes (``base.py:121-128``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, n_workers: int = 1,
                window_steps: int = 1, dtype=torch.bfloat16) -> dict:
    """``meta`` tensors of every model input of a shape, the reference's
    shapes and dtypes (``base.py:148-188``): for train and prefill the CoDA
    window batch ``[window_steps, n_workers, per-worker batch, ...]``, for
    decode the request batch (the caches come from
    ``serving.decode.cache_specs``).  Token ids are int32, as the
    reference's are.  Nothing is allocated."""
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    S, B = shape.seq_len, shape.global_batch
    if shape.kind in ("train", "prefill"):
        if B % n_workers:
            raise ValueError(f"{cfg.name} {shape.name}: global batch {B} does not split "
                             f"over {n_workers} workers")
        lead = (window_steps, n_workers, B // n_workers)
        specs = {}
        if cfg.family == "vlm":
            specs["patches"] = meta(lead + (cfg.n_patches, cfg.d_model), dtype)
            specs["tokens"] = meta(lead + (S - cfg.n_patches,), torch.int32)
        elif cfg.family == "audio":
            specs["frames"] = meta(lead + (S, cfg.d_model), dtype)
            specs["tokens"] = meta(lead + (S // cfg.decoder_fraction,), torch.int32)
        elif cfg.family == "cnn":
            specs["images"] = meta(lead + (S, 3), dtype)          # flattened pixels
        elif cfg.family == "mlp":
            specs["features"] = meta(lead + (cfg.n_features,), dtype)
        else:
            specs["tokens"] = meta(lead + (S,), torch.int32)
        specs["labels"] = meta(lead, torch.float32)
        return specs
    return {"tokens": meta((B, 1), torch.int32), "positions": meta((B,), torch.int32)}
