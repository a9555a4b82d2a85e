"""Jax-free copy of ``repro.configs.base``'s ``ModelConfig`` and
``mlp_config`` (the reference module imports jax).

Only the fields the ported families (``mlp``, ``cnn``, ``dense``,
``moe``, ``vlm``, ``hybrid``, ``audio``) read are used; the rest (the
xLSTM's) are kept so a config reads the same in both packages.  ``MoEConfig`` is the reference's, field for field.
"""
from __future__ import annotations

import dataclasses


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


def mlp_config(n_features: int = 64, d: int = 128, n_layers: int = 2) -> ModelConfig:
    """Tiny MLP scorer (the launcher's default model)."""
    return ModelConfig(name="mlp", family="mlp", n_layers=n_layers, d_model=d,
                       n_heads=1, n_kv_heads=1, d_ff=d, vocab_size=0,
                       rope="none", n_features=n_features)
