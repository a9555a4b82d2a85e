"""seamless-m4t-medium [audio] — encoder-decoder, multimodal. [arXiv:2308.11596]

The mel-spectrogram + conv feature extractor is stubbed per the assignment
carve-out: ``input_specs`` supplies precomputed frame embeddings
``[B, seq_len, d_model]`` consumed by the 12-layer encoder; the 12-layer text
decoder (seq_len // 4 targets) cross-attends to the encoder output.
``long_500k`` is skipped for this arch (quadratic enc/cross attention with no
published sub-quadratic variant) — see DESIGN.md §Arch-applicability.
Copy of ``repro.configs.seamless_m4t_medium``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope="none",  # learned positions, conformer-style encoder simplified
    act="gelu",
    norm="layernorm",
    encoder_layers=12,
    is_encoder_decoder=True,
    decoder_fraction=4,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, encoder_layers=2)
