"""Serving: KV-cache decode (``decode``), the continuous-batching engine
(``engine``) and synthetic load traces (``loadgen``) — counterpart of
``repro.serving``, for the dense, moe, vlm and hybrid families on one
replica; the audio encoder-decoder serves through ``decode.encode_for_decode``
and ``decode.serve_step``, as in the reference)."""
from repro_torch.serving.engine import Request, ServingEngine, TicksExhausted

__all__ = ["Request", "ServingEngine", "TicksExhausted"]
