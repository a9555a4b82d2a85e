"""Serving: KV-cache decode (``decode``), the continuous-batching engine
(``engine``) and synthetic load traces (``loadgen``) — counterpart of
``repro.serving``, for the dense and moe families on one replica."""
from repro_torch.serving.engine import Request, ServingEngine, TicksExhausted

__all__ = ["Request", "ServingEngine", "TicksExhausted"]
