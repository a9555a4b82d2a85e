"""Synthetic request traces and latency reporting for the serving engine
(counterpart of ``repro.serving.loadgen``).

  * ``TraceConfig``/``make_trace`` — seed-deterministic traces: ``batch``
    (all at t=0), ``poisson`` (exponential inter-arrivals at ``rate``) and
    ``bursty`` (``burst_size`` arrivals per burst), with an optional pool
    of shared prompt prefixes; ``labeled=True`` plants Bernoulli(p_pos)
    labels and draws the prompts from the ported ``tokens`` data kind
    (positives carry motif tokens), so the engine's streaming AUC has a
    real signal to recover.
  * ``run_trace`` — paces a trace against the wall clock through an engine.
  * ``summarize`` — p50/p99 time to first token and latency, tokens/s and
    the engine's counters.
  * ``serve_load_report`` — one smoke config served on one trace after a
    warm-up engine: the ``serve_load`` record.

Every draw except the labeled prompts' tokens comes from the reference's
``np.random.RandomState(seed)`` stream in the reference's order, so an
unlabeled trace equals the reference's request for request; the labeled
prompts come from ``data.synthetic._draw`` on a numpy generator, since the
reference draws them with ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic
from repro_torch.metrics import streaming
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.tree import tree_map


@dataclasses.dataclass
class TraceConfig:
    kind: str = "poisson"              # poisson | bursty | batch
    rate: float = 16.0                 # mean arrivals/s (poisson, bursty)
    n_requests: int = 32
    prompt_len: tuple[int, int] = (8, 33)   # rng.randint [lo, hi)
    max_new: tuple[int, int] = (4, 9)
    burst_size: int = 8
    prefix_pool: int = 0               # >0: share prompts' first prefix_len toks
    prefix_len: int = 12
    eos_id: int = -1
    deadline: float | None = None
    seed: int = 0
    labeled: bool = False              # plant ground-truth labels (takes
                                       # precedence over prefix_pool)
    p_pos: float = 0.7                 # positive ratio for labeled traces
    label_signal: float = 1.5          # motif strength (DataConfig.signal)

    def __post_init__(self):
        if self.kind not in ("poisson", "bursty", "batch"):
            raise ValueError(f"unknown trace kind {self.kind!r}")
        if self.labeled and not 0.0 < self.p_pos < 1.0:
            raise ValueError(f"p_pos must be in (0, 1), got {self.p_pos}")


def make_trace(tcfg: TraceConfig, vocab_size: int) -> list[tuple[float, Request]]:
    """[(arrival_s, Request)] sorted by arrival; fully seed-deterministic."""
    rng = np.random.RandomState(tcfg.seed)
    n = tcfg.n_requests
    if tcfg.kind == "batch":
        arrivals = np.zeros(n)
    elif tcfg.kind == "poisson":
        arrivals = np.cumsum(rng.exponential(1.0 / tcfg.rate, size=n))
    else:  # bursty: burst_size simultaneous arrivals, bursts at rate req/s
        arrivals = (np.arange(n) // tcfg.burst_size) * (tcfg.burst_size / tcfg.rate)
    pool = [rng.randint(0, vocab_size, size=tcfg.prefix_len).tolist()
            for _ in range(tcfg.prefix_pool)]
    labels = toks = None
    if tcfg.labeled:
        labels = (rng.uniform(size=n) < tcfg.p_pos).astype(np.float32)
        dcfg = synthetic.DataConfig(
            kind="tokens", vocab_size=vocab_size,
            seq_len=max(1, tcfg.prompt_len[1] - 1),
            signal=tcfg.label_signal, p_pos=tcfg.p_pos)
        toks = synthetic._draw(np.random.default_rng(tcfg.seed), dcfg,
                               labels)["tokens"]
    trace = []
    for i in range(n):
        plen = int(rng.randint(*tcfg.prompt_len))
        if toks is not None:
            prompt = toks[i, :plen].astype(int).tolist()
        elif pool:
            prefix = pool[int(rng.randint(len(pool)))]
            tail = rng.randint(0, vocab_size,
                               size=max(1, plen - len(prefix))).tolist()
            prompt = prefix + tail
        else:
            prompt = rng.randint(0, vocab_size, size=plen).tolist()
        req = Request(uid=i, prompt=prompt,
                      max_new_tokens=int(rng.randint(*tcfg.max_new)),
                      eos_id=tcfg.eos_id, deadline=tcfg.deadline,
                      label=None if labels is None else float(labels[i]))
        trace.append((float(arrivals[i]), req))
    return trace


def run_trace(engine: ServingEngine, trace: list[tuple[float, Request]], *,
              max_ticks: int = 100_000,
              on_step=None) -> tuple[list[Request], float]:
    """Pace ``trace`` against the wall clock through ``engine``.  Returns
    (requests, busy wall seconds); raises if the engine cannot drain the
    trace within ``max_ticks`` ticks.  ``on_step(engine)`` runs after every
    tick."""
    t0 = time.monotonic()
    i, n = 0, len(trace)
    in_flight = 0
    while i < n or in_flight:
        now = time.monotonic() - t0
        while i < n and trace[i][0] <= now:
            engine.add_request(trace[i][1])
            i += 1
        in_flight = engine.step()
        if on_step is not None:
            on_step(engine)
        if in_flight == 0 and i < n:
            time.sleep(min(max(trace[i][0] - (time.monotonic() - t0), 0.0),
                           0.05))
        if engine.ticks > max_ticks:
            raise RuntimeError(
                f"trace not drained after {max_ticks} engine ticks "
                f"({i}/{n} submitted, {in_flight} in flight)")
    return [r for _, r in trace], time.monotonic() - t0


def _pct(vals, q):
    return float(np.percentile(vals, q)) if len(vals) else float("nan")


def summarize(reqs: list[Request], wall: float,
              engine: ServingEngine | None = None) -> dict:
    """Latency percentiles, throughput and the engine's counters."""
    done = [r for r in reqs if r.status == "done"]
    ttft = [r.ttft for r in done if r.ttft is not None]
    lat = [r.latency for r in done if r.latency is not None]
    n_tok = sum(len(r.generated) for r in done)
    rec = {
        "n_requests": len(reqs),
        "completed": len(done),
        "rejected": sum(r.status == "rejected" for r in reqs),
        "expired": sum(r.status == "expired" for r in reqs),
        "failed": sum(r.status == "failed" for r in reqs),
        "truncated": sum(r.truncated for r in reqs),
        "generated_tokens": n_tok,
        "tokens_per_s": n_tok / max(wall, 1e-9),
        "wall_s": wall,
        "ttft_p50_ms": _pct(ttft, 50) * 1e3,
        "ttft_p99_ms": _pct(ttft, 99) * 1e3,
        "latency_p50_ms": _pct(lat, 50) * 1e3,
        "latency_p99_ms": _pct(lat, 99) * 1e3,
    }
    if engine is not None:
        rec.update(ticks=engine.ticks,
                   tokens_prefilled=engine.tokens_prefilled,
                   tokens_decoded=engine.tokens_decoded,
                   prefix_hits=engine.prefix_hits,
                   prefix_misses=engine.prefix_misses)
        sm = engine.streaming_metrics()
        if sm is not None:
            rec["streaming_" + sm["metric"]] = sm["value"]
            rec.update(streaming_metric=sm["metric"],
                       streaming_backend=sm["backend"],
                       streaming_resolution=sm["resolution"],
                       streaming_scored=sm["scored"],
                       streaming_state_bytes=sm["state_bytes"])
    return rec


def serve_load_report(arch: str = "stablelm-1.6b", *, engine_kw: dict | None = None,
                      trace_kw: dict | None = None, seed: int = 0,
                      metric_backend: str = "", device="cuda") -> dict:
    """Serve one trace on ``arch``'s smoke config (``loadgen.py:191-227``)
    and return ``{"arch", "knobs", "trace", "metrics"}``, ``metrics`` being
    ``summarize``'s record.  The weights are the port's own init from
    ``seed`` (not the reference's ``jax.random`` draw); the engine defaults
    to 4 slots, max_len 64, chunk 8.  ``metric_backend`` ("exact" |
    "sketch") attaches a streaming AUC to the engine, whose record then has
    the ``streaming_auc`` row (meaningful on a ``labeled`` trace).  A
    throwaway engine serves one request first, so the timed trace runs on a
    warm host (the kernels built, the allocator filled).  ``device`` is
    ``cuda`` unless the caller asks for the CPU."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    params = tree_map(lambda x: x[None], M.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device=device))
    engine_kw = dict(engine_kw or {})
    engine_kw.setdefault("slots", 4)
    engine_kw.setdefault("max_len", 64)
    engine_kw.setdefault("prefill_chunk", 8)
    tcfg = TraceConfig(**(trace_kw or {}))
    metric = streaming.make_metric("auc", metric_backend) if metric_backend else None
    warm = ServingEngine(cfg, params, **engine_kw)
    warm.add_request(Request(uid=-1, prompt=list(range(1, 12)), max_new_tokens=2))
    warm.run()
    eng = ServingEngine(cfg, params, metric=metric, **engine_kw)
    reqs, wall = run_trace(eng, make_trace(tcfg, cfg.vocab_size))
    return {"arch": arch, "knobs": engine_kw, "trace": dataclasses.asdict(tcfg),
            "metrics": summarize(reqs, wall, eng)}
