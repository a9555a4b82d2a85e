"""Continuous-batching serving engine for trained AUC/pAUC scorers
(counterpart of ``repro.serving.engine``, with its behaviour and counters).

The engine multiplexes a fixed number of KV-cache slots over a stream of
requests:

  * **Admission** — a bounded FIFO (or shortest-job-first) queue; empty
    prompts and non-positive budgets are rejected at the door, prompts past
    ``max_len - 1`` are truncated (recorded on the request) or rejected;
    arrival, admission, first-token and completion times are stamped;
    optional per-request deadlines expire queued and active requests.
  * **Batched chunked prefill** — every tick is one call of
    ``decode.masked_chunk_step``: slots mid-prefill feed up to
    ``prefill_chunk`` prompt tokens, slots in decode their last token.  A
    tick where nobody prefills runs one step (C = 1), so the engine has two
    step shapes, C ∈ {1, prefill_chunk}.
  * **Prefix cache** — optionally (``prefix_cache_size > 0``) an LRU of the
    slot's cache after each chunk boundary and each whole prompt; a request
    whose prompt extends a cached prefix starts after it (capped at len-1,
    so its first token's logits still come from prefill).
  * **Slot recycling** — ``_reset_slot`` writes a fresh (or prefix-cached)
    state into a slot along dim 0 of every cache leaf, and raises on a leaf
    that does not carry the slot axis there.

Decoding is greedy; ``Request.score`` is the AUC head's logit at the last
prompt token.  A failure while consuming one slot's output finalizes that
request (``status="failed"``) and the trace goes on; ``run()`` raises
``TicksExhausted`` with the partial records of what is still in flight.

The device work is the port's own: one replica's parameters (K = 1) on the
card or the CPU; ``impl`` reaches the kernels (K5 in every moe layer of
every step).  Host state (positions, pending tokens, outputs) is numpy, and
each tick reads its tokens and scores back once, as the reference does.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving import decode as D
from repro_torch.tree import tree_map


class TicksExhausted(RuntimeError):
    """``run()`` ran out of ticks with requests still queued or active;
    ``records`` holds the partial state of everything in flight."""

    def __init__(self, message: str, records: list[dict] | None = None):
        super().__init__(message)
        self.records = records or []


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1
    deadline: float | None = None     # seconds after arrival; None = none
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "new"          # new|queued|active|done|rejected|expired|failed
    reject_reason: str = ""
    failure_reason: str = ""
    truncated: bool = False
    prompt_used: list[int] = dataclasses.field(default_factory=list)
    prefix_hit_tokens: int = 0
    score: float | None = None        # AUC-head logit at the last prompt token
    label: float | None = None        # ground truth of a labeled trace
    t_arrival: float | None = None
    t_admitted: float | None = None
    t_first_token: float | None = None
    t_complete: float | None = None

    @property
    def ttft(self) -> float | None:
        if self.t_first_token is None or self.t_arrival is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def latency(self) -> float | None:
        if self.t_complete is None or self.t_arrival is None:
            return None
        return self.t_complete - self.t_arrival


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 256, use_window: bool = True,
                 impl: str = "auto", prefill_chunk: int = 8,
                 queue_limit: int | None = None, admission: str = "fifo",
                 on_overflow: str = "truncate", prefix_cache_size: int = 0,
                 metric=None,
                 clock: Callable[[], float] = time.monotonic):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder configs need encode_for_decode; the engine "
                "serves token-prompt architectures")
        if admission not in ("fifo", "sjf"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if on_overflow not in ("truncate", "reject"):
            raise ValueError(f"unknown overflow policy {on_overflow!r}")
        if prefill_chunk < 1 or slots < 1 or max_len < 2:
            raise ValueError((prefill_chunk, slots, max_len))
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["table"].device
        self.slots = slots
        self.max_len = max_len
        self.use_window = use_window
        self.impl = impl
        self.prefill_chunk = prefill_chunk
        self.queue_limit = queue_limit
        self.admission = admission
        self.on_overflow = on_overflow
        self.prefix_cache_size = prefix_cache_size
        self._clock = clock
        self.cache = D.init_cache(cfg, slots, max_len, use_window=use_window,
                                  dtype=torch.float32, device=self.device)
        self._fresh = D.init_cache(cfg, 1, max_len, use_window=use_window,
                                   dtype=torch.float32, device=self.device)
        self.queue: deque[Request] = deque()
        self.active: list[Request | None] = [None] * slots
        self.pos = np.zeros(slots, np.int32)            # next position per slot
        self.pending = [deque() for _ in range(slots)]  # unconsumed prompt toks
        self._prefix: OrderedDict = OrderedDict()       # prompt tuple -> slice
        # counters
        self.ticks = 0
        self.steps = 0        # serve steps run: the sum over ticks of C_live
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.n_completed = 0
        self.n_rejected = 0
        self.n_expired = 0
        self.n_failed = 0
        # streaming metric over served traffic (repro_torch.metrics.streaming):
        # every finalized request with a score and a label is folded in
        self.metric = metric
        self.metric_state = metric.init() if metric is not None else None
        self.n_scored = 0

    # -- admission ----------------------------------------------------------
    def add_request(self, req: Request) -> bool:
        """Validate and enqueue.  Returns False (request finalized with
        ``status="rejected"``) on empty prompts, non-positive budgets, a full
        queue, or — under ``on_overflow="reject"`` — prompts that do not
        fit the cache."""
        if req.t_arrival is None:
            req.t_arrival = self._clock()
        if not req.prompt:
            return self._reject(req, "empty_prompt")
        if req.max_new_tokens < 1:
            return self._reject(req, "non_positive_max_new_tokens")
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            return self._reject(req, "queue_full")
        limit = self.max_len - 1   # leave >=1 position for decode feedback
        if len(req.prompt) > limit:
            if self.on_overflow == "reject":
                return self._reject(req, "prompt_too_long")
            req.truncated = True
            req.prompt_used = list(req.prompt[:limit])
        else:
            req.prompt_used = list(req.prompt)
        req.status = "queued"
        self.queue.append(req)
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.status = "rejected"
        req.reject_reason = reason
        req.done = True
        req.t_complete = self._clock()
        self.n_rejected += 1
        return False

    def _expire(self, now: float) -> None:
        keep = deque()
        for req in self.queue:
            if req.deadline is not None and now - req.t_arrival > req.deadline:
                self._finish(req, None, now, status="expired")
            else:
                keep.append(req)
        self.queue = keep
        for s, req in enumerate(self.active):
            if (req is not None and req.deadline is not None
                    and now - req.t_arrival > req.deadline):
                self._finish(req, s, now, status="expired")

    def _pop_next(self) -> Request:
        if self.admission == "sjf":
            best = min(range(len(self.queue)),
                       key=lambda i: len(self.queue[i].prompt_used))
            self.queue.rotate(-best)
            req = self.queue.popleft()
            self.queue.rotate(best)
            return req
        return self.queue.popleft()

    def _admit(self, now: float) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self._pop_next()
                req.status = "active"
                req.t_admitted = now
                source, hit = self._prefix_lookup(req)
                self.cache = self._reset_slot(s, source)
                self.active[s] = req
                self.pos[s] = hit
                self.pending[s] = deque(req.prompt_used[hit:])

    # -- slot recycling -----------------------------------------------------
    def _reset_slot(self, s: int, source=None):
        """A new cache tree with ``source`` (default: the fresh zero state)
        written into slot ``s``.  Every leaf must carry the slot axis at dim
        0; a leaf that does not raises.  Leaves restored to the host (numpy
        arrays) are reset too, and come back as tensors on the engine's
        device."""
        src = self._fresh if source is None else source

        def put(old, new):
            old = torch.as_tensor(old, device=self.device)
            if (old.dim() < 1 or old.shape[0] != self.slots
                    or old.shape[1:] != new.shape[1:]):
                raise ValueError(
                    f"cache leaf {tuple(old.shape)} does not carry the slot axis "
                    f"at dim 0 (want [{self.slots}, ...] matching {tuple(new.shape)})")
            out = old.clone()
            out[s:s + 1] = new.to(old.dtype)
            return out

        return tree_map(put, self.cache, src)

    # -- prefix cache -------------------------------------------------------
    def _prefix_lookup(self, req: Request):
        """The longest cached prompt that is a strict prefix of this
        request's prompt, capped at len-1.  Returns (cache slice | None,
        tokens covered)."""
        if not self.prefix_cache_size:
            return None, 0
        pu = req.prompt_used
        best = None
        for key in self._prefix:
            if (len(key) <= len(pu) - 1
                    and (best is None or len(key) > len(best))
                    and list(key) == pu[:len(key)]):
                best = key
        if best is None:
            self.prefix_misses += 1
            return None, 0
        self._prefix.move_to_end(best)
        self.prefix_hits += 1
        req.prefix_hit_tokens = len(best)
        return self._prefix[best], len(best)

    def _prefix_store(self, s: int, req: Request, upto: int) -> None:
        """Snapshot slot ``s`` (a copy) as the state after
        ``prompt_used[:upto]``."""
        key = tuple(req.prompt_used[:upto])
        self._prefix[key] = tree_map(lambda a: a[s:s + 1].clone(), self.cache)
        self._prefix.move_to_end(key)
        while len(self._prefix) > self.prefix_cache_size:
            self._prefix.popitem(last=False)

    # -- the tick -----------------------------------------------------------
    def _chunk_step(self, toks, pos0, nst):
        with torch.no_grad():
            cache, out_toks, out_scores = D.masked_chunk_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pos0).to(self.device),
                torch.from_numpy(nst).to(self.device),
                use_window=self.use_window, impl=self.impl)
        return cache, out_toks.cpu().numpy(), out_scores.cpu().numpy()

    def step(self) -> int:
        """One tick: expire deadlines, admit, and feed every active slot
        through one ``masked_chunk_step``.  Returns the number of requests
        still in flight (active + queued)."""
        now = self._clock()
        self._expire(now)
        self._admit(now)
        C = self.prefill_chunk
        toks = np.zeros((self.slots, C), np.int64)
        pos0 = np.zeros((self.slots,), np.int32)
        nst = np.zeros((self.slots,), np.int32)
        prefilling = [False] * self.slots
        for s, req in enumerate(self.active):
            if req is None:
                continue
            pos0[s] = self.pos[s]
            if self.pending[s]:
                k = min(C, len(self.pending[s]))
                for t in range(k):
                    toks[s, t] = self.pending[s].popleft()
                nst[s] = k
                prefilling[s] = True
            else:
                toks[s, 0] = req.generated[-1]
                nst[s] = 1
        if not nst.any():
            return len(self.queue)
        self.ticks += 1
        C_live = C if any(prefilling) else 1
        self.steps += C_live
        self.cache, out_toks, out_scores = self._chunk_step(
            np.ascontiguousarray(toks[:, :C_live]), pos0, nst)
        t_out = self._clock()
        for s, req in enumerate(self.active):
            if req is None or nst[s] == 0:
                continue
            k = int(nst[s])
            self.pos[s] += k
            try:
                if prefilling[s]:
                    self.tokens_prefilled += k
                    if self.prefix_cache_size:
                        self._prefix_store(s, req, int(self.pos[s]))
                    if not self.pending[s]:  # prompt consumed: first token out
                        req.score = float(out_scores[s, k - 1])
                        self._emit(s, req, int(out_toks[s, k - 1]), t_out)
                else:
                    self.tokens_decoded += 1
                    self._emit(s, req, int(out_toks[s, 0]), t_out)
            except Exception as e:
                reason = f"{type(e).__name__}: {e}"
                if req.done:    # finalized before the failure: keep the outcome
                    req.failure_reason = reason
                    if self.active[s] is req:
                        self.active[s] = None
                else:
                    self._finish(req, s, self._clock(), status="failed",
                                 reason=reason)
        return sum(r is not None for r in self.active) + len(self.queue)

    def _emit(self, s: int, req: Request, tok: int, now: float) -> None:
        req.generated.append(tok)
        if req.t_first_token is None:
            req.t_first_token = now
        if (len(req.generated) >= req.max_new_tokens or tok == req.eos_id
                or self.pos[s] >= self.max_len - 1):
            self._finish(req, s, now, status="done")

    def _finish(self, req: Request, s: int | None, now: float, *,
                status: str, reason: str = "") -> None:
        req.status = status
        req.done = True
        req.t_complete = now
        if reason:
            req.failure_reason = reason
        if status == "done":
            self.n_completed += 1
        elif status == "failed":
            self.n_failed += 1
        else:
            self.n_expired += 1
        if s is not None and self.active[s] is req:
            self.active[s] = None
        if (self.metric is not None and req.score is not None
                and req.label is not None):
            # a broken metric fold must not un-serve the request
            try:
                self.metric_state = self.metric.update(
                    self.metric_state, np.asarray([req.score], np.float32),
                    np.asarray([req.label], np.float32))
                self.n_scored += 1
            except Exception as e:
                req.failure_reason = f"metric: {type(e).__name__}: {e}"

    def streaming_metrics(self) -> dict | None:
        """Finalized value, resolution bound and state bytes of the attached
        streaming metric (None without one)."""
        if self.metric is None:
            return None
        return {"metric": self.metric.name,
                "backend": self.metric.backend,
                "value": self.metric.finalize(self.metric_state),
                "resolution": self.metric.resolution(self.metric_state),
                "scored": self.n_scored,
                "state_bytes": self.metric.state_bytes(self.metric_state)}

    def _partial_record(self, req: Request) -> dict:
        return {"uid": req.uid, "status": req.status,
                "generated": list(req.generated),
                "prompt_consumed": len(req.prompt_used) - (
                    len(self.pending[self.active.index(req)])
                    if req in self.active else len(req.prompt_used)),
                "score": req.score,
                "t_arrival": req.t_arrival, "t_admitted": req.t_admitted,
                "t_first_token": req.t_first_token}

    def run(self, max_ticks: int = 10_000) -> None:
        """Drive ``step`` until every request is finalized; raise
        ``TicksExhausted`` (with the partial records) if ticks run out."""
        for _ in range(max_ticks):
            if self.step() == 0:
                return
        in_flight = [r for r in self.active if r is not None] + list(self.queue)
        if in_flight:
            raise TicksExhausted(
                f"{max_ticks} ticks exhausted with "
                f"{sum(r is not None for r in self.active)} active and "
                f"{len(self.queue)} queued requests",
                records=[self._partial_record(r) for r in in_flight])
