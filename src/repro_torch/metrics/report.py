"""Shared metric-reporting plumbing for the launch CLIs (counterpart of
``repro.metrics.report``, with the same lines): the flags ``--metrics
{exact,sketch}``, ``--metric-interval``, ``--metric-bins`` from
``add_metric_args``, and ``metric_line`` / ``worker_skew_line`` for the
report lines:

    [train] window 40: streaming auc=0.9312 ±0.0041 (sketch) n=10240 state=2048B
"""
from __future__ import annotations

from repro_torch.metrics import streaming


def add_metric_args(ap):
    """Install the shared metric flags on an argparse parser."""
    g = ap.add_argument_group("metrics")
    g.add_argument("--metrics", default="exact",
                   choices=["exact", "sketch"],
                   help="evaluation backend: exact materialises scores; "
                        "sketch streams them through a fixed-size "
                        "mergeable histogram (repro_torch.metrics.streaming)")
    g.add_argument("--metric-interval", type=int, default=0,
                   help="report the metric every N windows; 0 = final only")
    g.add_argument("--metric-bins", type=int, default=streaming.DEFAULT_BINS,
                   help="sketch bins (state = 2*bins*4 bytes)")
    return g


# warn when more than this fraction of the scored mass was (or may have
# been) saturated at the sketch range ends — past that, the end bins hold
# unordered mass and the reported AUC resolution no longer bounds the error
CLIP_WARN_FRACTION = 0.01
# edge-bin mass is only meaningful as a clipping proxy when the end bins
# are a small slice of the range; with few bins they legitimately hold a
# large share of any score distribution
_EDGE_MASS_MIN_BINS = 64


def _clip_warning(sk: streaming.ScoreSketch) -> str | None:
    """Saturation warning for a sketch state, or None.

    Host-built sketches carry exact under/overflow counters; device-lifted
    ones (``sketch_from_rows``) don't — the counters never ride the wire —
    so fall back to end-bin mass, the observable upper bound."""
    if sk.clipped > CLIP_WARN_FRACTION:
        return (f"WARN clipped={sk.clipped:.1%} "
                f"(under={int(sk.under)} over={int(sk.over)}) of scores "
                f"saturated outside [{sk.lo:g}, {sk.hi:g}) — widen the "
                f"sketch range")
    if (sk.under == 0 and sk.over == 0 and sk.bins >= _EDGE_MASS_MIN_BINS
            and sk.edge_mass > CLIP_WARN_FRACTION):
        return (f"WARN edge-bin mass={sk.edge_mass:.1%} — scores may be "
                f"clipping at [{sk.lo:g}, {sk.hi:g}); widen the sketch "
                f"range")
    return None


def metric_line(label: str, tick, metric: streaming.Metric, state, *,
                n_seen=None) -> str:
    """One uniform report line for a metric state."""
    val = metric.finalize(state)
    res = metric.resolution(state)
    parts = [f"[{label}] {tick}: streaming {metric.name}={val:.4f}"]
    if res > 0:
        parts.append(f"±{res:.4f}")
    parts.append(f"({metric.backend})")
    if n_seen is not None:
        parts.append(f"n={n_seen}")
    parts.append(f"state={metric.state_bytes(state)}B")
    if isinstance(state, streaming.ScoreSketch):
        warn = _clip_warning(state)
        if warn:
            parts.append(warn)
    return " ".join(parts)


def worker_skew_line(label: str, tick, metric: streaming.Metric,
                     sk_loc, lo: float, hi: float) -> str:
    """Per-worker AUC skew from the local (never-averaged) sketch lanes.

    ``sk_loc`` is the training state's ``[K, bins]`` per-worker subtree
    (``state["sk_loc"]``): lane k holds exactly worker k's own stream, so
    under heterogeneous sharding this line shows how far individual
    workers' local AUC sits from the merged global figure — at zero extra
    wire bytes.  Lanes with no data yet, or a single-class stream (extreme
    label skew can hand a worker only one label; AUC is undefined there,
    not 0), report "-"."""
    sks = streaming.worker_sketches(sk_loc, lo, hi)
    vals = [metric.finalize(sk)
            if float(sk.pos.sum()) > 0 and float(sk.neg.sum()) > 0 else None
            for sk in sks]
    live = [v for v in vals if v is not None]
    cells = " ".join(f"{v:.3f}" if v is not None else "-" for v in vals)
    parts = [f"[{label}] {tick}: worker {metric.name} [{cells}]"]
    if live:
        spread = max(live) - min(live)
        parts.append(f"spread={spread:.4f}")
    return " ".join(parts)

