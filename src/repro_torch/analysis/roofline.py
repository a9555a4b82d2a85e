"""Collective bytes and the three roofline terms, counterpart of
``repro.analysis.hlo``'s ``collective_bytes``, ``Hardware`` and
``roofline_terms``.

The reference parses optimized HLO text for its collectives; the port has
no HLO, so ``collective_bytes`` reads ``core/bucketing``'s wire log (every
collective the averaging issued, with its kind, dtype and bytes).  The HLO
parser itself (``collective_ops``, ``permute_chain_components``, the
``verify_*`` entry points) has no counterpart: there is no compiled text to
parse, and the checks it backed are the audit's R1 over the wire log.

``Hardware`` holds the card's own rates: an NVIDIA H100 SXM5 80GB at 700 W
(989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, NVLink 4 at 450 GB/s each
way), the rates PERF.md §6's bounds use.
"""
from __future__ import annotations

import dataclasses

KINDS = ("all_reduce", "all_gather", "p2p", "readout")


def collective_bytes(wire_log) -> dict:
    """Per-kind {bytes, count, by_dtype} and the totals, from
    ``bucketing.wire_log`` entries (kind, dtype tag, bytes[, chain])."""
    out = {k: {"bytes": 0, "count": 0, "by_dtype": {}} for k in KINDS}
    for kind, tag, n, *_ in wire_log:
        rec = out.setdefault(kind, {"bytes": 0, "count": 0, "by_dtype": {}})
        rec["bytes"] += n
        rec["count"] += 1
        rec["by_dtype"][tag] = rec["by_dtype"].get(tag, 0) + n
    kinds = [v for v in out.values() if isinstance(v, dict)]
    out["total_bytes"] = sum(v["bytes"] for v in kinds)
    out["total_count"] = sum(v["count"] for v in kinds)
    return out


@dataclasses.dataclass(frozen=True)
class Hardware:
    """An NVIDIA H100 SXM5 80GB at 700 W."""
    name: str = "NVIDIA H100 SXM5 80GB, 700 W"
    peak_flops: float = 989e12       # dense bf16 FLOP/s
    hbm_bw: float = 3.35e12          # HBM3 bytes/s
    link_bw: float = 450e9           # NVLink 4 bytes/s each way


H100 = Hardware()


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float, n_chips: int = 1,
                   hw: Hardware = H100) -> dict:
    """The three terms in seconds (``hlo.py:346-360``): compute, memory and
    collective, and which of them bounds the step.  Pass per-device figures
    with ``n_chips=1``."""
    terms = {"compute_s": flops / (n_chips * hw.peak_flops),
             "memory_s": hbm_bytes / (n_chips * hw.hbm_bw),
             "collective_s": coll_bytes / (n_chips * hw.link_bw)}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms
