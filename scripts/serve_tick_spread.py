"""How far a host-bound engine's decode tick spreads within one process:
chip_smoke.py's serving phase (its engine, trace and weights) repeated on
phi3-medium-14b's full-width bf16 weights (40 layers), on the card.

    PYTHONPATH=src python3 scripts/serve_tick_spread.py [--json OUT]

Each repeat runs chip_smoke's trace through a fresh engine (the median ms
of its prefill and decode ticks, tokens/s) and then one decode tick under
the profiler (wall, device busy, idle share), as ``run_engine_serve``
does.  Two more repeats run with Python's cyclic collector off, to see
whether its passes over a large heap reach the tick.  The host's load
average is printed beside each repeat: the card's host is shared, and a
host-bound tick follows its cores.  Prints nvidia-smi's name and power
limit first and a JSON summary last.
"""
import argparse
import gc
import json
import os
import statistics
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as CS  # noqa: E402

ARCH, REPEATS = "phi3-medium-14b", 5


def one_repeat(cfg, params) -> dict:
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import loadgen as LG
    ticks = []
    with torch.no_grad():
        eng, reqs, wall = CS._serve(cfg, params, "auto", ticks)
        peng = ServingEngine(cfg, params, **CS.SERVE_KW)
        for i in range(4):
            peng.add_request(Request(uid=i, prompt=[7 + i] * 8, max_new_tokens=4))
        peng.step()
        torch.cuda.synchronize()
        wall_t, busy_t, _ = CS.device_profile(peng.step)
    pre = [ms for c, ms in ticks if c == CS.SERVE_KW["prefill_chunk"]]
    dec = [ms for c, ms in ticks if c == 1]
    return {"ms_per_prefill_tick": statistics.median(pre),
            "ms_per_decode_tick": statistics.median(dec),
            "decode_tick_min_ms": min(dec), "decode_tick_max_ms": max(dec),
            "decode_ticks": len(dec),
            "tokens_per_s": LG.summarize(reqs, wall, eng)["tokens_per_s"],
            "profiled_tick_wall_ms": wall_t, "profiled_tick_busy_ms": busy_t,
            "idle_share": 1.0 - busy_t / wall_t, "loadavg_1m": os.getloadavg()[0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    print(CS.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=CS.BF16, device=dev)
    params = tree_map(lambda x: x[None], params)
    torch.cuda.synchronize()
    print(f"{ARCH}: bf16 weights on the card in {time.perf_counter() - t0:.2f} s; "
          f"engine {CS.SERVE_KW}; trace {CS.SERVE_TRACE}; {os.cpu_count()} host cores",
          flush=True)
    with torch.no_grad():
        CS._serve(cfg, params, "auto")                     # warm-up
    runs = []
    for r in range(REPEATS + 2):
        collect = r < REPEATS
        if not collect:
            gc.collect()
            gc.disable()
        try:
            rec = one_repeat(cfg, params) | {"gc": collect}
        finally:
            gc.enable()
        runs.append(rec)
        print(f"repeat {r} (gc {'on' if collect else 'off'}): "
              f"{rec['ms_per_decode_tick']:.2f} ms per decode tick (median of "
              f"{rec['decode_ticks']}, {rec['decode_tick_min_ms']:.2f}-"
              f"{rec['decode_tick_max_ms']:.2f}), {rec['ms_per_prefill_tick']:.2f} ms per "
              f"prefill tick, {rec['tokens_per_s']:.1f} tokens/s; profiled tick wall "
              f"{rec['profiled_tick_wall_ms']:.2f} ms, busy {rec['profiled_tick_busy_ms']:.2f} "
              f"ms (idle {rec['idle_share']:.3f}); load average {rec['loadavg_1m']:.2f}",
              flush=True)
    on = [x["ms_per_decode_tick"] for x in runs if x["gc"]]
    out = {"arch": ARCH, "card": CS.nvidia_smi(), "runs": runs,
           "decode_tick_median_ms": statistics.median(on),
           "decode_tick_spread_ms": [min(on), max(on)],
           "idle_share_median": statistics.median(x["idle_share"] for x in runs if x["gc"])}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return out


if __name__ == "__main__":
    main()
