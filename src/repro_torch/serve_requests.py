"""Batched serving example: continuous batching over KV-cache slots (the
twin of the reference's ``examples/serve_requests.py``).

Draws a reduced model of ``--arch`` (stablelm-1.6b's smoke config by
default; ``--arch hymba-1.5b`` serves the hybrid stack, its SSM state
beside ring caches on the windowed layers), submits a mixed bag of
requests (prompt lengths and generation budgets from a seeded numpy
stream, as the reference's) and serves them through the engine's chunked
prefill and greedy decode.

    PYTHONPATH=src python -m repro_torch.serve_requests [--arch hymba-1.5b]
    PYTHONPATH=src python -m repro_torch.serve_requests --device cpu --arch hymba-1.5b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import disable_tf32, resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import tree_map


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda unless you ask for cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()

    mcfg = get_smoke_config(args.arch)
    params = M.init_params(mcfg, generator=torch.Generator().manual_seed(0), device=device)
    eng = ServingEngine(mcfg, tree_map(lambda x: x[None], params), slots=args.slots,
                        max_len=128)
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.randint(0, mcfg.vocab_size, size=rng.randint(3, 20)).tolist()
        r = Request(uid=i, prompt=prompt, max_new_tokens=int(rng.randint(4, 12)))
        reqs.append(r)
        eng.add_request(r)

    t0 = time.time()
    eng.run()
    dt = time.time() - t0
    for r in reqs:
        print(f"  req {r.uid:2d}: prompt len {len(r.prompt):2d} -> "
              f"{len(r.generated)} tokens "
              f"(ttft {r.ttft * 1e3:6.1f} ms, score {r.score:+.3f}): "
              f"{r.generated}")
    n = sum(len(r.generated) for r in reqs)
    print(f"\nserved {len(reqs)} requests / {n} tokens in {dt:.2f}s "
          f"({n / dt:.1f} tok/s on {device.type}, arch={mcfg.name})")
    return reqs


if __name__ == "__main__":
    main()
