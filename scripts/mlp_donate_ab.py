"""The mlp at the launcher's defaults through the batched executor with and
without buffer donation, alternating, on the card with nothing else running
(chip_smoke.py runs its CPU twins beside its mlp paths, whose host-bound
steps then vary by tens of percent).  Prints, per optimizer, the host ms per
local step of 10 measured rounds of three 8-step windows each way.

    python3 scripts/mlp_donate_ab.py
"""
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("mlp_donate_ab: torch.cuda is not available", file=sys.stderr)
        return 1
    from repro_torch import disable_tf32
    from repro_torch.configs import mlp_config
    from repro_torch.core import coda
    disable_tf32()
    print("device:", CS.nvidia_smi(), flush=True)
    dev = torch.device("cuda:0")
    mcfg = mlp_config()
    wb = CS.window_batch(mcfg, dev)
    for opt in ("sgd", "momentum", "sm3", "shampoo_blocked"):
        ccfg = coda.CoDAConfig(n_workers=4, p_pos=0.71, optimizer=opt)
        res = {True: [], False: []}
        states = {d: coda.init_state(mcfg, ccfg, generator=torch.Generator().manual_seed(0),
                                     device=dev) for d in (True, False)}
        exes = {d: coda.make_executor(mcfg, ccfg, donate=d) for d in (True, False)}
        for rep in range(12):                 # the first two rounds warm up
            for d in ((True, False) if rep % 2 else (False, True)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    states[d], lo = exes[d].window_step(states[d], wb, 0.5)
                float(lo.mean())
                torch.cuda.synchronize()
                if rep >= 2:
                    res[d].append((time.perf_counter() - t0) * 1e3 / 24)
        print(f"mlp A/B {opt}: donate ms/step median {statistics.median(res[True]):.3f} "
              f"{[round(x, 3) for x in res[True]]}; no donation "
              f"{statistics.median(res[False]):.3f} {[round(x, 3) for x in res[False]]}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
