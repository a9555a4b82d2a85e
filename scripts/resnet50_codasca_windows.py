"""ResNet50 at full width through the training launcher, side by side on
one card: CoDA, CODASCA, the masked CoDA average and masked CODASCA, all
on Dirichlet(0.1) shards, 32 local steps each (4 windows of 8), in turns
(CoDA and masked CODASCA run twice), with launch counts checked as in
``chip_smoke.py`` and each window's ms per local step printed.

    python3 scripts/resnet50_codasca_windows.py

Needs an NVIDIA GPU; builds the kernels first.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import disable_tf32  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

D = ["--dirichlet-alpha", "0.1"]
MASK = ["--participation", "0.75", "--fault-seed", "1"]
RUNS = [("coda", D), ("codasca", ["--algorithm", "codasca"] + D), ("coda_masked", MASK + D),
        ("codasca_masked", ["--algorithm", "codasca"] + MASK + D), ("coda", D),
        ("codasca_masked", ["--algorithm", "codasca"] + MASK + D)]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    disable_tf32()
    _build.build()
    print(cs.nvidia_smi())
    for label, args in RUNS:
        out, _ = cs.run_main_path(f"diag {label}", cs.RN_ARGS + args + ["--t0", "32"],
                                  cs.RN_LEAVES, "prox_update")
        print(f"diag {label}: windows ms/step "
              f"{[round(1e3 * t, 2) for t in out['step_seconds']]}")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
