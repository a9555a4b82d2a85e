"""Two of chip_smoke.py's ResNet50 checks alone on the card: ResNet50 on
the batched and the sharded executor under deterministic cuDNN, the
overlapped launcher path, one overlapped pair bitwise the same
two windows in sequence and one profiled, then blocked Shampoo with its
step against the plain versions and its refresh time.  No CPU twins run
beside them, as they do in chip_smoke.py.

    python3 scripts/resnet50_pair_and_shampoo.py
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as CS  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("resnet50_pair_and_shampoo: torch.cuda is not available", file=sys.stderr)
        return 1
    from repro_torch import disable_tf32
    from repro_torch.kernels import _build
    print("device:", CS.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    disable_tf32()
    t0 = time.perf_counter()
    _build.build(verbose=False)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda:0")
    runs, counts = {}, {}
    runs["resnet50"], counts["resnet50"] = CS.run_main_path("main path resnet50", CS.RN_ARGS,
                                                            CS.RN_LEAVES)
    out = CS.run_resnet50_determinism(runs, counts)
    print(json.dumps({"overlap": out["overlap"]}, default=str)[:4000], flush=True)
    CS.stamp("overlap done")
    label, args, per_leaf = next(p for p in CS.RN_PATHS if p[0] == "resnet50_shampoo")
    runs[label], counts[label] = CS.run_main_path(f"main path {label}", CS.RN_ARGS + args,
                                                  CS.RN_LEAVES, per_leaf)
    sh = CS.check_shampoo_step(label, runs[label].pop("state"), dev)
    print(json.dumps({"shampoo": sh, "peak": runs[label]["peak_bytes"]}), flush=True)
    CS.stamp("shampoo done")
    print("resnet50_pair_and_shampoo: ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
