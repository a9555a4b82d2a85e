"""Whether NCCL takes two ranks on one card.

    python3 scripts/nccl_two_ranks_one_card.py

Starts two ranks of an NCCL process group that both drive ``cuda:0``
(``repro_torch.launch.mesh.run_ranks``, 60 s timeouts) and runs one
all_reduce; prints the card and NCCL's answer, and exits 0 either way.
The distributed executor runs one rank a card, so this is no path of
it: it records what a second rank on the same card meets.
"""
import os
import subprocess
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def one_all_reduce(rank: int) -> str:
    x = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return f"rank {rank} on cuda:{torch.cuda.current_device()}: all_reduce gave {x.tolist()}"


def main() -> int:
    from repro_torch.launch import mesh
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi} | torch {torch.__version__} | nccl {torch.cuda.nccl.version()} | "
          f"count {torch.cuda.device_count()}")
    try:
        print("two ranks on one card:", mesh.run_ranks(one_all_reduce, 2, backend="nccl",
                                                      timeout_s=60))
    except Exception as e:                      # the answer is what we record
        print(f"two ranks on one card: {type(e).__name__}: {str(e)[:2000]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
