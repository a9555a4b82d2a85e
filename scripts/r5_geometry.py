"""R5's launch geometry at the paths' shapes, from each kernel's own query.

Builds the kernel library, and for every shape of
``analysis.audit.PATH_SHAPES`` (the paths' shapes of PERF.md §6) prints the
variant the wrapper's ``launch_geometry`` picks, its threads, dynamic
shared memory, grid and TMA boxes as the kernel's launch code reports them
(``coda_kernels_geometry``, ``flash_attention_geometry``,
``grouped_matmul_launch_geometry``), and whether they equal the wrapper's
record.  Exits non-zero if any record differs or breaks a limit.

    python3 scripts/r5_geometry.py          # on the card
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("r5_geometry: the queries need the built library and a card", file=sys.stderr)
        return 1
    from repro_torch.analysis import audit as A
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}")
    bad = 0
    for kernel, shape in A.PATH_SHAPES:
        rec = A.launch_record(kernel, shape)
        rec.query = A.kernel_query(rec)
        problems = A.launch_problems(rec)
        bad += bool(problems)
        q = rec.query
        boxes = q.get("tma_box") or q.get("tma_boxes") or "-"
        dims = {k: (str(v).replace("torch.", "") if isinstance(v, torch.dtype) else v)
                for k, v in shape.items()}
        print(f"{rec.variant:20s} {dims} threads {q['threads']} smem {q['smem_bytes']:,} B "
              f"grid {q['grid']} box {boxes} equal {not problems}"
              + (f" problems {problems}" if problems else ""))
    print(f"records {len(A.PATH_SHAPES)}, with problems {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
