"""Build and load the CUDA kernels: nvcc → shared library → ctypes.

The sources ``csrc/coda_kernels.cu`` (auc_loss, prox_update, opt_update),
``csrc/flash_attention.cu`` (K4) and ``csrc/moe_dispatch.cu`` (K5) have a
plain C interface, so nvcc compiles them in seconds (no PyTorch headers,
no ninja); the last two include ``csrc/hopper.cuh`` (mbarriers, TMA, wgmma
and the tensor-map encoder).  One nvcc per source, all started together,
compiles them to objects, and one more links the objects into
``<repo>/build/repro_torch_kernels/libcoda_<hash>.so``, keyed on a hash of
every file under ``csrc/`` (headers included) and the flags, at first use:
importing this module builds nothing.  There is no fallback — a failed
build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "coda_kernels.cu"
ATTN_SOURCE = CSRC / "flash_attention.cu"
MOE_SOURCE = CSRC / "moe_dispatch.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-I", str(CSRC))

_P = ctypes.c_void_p
_SIGNATURES = {
    "coda_auc_loss": (ctypes.c_int, [_P, _P, _P, _P, _P, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P]),
    "coda_auc_rows_per_block": (ctypes.c_int, []),
    "coda_prox_update_f32": (ctypes.c_int, [_P, _P, _P, _P, ctypes.c_longlong,
                                            ctypes.c_float, ctypes.c_float, _P]),
    "coda_prox_update_bf16": (ctypes.c_int, [_P, _P, _P, _P, ctypes.c_longlong,
                                             ctypes.c_float, ctypes.c_float, _P]),
    "coda_opt_update": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                                       ctypes.c_float, ctypes.c_float,
                                       ctypes.c_float, _P, _P]),
    "coda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    "flash_attention_forward": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, _P]),
    "flash_attention_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
    "flash_attention_wgmma_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
    "flash_attention_tf32x3_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
    "grouped_matmul": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P]),
    "grouped_matmul_geometry": (None, [_P]),
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return str(path)


def sources() -> tuple[Path, ...]:
    """The CUDA sources nvcc compiles into the one library (read at call
    time)."""
    return (SOURCE, ATTN_SOURCE, MOE_SOURCE)


def hashed_files() -> tuple[Path, ...]:
    """Every file the build reads: the sources and every file under
    ``CSRC`` (the headers they include), each once, in a fixed order."""
    under = (p for p in CSRC.rglob("*") if p.is_file())
    return tuple(sorted(set(sources()) | set(under)))


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in hashed_files():
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcoda_{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise if any fails; their output, joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build(verbose: bool = False) -> Path:
    """Compile the library if it is not built yet; return its path.  Each
    source is compiled by its own nvcc, all at once, then linked; the
    output is written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        text = _run([[nvcc(), *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)]
                     for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, out.name)
        text += _run([[nvcc(), "-shared", "-o", lib, *objs]])
        if verbose and text:
            print(text, end="")
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argtypes and
    restype declared (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().coda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
