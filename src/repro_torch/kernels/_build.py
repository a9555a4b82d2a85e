"""Build and load the CUDA kernels: nvcc → shared library → ctypes.

The sources ``csrc/coda_kernels.cu`` (auc_loss, prox_update, opt_update),
``csrc/flash_attention.cu`` (K4) and ``csrc/moe_dispatch.cu`` (K5) have a
plain C interface, so nvcc compiles them in seconds (no PyTorch headers,
no ninja).  One nvcc builds all three into
``<repo>/build/repro_torch_kernels/libcoda_<hash>.so``, keyed on a hash of
the sources and the flags, at first use: importing this module builds
nothing.  There is no fallback — a failed build raises.
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "coda_kernels.cu"
ATTN_SOURCE = SOURCE.with_name("flash_attention.cu")
MOE_SOURCE = SOURCE.with_name("moe_dispatch.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    "coda_auc_loss": (ctypes.c_int, [_P, _P, _P, _P, _P, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]),
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
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, _P]),
    "flash_attention_smem_bytes": (ctypes.c_int, [ctypes.c_int]),
    "grouped_matmul": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, _P]),
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
    """The CUDA sources of the one library (read at call time)."""
    return (SOURCE, ATTN_SOURCE, MOE_SOURCE)


def library_path() -> Path:
    text = b"".join(src.read_bytes() for src in sources())
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcoda_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the library if it is not built yet; return its path.  The
    output is written under a temporary name and renamed, so concurrent
    builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose and (proc.stdout or proc.stderr):
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
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
