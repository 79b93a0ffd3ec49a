"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of the sources it is built from, so an
edit to a source (or to a header under ``csrc/``) rebuilds it. The build
directory is ``build/repro_torch_kernels`` at the root of the checkout.
Importing this module compiles nothing and needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "build_all", "load", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("matmul", "leaf_inverse", "flash_attention")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# Argument types of each library's C entry points.
_SIGNATURES = {
    "matmul": {
        "repro_gemm": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _F, _F,
                       _I, _I, _P),
        "repro_gemm_pack": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _P),
        "repro_gemm_tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L,
                          _L, _F, _F, _I, _I, _I, _P),
        "repro_gemm_tc_attributes": (_I, _I, _P),
    },
    "leaf_inverse": {
        "repro_gauss_jordan": (_P, _P, _P, _I, _I, _I, _I, _P),
        "repro_gauss_jordan_attributes": (_I, _P),
        "repro_blocked_gauss_jordan": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P),
        "repro_triangular_solve": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L,
                                   _I, _I, _I, _I, _I, _P),
        "repro_blocked_attributes": (_I, _I, _P),
    },
    "flash_attention": {
        "repro_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  *(_L,) * 12, _I, _I, _F, _I, _P),
        "repro_flash_attention_bwd": (*(_P,) * 10, *(_I,) * 6, *(_L,) * 24,
                                      _I, _I, _F, _I, _P),
        "repro_flash_attention_attributes": (_I, _I, _P),
        "repro_flash_attention_bwd_attributes": (_I, _I, _I, _P),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=SOURCES) -> None:
    """Compile every library not built yet, one nvcc each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for name in names:
        out = _library_path(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(_compile_command(name, tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in pending:
        log, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            tmp.replace(out)
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
