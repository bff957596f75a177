"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
`build/<name>-<hash>.so`, compiled for Hopper (sm_90a) at first use.  The
hash covers every file of `csrc/` and the compiler flags, so an edited
source is rebuilt and a stale library is never loaded.  A missing `nvcc`
or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "zikkurat_algebra_tpu_torch cannot be built"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def log_path(name: str) -> Path:
    return lib_path(name).with_suffix(".log")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together.  Returns the seconds each build
    took (0.0 where the library was already there)."""
    names = list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        with open(log_path(n), "w") as out:     # nvcc's output goes to the log
            procs[n] = (subprocess.Popen(cmd, stdout=out,
                                         stderr=subprocess.STDOUT),
                        tmp, time.time())
    while any(not secs[n] for n in todo):
        for n, (proc, _, t0) in procs.items():
            if not secs[n] and proc.poll() is not None:
                secs[n] = time.time() - t0
        time.sleep(0.05)
    failed = []
    for n, (proc, tmp, _) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n"
                          f"{log_path(n).read_text()}")
            continue
        os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def load(name: str, symbol: str, argtypes: Sequence,
         restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of kernel library `name`, built if
    needed.  Every pointer and the stream must be `ctypes.c_void_p` in
    `argtypes`; the function returns `restype`, by default a cudaError_t
    as int."""
    fn = _FNS.get(symbol)
    if fn is None:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[symbol] = fn
    return fn
