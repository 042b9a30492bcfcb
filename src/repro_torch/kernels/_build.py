"""Build the port's CUDA kernels with ``nvcc`` at first use, and load them.

Each kernel source (``<package>/csrc/<name>.cu``) becomes a shared library
with a plain C interface, loaded with ``ctypes``.  The library's file name
carries a hash of its source and of the compiler flags, so an edit rebuilds
it and an unchanged checkout reuses it.  Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  Nothing is built when a module is imported: the CPU tests
import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"

#: name -> source; every kernel the port builds.
SOURCES: Dict[str, Path] = {
    "flash_fwd": _PKG / "flash_attention" / "csrc" / "flash_fwd.cu",
    "flash_bwd": _PKG / "flash_attention" / "csrc" / "flash_bwd.cu",
    "wan_quant": _PKG / "wan_quant" / "csrc" / "wan_quant.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, Tuple[float, str]]:
    """Compile the named kernels (default: all) that are not built yet.

    All ``nvcc`` processes start together and run in parallel.  Returns,
    per kernel compiled now, the seconds it took and ``ptxas``'s report
    (registers, shared memory, spills).  Raises with nvcc's output if a
    build fails.
    """
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failures.append(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        report[name] = (time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise with CUDA's error string if a launch returned an error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
