"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` beside this file
(the hash covers the source and the flags, so an edited source rebuilds).
``build_all`` starts one ``nvcc`` per missing library, all at once, and waits
for them; a failed build raises with the compiler's output. Nothing here runs
at import: the CPU tests import every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
KERNELS = ("gather_pool", "hamming")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel built by this process (ptxas register/spill report).
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load the named kernel libraries."""
    with _lock:
        missing = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in missing:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
        for name in missing:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build_all((name,))[name]
