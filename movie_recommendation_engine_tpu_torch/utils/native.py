"""Build the repo's C++ host extensions at first use and load them with ctypes.

Each ``cpp/<name>.cc`` has a plain C interface and compiles on its own with
``g++`` into ``build/lib<name>-<hash>.so`` beside this file, as
``ops/_build.py`` does for the CUDA kernels. The hash covers the source, the
flags and the host's CPU (architecture and instruction-set flags): an edited
source rebuilds, and a library built with ``-march=native`` on one CPU is
never loaded on another that may lack its instructions. Any failure to build or load raises
``BuildError``: the callers then take their plain Python or numpy route.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

CPP = Path(__file__).resolve().parents[2] / "cpp"
BUILD_DIR = Path(__file__).parent / "build"

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """The extension's source, compiler, build or load failed."""


@functools.cache
def _host() -> bytes:
    """The CPU a ``-march=native`` build targets: the architecture and the
    kernel's list of its instruction-set flags, where it has one."""
    isa = ""
    try:
        with open("/proc/cpuinfo") as f:
            isa = next((line for line in f if line.startswith(("flags", "Features"))), "")
    except OSError:
        isa = platform.processor()
    return f"{platform.machine()}|{isa.strip()}".encode()


def _target(name: str, flags: tuple[str, ...]) -> tuple[Path, Path]:
    src = CPP / f"{name}.cc"
    try:
        code = src.read_bytes()
    except OSError as e:
        raise BuildError(f"{name}: no source ({e})") from e
    digest = hashlib.sha256(code + " ".join(flags).encode() + _host()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def library(name: str, flags: tuple[str, ...]) -> ctypes.CDLL:
    """The loaded ``cpp/<name>.cc`` built with ``g++ flags``, built once."""
    with _lock:
        src, out = _target(name, flags)
        lib = _libs.get(str(out))
        if lib is not None:
            return lib
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                                      capture_output=True, text=True)
            except OSError as e:
                raise BuildError(f"{name}: g++ did not run ({e})") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise BuildError(f"{name}: g++ exit {proc.returncode}:\n{proc.stderr}")
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise BuildError(f"{name}: load failed ({e})") from e
        _libs[str(out)] = lib
        return lib
