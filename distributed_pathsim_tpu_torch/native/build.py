"""Lazy native build: compile the C++ shared libraries on first use.

Bindings go through a plain C ABI + ``ctypes``; each library is one g++
invocation. The library is written into ``distributed_pathsim_tpu_torch/
_build/`` (listed in ``.gitignore``; the kernels' nvcc builds live there
too), named by a digest of its source, its flags and the compiler and C
library it was built with, so neither an edited source nor a build
carried over from another machine is ever loaded. Several processes may start together (two
router workers on one card): each compiles to a process-unique temp file
and renames it into place atomically, so none ever loads a half-written
library. A missing toolchain or a failed compile returns None and the
callers take their Python paths.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_BUILT: dict[str, pathlib.Path | None] = {}


@functools.lru_cache(maxsize=None)
def _toolchain() -> str:
    """The compiler's version, the machine and its C library: what a
    built library's compatibility depends on beyond its source."""
    try:
        gxx = subprocess.run(
            ["g++", "-dumpfullversion", "-dumpversion"], capture_output=True,
            text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        gxx = "none"
    return f"{gxx} {platform.machine()} {' '.join(platform.libc_ver())}"


def lib_path(name: str) -> pathlib.Path:
    """Where lib<name> lives once built: keyed by a digest of the
    source, the compiler flags and the toolchain."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_toolchain().encode())
    h.update((_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def shared_lib(name: str) -> pathlib.Path | None:
    """The path of lib<name>, building it if needed; None if the
    toolchain is missing or the compile fails (remembered per process)."""
    with _LOCK:
        if name in _BUILT:
            return _BUILT[name]
        result: pathlib.Path | None = None
        src = _DIR / f"{name}.cpp"
        if src.exists():
            out = lib_path(name)
            if out.exists():
                result = out
            else:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                try:
                    BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    subprocess.run(
                        ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                        check=True, capture_output=True, timeout=300,
                    )
                    os.replace(tmp, out)
                    result = out
                except (subprocess.SubprocessError, OSError):
                    tmp.unlink(missing_ok=True)
        _BUILT[name] = result
        return result
