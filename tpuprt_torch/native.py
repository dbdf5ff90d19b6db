"""Build and load the port's native libraries (port of
tpuprt/native/__init__.py, without its fallback).

Each library is compiled at first use from a source file in the checkout
into ``tpuprt_torch/_build/`` (gitignored), keyed by a hash of the source,
the command and the host CPU, and loaded with ctypes. A missing compiler or
a failed compile raises: the port has no pure-Python stand-in for the host
BVH builder, and a CUDA tensor never falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")

# The host builders' flags, the reference's (tpuprt/native/__init__.py:
# 60-64): no FMA contraction, so a tree does not depend on the host's
# vector units.
GXX = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
       "-shared", "-fPIC"]

_loaded: dict = {}


def _cpu_model() -> bytes:
    with open("/proc/cpuinfo", "rb") as f:
        for line in f:
            if line.startswith(b"model name"):
                return line
    return b""


def build_shared(src: str, cmd: list) -> ctypes.CDLL:
    """Compile `src` with `cmd` (the compiler and flags; ``-o <out> <src>``
    are appended) and dlopen the result. Cached per process and on disk."""
    key = (src, tuple(cmd))
    if key in _loaded:
        return _loaded[key]
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(f"{cmd[0]} not found: cannot build {src}")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(cmd).encode())
    h.update(_cpu_model())
    name = os.path.splitext(os.path.basename(src))[0]
    so = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        r = subprocess.run(cmd + ["-o", tmp, src], capture_output=True,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{r.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    _loaded[key] = lib
    return lib
