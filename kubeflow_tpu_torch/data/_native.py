"""Build the repository's native C++ sources (`native/*.cpp`) into the
port's own build directory and load them with `ctypes`.

The sources are the ones the reference's data path uses (the token-shard
loader and the BPE word encoder, each with a plain C interface). The
reference runs `make` inside `native/`; the port never writes there.
Each library is compiled with the Makefile's flags straight into
`build/native/` at the repository root (listed in `.gitignore`), under a
file name that carries a hash of its source and flags, so an edited
source is rebuilt and an unchanged one reused. The compiler writes a
file of its own process's name, which `os.replace` then moves into
place: two processes building at once never load a half-written library.

Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, g++, c++, clang++) on this "
                       "machine: the native library cannot be built")


def lib_path(source: str) -> Path:
    """Where the library of `native/<source>.cpp` lives once built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((NATIVE_SRC / f"{source}.cpp").read_bytes())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """The library of `native/<source>.cpp`, compiled if missing. Raises
    with the compiler's output when it cannot be built."""
    src = NATIVE_SRC / f"{source}.cpp"
    if not src.exists():
        raise RuntimeError(f"{src} is missing: the native library cannot "
                           "be built")
    out = lib_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out
