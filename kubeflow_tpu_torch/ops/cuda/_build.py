"""Build the CUDA sources under `kubeflow_tpu_torch/csrc/` with `nvcc`
and load them with `ctypes`.

Each `<name>.cu` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), compiled
for `sm_90a` into `build/kernels/` at the repository root (listed in
`.gitignore`). A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and an unchanged one is reused.
`build_all()` starts one `nvcc` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_decode_attention", "paged_prefill_append",
           "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each fresh build
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> float:
    """Build every missing library among `names` in parallel; returns
    the wall seconds spent. Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        ptxas_reports[name] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, argtypes) -> ctypes.CDLL:
    """The library of kernel source `name`, built if missing, with the
    C entry point `kft_<name>` declared (`argtypes`, int return)."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.kft_error_string.argtypes = [ctypes.c_int]
        lib.kft_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, f"kft_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.kft_error_string(err).decode()})")
