"""Token-shard data loading: ctypes bindings over the native loader
(counterpart: kubeflow_tpu/data/loader.py, the same shards, the same
batch stream).

`native/dataloader.cpp` owns the hot path (mmap'd shards, a prefetch
thread pool); this module is its Python face plus a pure-Python loader
(`PyTokenLoader`) that gives the same batches. The shuffle is a shared
deterministic LCG Fisher-Yates, so both produce the SAME batch stream
for the same (paths, batch, seq, seed, host, n_hosts, start_ticket),
and the reference's loaders do too.

Shard format "KTSH": magic u32 | version u32 | n_tokens u64 | int32[].
Multi-host: (host, n_hosts) stripes the shuffled window order, so each
host sees a disjoint window set.

The native library is built at first use into the port's build
directory (`data/_native.py`), never into `native/`. Where it cannot be
built (no compiler) `open_loader` returns the Python loader, as the
reference's does; `native_available()`, `native_error()` and the type
of what `open_loader` returned say which one runs.

`next_batch_on(device)` is the batch as a tensor on the device. On the
card it goes through pinned host memory with a copy that does not block
the host: the stream orders it before the step's kernels, so the host
goes on to queue the step while the card finishes the one before.
"""

from __future__ import annotations

import ctypes
import logging
import struct
import subprocess
from typing import Iterator, Sequence

import numpy as np

from kubeflow_tpu_torch.data import _native

MAGIC = 0x4853544B  # "KTSH"
VERSION = 1
_HEADER = struct.Struct("<IIQ")
_ABI_VERSION = 2  # must match native/dataloader.cpp kt_abi_version()

_lib: ctypes.CDLL | None = None
_build_failed = False
_error = ""

log = logging.getLogger(__name__)


def write_shard(path: str, tokens: np.ndarray) -> None:
    """Write an int32 token array as a KTSH shard."""
    arr = np.ascontiguousarray(tokens, dtype=np.int32)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, arr.size))
        f.write(arr.tobytes())


def _to_device(arr: np.ndarray, device):
    import torch

    t = torch.from_numpy(arr)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    # a pageable copy waits for the stream; a pinned one is queued on it
    return t.pin_memory().to(dev, non_blocking=True)


def _build() -> str:
    return str(_native.build("dataloader"))


def _load_lib() -> ctypes.CDLL | None:
    global _lib, _build_failed, _error
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    try:
        lib = ctypes.CDLL(_build())
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _build_failed, _error = True, str(e)
        log.warning("native loader unavailable: %s", e)
        return None
    # ABI gate: a library whose kt_loader_open takes other arguments would
    # misread seed/host/prefetch instead of failing
    try:
        lib.kt_abi_version.restype = ctypes.c_uint64
        abi = int(lib.kt_abi_version())
    except AttributeError:
        abi = 1  # predates the version export
    if abi != _ABI_VERSION:
        _build_failed = True
        _error = f"libktdata ABI {abi} != expected {_ABI_VERSION}"
        log.warning("%s; using the Python loader", _error)
        return None
    lib.kt_loader_open.restype = ctypes.c_void_p
    lib.kt_loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.kt_loader_next.restype = ctypes.c_int
    lib.kt_loader_next.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.kt_loader_n_windows.restype = ctypes.c_uint64
    lib.kt_loader_n_windows.argtypes = [ctypes.c_void_p]
    lib.kt_loader_close.argtypes = [ctypes.c_void_p]
    lib.kt_loader_close.restype = None
    lib.kt_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def native_error() -> str:
    """Why the native loader is unavailable ("" when it is not known to
    be)."""
    _load_lib()
    return _error


class TokenShardLoader:
    """Native loader handle. Iterate with next_batch() -> [b, seq+1] i32.

    `start_ticket` / `state_dict()` are the checkpoint/resume pair:
    batches are pure functions of a dense ticket, so persisting the
    ticket beside the train state and reopening at it reproduces the
    uninterrupted batch stream."""

    def __init__(self, paths: Sequence[str], *, batch: int, seq: int,
                 seed: int = 0, host: int = 0, n_hosts: int = 1,
                 prefetch: int = 4, threads: int = 2,
                 start_ticket: int = 0):
        self._h = None
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(
                f"native loader unavailable ({_error}); use "
                "PyTokenLoader or open_loader()")
        self._lib = lib
        self.batch, self.seq = batch, seq
        if start_ticket < 0:
            raise ValueError(f"start_ticket must be >= 0, got "
                             f"{start_ticket}")
        self.ticket = start_ticket  # batches consumed since ticket 0
        c_paths = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._h = lib.kt_loader_open(
            c_paths, len(paths), batch, seq, seed, host, n_hosts,
            prefetch, threads, start_ticket)
        if not self._h:
            raise ValueError(
                f"kt_loader_open: {lib.kt_last_error().decode()}")

    @property
    def n_windows(self) -> int:
        return int(self._lib.kt_loader_n_windows(self._h))

    def state_dict(self) -> dict:
        return {"ticket": self.ticket}

    def next_batch(self) -> np.ndarray:
        # a fresh buffer per call: the C side copies straight into it
        out = np.empty((self.batch, self.seq + 1), np.int32)
        rc = self._lib.kt_loader_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError("loader closed")
        self.ticket += 1
        return out

    def next_batch_on(self, device):
        """next_batch() as a tensor on `device` (module docstring)."""
        return _to_device(self.next_batch(), device)

    def close(self) -> None:
        if self._h:
            self._lib.kt_loader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()


# -- the pure-Python loader (the same order) ---------------------------------


def _lcg_shuffle(n: int, seed: int, epoch: int) -> np.ndarray:
    """Fisher-Yates driven by the SAME LCG as the C++ loader."""
    perm = np.arange(n, dtype=np.uint64)
    mask = (1 << 64) - 1
    state = (seed ^ ((epoch * 0x9E3779B97F4A7C15) & mask)) & mask
    for i in range(n, 1, -1):
        state = (state * 6364136223846793005 + 1442695040888963407) & mask
        j = (state >> 33) % i
        perm[i - 1], perm[j] = perm[j], perm[i - 1]
    return perm


class PyTokenLoader:
    """Same semantics as TokenShardLoader, no native dependency."""

    def __init__(self, paths: Sequence[str], *, batch: int, seq: int,
                 seed: int = 0, host: int = 0, n_hosts: int = 1,
                 start_ticket: int = 0, **_ignored):
        if not paths or batch < 1 or seq < 1 or not (0 <= host < n_hosts):
            raise ValueError("invalid arguments")
        if start_ticket < 0:
            raise ValueError(f"start_ticket must be >= 0, got "
                             f"{start_ticket}")
        self.batch, self.seq = batch, seq
        self.seed, self.host, self.n_hosts = seed, host, n_hosts
        self._shards: list[np.ndarray] = []
        self._window_base: list[int] = []
        total = 0
        for p in paths:
            with open(p, "rb") as f:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    raise ValueError(f"bad shard {p}")
                magic, version, n_tokens = _HEADER.unpack(head)
                if magic != MAGIC or version != VERSION:
                    raise ValueError(f"bad shard {p}")
                toks = np.fromfile(f, dtype=np.int32, count=n_tokens)
                if toks.size != n_tokens:
                    raise ValueError(f"truncated shard {p}")
            self._shards.append(toks)
            self._window_base.append(total)
            total += max(0, (n_tokens - 1) // seq)
        self._total_windows = total
        self.n_windows = total // n_hosts
        self._batches_per_epoch = self.n_windows // batch
        if self._batches_per_epoch == 0:
            raise ValueError("not enough windows for one batch")
        self.ticket = start_ticket
        self._cached_epoch = -1
        self._order: np.ndarray | None = None

    def state_dict(self) -> dict:
        return {"ticket": self.ticket}

    def _window(self, global_w: int) -> np.ndarray:
        si = 0
        while (si + 1 < len(self._window_base)
               and self._window_base[si + 1] <= global_w):
            si += 1
        local = global_w - self._window_base[si]
        start = local * self.seq
        return self._shards[si][start:start + self.seq + 1]

    def next_batch(self) -> np.ndarray:
        epoch = self.ticket // self._batches_per_epoch
        b = self.ticket % self._batches_per_epoch
        self.ticket += 1
        if epoch != self._cached_epoch:
            perm = _lcg_shuffle(self._total_windows, self.seed, epoch)
            self._order = perm[self.host::self.n_hosts]
            self._cached_epoch = epoch
        out = np.empty((self.batch, self.seq + 1), np.int32)
        for i in range(self.batch):
            out[i] = self._window(int(self._order[b * self.batch + i]))
        return out

    def next_batch_on(self, device):
        """next_batch() as a tensor on `device` (module docstring)."""
        return _to_device(self.next_batch(), device)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next_batch()


def open_loader(paths: Sequence[str], **kwargs):
    """Native when available, Python otherwise: the same batch stream."""
    if native_available():
        return TokenShardLoader(paths, **kwargs)
    return PyTokenLoader(paths, **kwargs)
