"""Byte-level BPE tokenizer: train, encode, decode, persist (a copy of
kubeflow_tpu/data/bpe.py, same ids and the same JSON format; the port
imports nothing of the JAX package).

Byte-level base alphabet (every UTF-8 string tokenizes: no OOV, no
unicode normalization questions), greedy rank-ordered merges learned
from a corpus, JSON persistence.

Design notes:
- Training is the classic pair-counting loop over a word frequency
  table (split on whitespace boundaries like GPT-2's regex, simplified:
  leading-space word convention keeps word boundaries reversible), with
  counts updated incrementally only for words containing the merged
  pair — O(unique words) per merge, not O(corpus).
- Encoding applies merges by rank (lowest first), the standard greedy
  BPE; a merge-rank dict makes each word O(pieces^2) worst case with
  tiny constants, and an LRU memo makes hot words O(1). Each word
  goes through the native encoder (`native/bpe.cpp` over ctypes, the
  same ids) when its library builds, else through the Python loop.
  The library is built at first use into the port's build directory,
  keyed by a hash of its source (`data/_native.py`): an edited source is
  rebuilt, never shadowed by a stale library. `warm_native()` builds it
  ahead of the first encode (a server calls it when it loads the
  tokenizer, so no request waits on the compiler).
- IDs: 0..255 are the raw bytes, then one id per merge, then specials
  appended at the end (pad/bos/eos by default) — so a trained tokenizer
  of V merges has vocab 256 + V + len(specials), matching how serving's
  EngineConfig.eos_token expects a real id.

serving/server.py's byte_encode remains the zero-training fallback and
uses the same bytes-first convention.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import logging
import subprocess
from collections import Counter
from typing import Iterable, Sequence

DEFAULT_SPECIALS = ("<pad>", "<bos>", "<eos>")


def _to_word_bytes(word: str) -> tuple[int, ...]:
    return tuple(word.encode("utf-8"))


# Longest word the greedy encoder will process whole. Space-free runs
# (CJK prose, URLs, base64 blobs) otherwise become ONE word, making
# encode O(bytes^2) in the run length and stuffing unbounded-size
# entries into the LRU — the server's text mode exposes that to
# clients. Chunking preserves exact decode (concatenation) and costs
# only the merges that would have crossed a chunk boundary.
_MAX_WORD_CHARS = 128


def _split_words(text: str) -> list[str]:
    """Leading-space word convention: "a b" -> ["a", " b"] — boundaries
    survive tokenization, so decode is exact concatenation. Words longer
    than _MAX_WORD_CHARS are chunked (see note above)."""
    out: list[str] = []

    def push(word: str) -> None:
        for i in range(0, len(word), _MAX_WORD_CHARS):
            out.append(word[i:i + _MAX_WORD_CHARS])

    start = 0
    for i in range(1, len(text)):
        if text[i] == " " and text[i - 1] != " ":
            push(text[start:i])
            start = i
    if text:
        push(text[start:])
    return out


@dataclasses.dataclass(frozen=True)
class Tokenizer:
    """Immutable trained tokenizer. Build with `train` or `load`."""

    merges: tuple[tuple[int, int], ...]   # (left_id, right_id) by rank
    specials: tuple[str, ...] = DEFAULT_SPECIALS

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.specials)

    def special_id(self, token: str) -> int:
        return 256 + len(self.merges) + self.specials.index(token)

    @property
    def eos_id(self) -> int:
        return self.special_id("<eos>")

    @property
    def bos_id(self) -> int:
        return self.special_id("<bos>")

    @property
    def pad_id(self) -> int:
        return self.special_id("<pad>")

    @functools.cached_property
    def _ranks(self) -> dict[tuple[int, int], int]:
        return {pair: i for i, pair in enumerate(self.merges)}

    @functools.cached_property
    def _decode_table(self) -> dict[int, bytes]:
        table = {i: bytes([i]) for i in range(256)}
        for rank, (a, b) in enumerate(self.merges):
            table[256 + rank] = table[a] + table[b]
        return table

    def _encode_word(self, word: tuple[int, ...]) -> tuple[int, ...]:
        return _encode_word_cached(self._ranks_id, word)

    @functools.cached_property
    def _ranks_id(self):
        # A hashable capsule for the lru-cached module function: the
        # tokenizer is immutable, so identity keying is sound.
        return _RanksHandle(self._ranks, self.merges)

    def warm_native(self) -> bool:
        """Build and load the native encoder now rather than at the first
        encode. True when encode will take it."""
        return self._ranks_id.native is not None

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if bos else []
        for word in _split_words(text):
            ids.extend(self._encode_word(_to_word_bytes(word)))
        if eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        table = self._decode_table
        n_text = 256 + len(self.merges)
        data = b"".join(table[i] for i in ids if 0 <= i < n_text)
        return data.decode("utf-8", errors="replace")

    # -- persistence -------------------------------------------------------

    def dumps(self) -> str:
        return json.dumps({
            "version": 1,
            "merges": [list(m) for m in self.merges],
            "specials": list(self.specials),
        })

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def loads(cls, data: str) -> "Tokenizer":
        obj = json.loads(data)
        if obj.get("version") != 1:
            raise ValueError(f"unknown tokenizer version {obj.get('version')}")
        return cls(
            merges=tuple((int(a), int(b)) for a, b in obj["merges"]),
            specials=tuple(obj["specials"]),
        )

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        with open(path) as f:
            return cls.loads(f.read())


class _RanksHandle:
    """Hashable capsule keying the word cache (identity-keyed: the
    tokenizer is immutable). Carries the rank table AND, built lazily,
    the native encoder, so the cached function can take the C++ path
    without changing cache identity."""

    __slots__ = ("ranks", "merges", "_native")

    _NATIVE_UNSET = object()

    def __init__(self, ranks, merges=()):
        self.ranks = ranks
        self.merges = merges
        self._native = self._NATIVE_UNSET

    @property
    def native(self):
        if self._native is self._NATIVE_UNSET:
            self._native = _native_encoder(self.merges)
        return self._native

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


_bpe_lib = None
_bpe_build_error = ""
log = logging.getLogger(__name__)


def native_error() -> str:
    """Why the native encoder is unavailable ("" unless a build failed)."""
    return _bpe_build_error


def _load_bpe_lib():
    """The ctypes library of native/bpe.cpp, or None when it cannot be
    built (the Python loop stays)."""
    global _bpe_lib, _bpe_build_error
    if _bpe_lib is not None or _bpe_build_error:
        return _bpe_lib
    from kubeflow_tpu_torch.data import _native

    try:
        lib = ctypes.CDLL(str(_native.build("bpe")))
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        _bpe_build_error = str(e)
        log.warning("native BPE encoder unavailable: %s", e)
        return None
    lib.kt_bpe_new.restype = ctypes.c_void_p
    lib.kt_bpe_new.argtypes = [ctypes.POINTER(ctypes.c_int32),
                               ctypes.c_int64]
    lib.kt_bpe_encode_word.restype = ctypes.c_int64
    lib.kt_bpe_encode_word.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    # without explicit argtypes ctypes passes the handle as a C int: a
    # 64-bit pointer truncated to 32 bits crashes in free()
    lib.kt_bpe_free.restype = None
    lib.kt_bpe_free.argtypes = [ctypes.c_void_p]
    _bpe_lib = lib
    return lib


class _Native:
    """One native encoder (a `kt_bpe_new` handle) over a merge table."""

    def __init__(self, lib, merges):
        self.lib = lib
        flat = (ctypes.c_int32 * (2 * len(merges)))(
            *(x for pair in merges for x in pair))
        self.handle = lib.kt_bpe_new(flat, len(merges))

    def encode(self, word: tuple[int, ...]) -> tuple[int, ...]:
        n = len(word)
        buf_in = (ctypes.c_uint8 * n)(*word)
        buf_out = (ctypes.c_int32 * n)()
        count = self.lib.kt_bpe_encode_word(self.handle, buf_in, n, buf_out)
        return tuple(buf_out[:count])

    def __del__(self):
        try:
            self.lib.kt_bpe_free(self.handle)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _native_encoder(merges):
    """A native encoder over `merges`, or None (the Python loop stays)."""
    if not merges:
        return None
    lib = _load_bpe_lib()
    return None if lib is None else _Native(lib, merges)


@functools.lru_cache(maxsize=65536)
def _encode_word_cached(handle: _RanksHandle,
                        word: tuple[int, ...]) -> tuple[int, ...]:
    # returns a tuple: the cache hands the SAME object to every caller
    enc = handle.native
    if enc is not None and word:
        return enc.encode(word)
    return _encode_word_py(handle.ranks, word)


def _encode_word_py(ranks, word: tuple[int, ...]) -> tuple[int, ...]:
    """The greedy rank-ordered merge loop in Python."""
    pieces = list(word)
    while len(pieces) > 1:
        best_rank, best_i = None, -1
        for i in range(len(pieces) - 1):
            r = ranks.get((pieces[i], pieces[i + 1]))
            if r is not None and (best_rank is None or r < best_rank):
                best_rank, best_i = r, i
        if best_rank is None:
            break
        pieces[best_i:best_i + 2] = [256 + best_rank]
    return tuple(pieces)


def train(corpus: Iterable[str], *, vocab_size: int,
          specials: Sequence[str] = DEFAULT_SPECIALS) -> Tokenizer:
    """Learn merges until vocab_size = 256 + merges + specials (or the
    corpus runs out of repeated pairs)."""
    n_merges = vocab_size - 256 - len(specials)
    if n_merges < 0:
        raise ValueError(
            f"vocab_size {vocab_size} smaller than bytes+specials "
            f"({256 + len(specials)})")

    # word -> frequency, each word a tuple of current piece ids
    words: Counter[tuple[int, ...]] = Counter()
    for text in corpus:
        for w in _split_words(text):
            words[_to_word_bytes(w)] += 1

    pair_counts: Counter[tuple[int, int]] = Counter()
    for w, c in words.items():
        for pair in zip(w, w[1:]):
            pair_counts[pair] += c

    merges: list[tuple[int, int]] = []
    for _ in range(n_merges):
        if not pair_counts:
            break
        # deterministic: max count, ties by pair id order
        best = max(pair_counts.items(), key=lambda kv: (kv[1], (-kv[0][0], -kv[0][1])))
        pair, count = best
        if count < 2:
            break  # merging singletons only bloats the vocab
        new_id = 256 + len(merges)
        merges.append(pair)
        # Rewrite only the words containing the pair; update pair counts
        # incrementally (remove the word's old pairs, add its new ones).
        for w in [w for w in words if _contains_pair(w, pair)]:
            c = words.pop(w)
            for p in zip(w, w[1:]):
                pair_counts[p] -= c
                if pair_counts[p] <= 0:
                    del pair_counts[p]
            new_w = _merge_word(w, pair, new_id)
            words[new_w] += c
            for p in zip(new_w, new_w[1:]):
                pair_counts[p] += c
    return Tokenizer(merges=tuple(merges), specials=tuple(specials))


def _contains_pair(w: tuple[int, ...], pair: tuple[int, int]) -> bool:
    a, b = pair
    return any(w[i] == a and w[i + 1] == b for i in range(len(w) - 1))


def _merge_word(w: tuple[int, ...], pair: tuple[int, int],
                new_id: int) -> tuple[int, ...]:
    out: list[int] = []
    i = 0
    while i < len(w):
        if i + 1 < len(w) and (w[i], w[i + 1]) == pair:
            out.append(new_id)
            i += 2
        else:
            out.append(w[i])
            i += 1
    return tuple(out)
