"""The port's native BPE word encoder (native/bpe.cpp over ctypes, built
into the port's build directory) against its pure-Python loop and the
reference's Python loop: identical ids on every word, duplicate merges
and words past the 128-character chunking included.

The reference's ids come from its Python loop (a rank handle with no
merges never builds the reference's native library, which lands in
native/)."""

from pathlib import Path

import pytest

from kubeflow_tpu.data import bpe as jbpe
from kubeflow_tpu_torch.data import _native
from kubeflow_tpu_torch.data import bpe

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["the quick brown fox", "jugs jugs jugs", "Ünïcödé — 測試 🙂",
         "x" * 300, "", " leading and  double", "abcdef" * 80,
         "the port's native encoder, the reference's ids"]

needs_native = pytest.mark.skipif(
    bpe._load_bpe_lib() is None, reason="no C++ compiler on this machine")


def _python_ids(tok, text):
    return [x for word in bpe._split_words(text)
            for x in bpe._encode_word_py(tok._ranks, bpe._to_word_bytes(word))]


def _native_ids(tok, text):
    enc = tok._ranks_id.native
    return [x for word in bpe._split_words(text)
            for x in enc.encode(bpe._to_word_bytes(word))]


def _reference_ids(jtok, text):
    handle = jbpe._RanksHandle(jtok._ranks)
    ids = []
    for word in jbpe._split_words(text):
        ids.extend(jbpe._encode_word_cached.__wrapped__(
            handle, jbpe._to_word_bytes(word)))
    return ids


@pytest.fixture(scope="module")
def pair():
    corpus = ["the quick brown fox jumps over the lazy dog " * 30,
              "pack my box with five dozen liquor jugs " * 30,
              (ROOT / "PAPER.md").read_text()]
    return bpe.train(corpus, vocab_size=600), jbpe.train(corpus,
                                                         vocab_size=600)


@needs_native
@pytest.mark.parametrize("text", TEXTS)
def test_native_ids_equal_python_and_reference(pair, text):
    tok, jtok = pair
    assert tok.merges == jtok.merges
    assert tok.warm_native()
    native = _native_ids(tok, text)
    assert native == _python_ids(tok, text)
    assert native == _reference_ids(jtok, text)
    assert tok.encode(text) == native    # encode takes the native encoder
    assert tok.decode(native) == text


@needs_native
def test_native_word_encoder_directly(pair):
    tok, _ = pair
    enc = bpe._native_encoder(tok.merges)
    for text in TEXTS:
        for word in bpe._split_words(text):
            w = bpe._to_word_bytes(word)
            assert enc.encode(w) == bpe._encode_word_py(tok._ranks, w)


@needs_native
def test_native_matches_python_on_duplicate_merges():
    """A JSON tokenizer carrying duplicate merge pairs encodes the same
    on both paths (the last rank wins, as in the Python dict)."""
    tok = bpe.Tokenizer(merges=((97, 98), (97, 98), (256, 99)))
    jtok = jbpe.Tokenizer(merges=tok.merges)
    text = "abcabc abab"
    assert _native_ids(tok, text) == _python_ids(tok, text) \
        == _reference_ids(jtok, text) == tok.encode(text)


@needs_native
def test_long_words_and_repo_text(pair):
    tok, jtok = pair
    text = (ROOT / "README.md").read_text()[:20000] + " " + "y" * 1000
    assert _native_ids(tok, text) == _reference_ids(jtok, text)
    assert tok.encode(text) == _python_ids(tok, text)


@needs_native
def test_free_takes_the_full_handle(pair):
    """kt_bpe_free's argtypes are explicit: without them ctypes passes a
    C int and truncates a 64-bit handle."""
    import ctypes
    import gc

    lib = bpe._load_bpe_lib()
    assert lib.kt_bpe_free.argtypes == [ctypes.c_void_p]
    assert lib.kt_bpe_new.restype is ctypes.c_void_p
    for _ in range(3):  # each encoder is freed by its finalizer
        enc = bpe._native_encoder(pair[0].merges)
        assert enc.encode((97, 98)) == bpe._encode_word_py(
            pair[0]._ranks, (97, 98))
        del enc
    gc.collect()


def test_library_keyed_by_source(tmp_path, monkeypatch):
    path = _native.lib_path("bpe")
    assert path.parent == _native.BUILD_DIR
    assert _native.NATIVE_SRC not in path.parents
    src = tmp_path / "native"
    src.mkdir()
    text = (_native.NATIVE_SRC / "bpe.cpp").read_text()
    (src / "bpe.cpp").write_text(text + "\n// edited\n")
    monkeypatch.setattr(_native, "NATIVE_SRC", src)
    assert _native.lib_path("bpe").name != path.name


def test_without_the_library_the_python_loop_stays(pair, monkeypatch):
    tok, jtok = pair
    monkeypatch.setattr(bpe, "_bpe_lib", None)
    monkeypatch.setattr(bpe, "_bpe_build_error", "no C++ compiler")
    fresh = bpe.Tokenizer(merges=tok.merges)
    text = "the quick brown fox"
    assert fresh.encode(text) == _reference_ids(jtok, text)
    assert bpe.native_error() == "no C++ compiler"
    assert not bpe.Tokenizer(merges=tok.merges).warm_native()
