"""The port's BPE tokenizer (kubeflow_tpu_torch/data/bpe.py) against
the reference's (kubeflow_tpu/data/bpe.py): trained on the same repo
text at the same vocab, the merges, ids, decodes and JSON must be
identical, and each loads the other's saved file."""

from pathlib import Path

import pytest

from kubeflow_tpu.data import bpe as jbpe
from kubeflow_tpu_torch.data import bpe

ROOT = Path(__file__).resolve().parents[1]
CORPUS = [(ROOT / name).read_text() for name in ("README.md", "PAPER.md")]
TEXTS = [
    "",
    "the port serves text",
    "Serve llama3-1b on one H100: --continuous --warmup",
    "naïve — ünïcode ✓ 漢字かな",
    "x" * 300 + " " + "ab" * 90,      # words past the 128-char chunking
    "  leading  and   repeated spaces ",
]


@pytest.fixture(scope="module", params=[300, 512, 1024])
def pair(request):
    vocab = request.param
    return (bpe.train(CORPUS, vocab_size=vocab),
            jbpe.train(CORPUS, vocab_size=vocab))


def test_torch_bpe_trains_the_reference_merges(pair):
    got, want = pair
    assert got.merges == want.merges
    assert got.specials == want.specials
    assert got.vocab_size == want.vocab_size
    assert (got.bos_id, got.eos_id, got.pad_id) == \
        (want.bos_id, want.eos_id, want.pad_id)
    assert got.dumps() == want.dumps()


@pytest.mark.parametrize("text", TEXTS)
def test_torch_bpe_encode_decode_match_reference(pair, text):
    got, want = pair
    for kw in ({}, {"bos": True}, {"bos": True, "eos": True}):
        ids = got.encode(text, **kw)
        assert ids == want.encode(text, **kw)
        assert got.decode(ids) == want.decode(ids)
    assert got.decode(got.encode(text)) == text


def test_torch_bpe_loads_reference_file_and_back(pair, tmp_path):
    got, want = pair
    want.save(str(tmp_path / "ref.json"))
    loaded = bpe.Tokenizer.load(str(tmp_path / "ref.json"))
    assert loaded == got
    got.save(str(tmp_path / "port.json"))
    assert jbpe.Tokenizer.load(str(tmp_path / "port.json")).merges == \
        want.merges
    assert loaded.encode(TEXTS[2]) == want.encode(TEXTS[2])


def test_torch_bpe_refusals_match_reference():
    for mod in (bpe, jbpe):
        with pytest.raises(ValueError, match="smaller than"):
            mod.train(["abc"], vocab_size=200)
        with pytest.raises(ValueError, match="unknown tokenizer version"):
            mod.Tokenizer.loads('{"version": 2, "merges": [], '
                                '"specials": []}')
