"""The port's token-shard loaders against the reference's on the CPU: the
native loader (native/dataloader.cpp, built into the port's build
directory), the port's Python loader and the reference's Python loader
give identical batches, bit for bit, over epoch boundaries, for two
(host, n_hosts) stripings and from a resume ticket; bad shards and stale
libraries are refused; the data story (tokenize -> shard -> load ->
train) runs end to end through the port's Trainer.

The reference's native loader is not run here: it builds into native/
(its own tests hold it equal to its Python loader)."""

import numpy as np
import pytest
import torch

from kubeflow_tpu.data import loader as jdl
from kubeflow_tpu_torch.data import _native
from kubeflow_tpu_torch.data import loader as dl

needs_native = pytest.mark.skipif(not dl.native_available(),
                                  reason="no C++ compiler on this machine")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((1000, 517, 2048)):
        p = str(d / f"shard{i}.ktsh")
        dl.write_shard(p, rng.integers(0, 32000, n).astype(np.int32))
        paths.append(p)
    return paths


def test_write_shard_matches_reference(tmp_path):
    toks = np.random.default_rng(1).integers(0, 1 << 30, 333)
    dl.write_shard(str(tmp_path / "a.ktsh"), toks)
    jdl.write_shard(str(tmp_path / "b.ktsh"), toks)
    assert (tmp_path / "a.ktsh").read_bytes() == \
        (tmp_path / "b.ktsh").read_bytes()


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_lcg_shuffle_matches_reference(seed):
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(dl._lcg_shuffle(97, seed, epoch),
                                      jdl._lcg_shuffle(97, seed, epoch))


STRIPINGS = [(0, 1), (1, 2), (2, 3)]


@needs_native
@pytest.mark.parametrize("host,n_hosts", STRIPINGS)
@pytest.mark.parametrize("start_ticket", [0, 5])
def test_three_loaders_give_one_stream(shards, host, n_hosts, start_ticket):
    kw = dict(batch=2, seq=48, seed=5, host=host, n_hosts=n_hosts,
              start_ticket=start_ticket)
    ref = jdl.PyTokenLoader(shards, **kw)
    py = dl.PyTokenLoader(shards, **kw)
    with dl.TokenShardLoader(shards, prefetch=3, threads=3, **kw) as nat:
        assert nat.n_windows == py.n_windows == ref.n_windows
        # three epochs: the order is reshuffled at each boundary
        for _ in range(3 * ref._batches_per_epoch):
            want = ref.next_batch()
            np.testing.assert_array_equal(py.next_batch(), want)
            np.testing.assert_array_equal(nat.next_batch(), want)
        n = start_ticket + 3 * ref._batches_per_epoch
        assert nat.state_dict() == py.state_dict() == {"ticket": n}


@needs_native
@pytest.mark.parametrize("kind", ["native", "python"])
def test_resume_ticket_continues_the_stream(shards, kind):
    cls = dl.TokenShardLoader if kind == "native" else dl.PyTokenLoader
    with cls(shards, batch=4, seq=32, seed=42) as ld:
        stream = [ld.next_batch() for _ in range(9)]
        ticket = ld.state_dict()["ticket"]
        assert ticket == 9
    with cls(shards, batch=4, seq=32, seed=42, start_ticket=4) as ld:
        for want in stream[4:]:
            np.testing.assert_array_equal(ld.next_batch(), want)
        assert ld.state_dict() == {"ticket": ticket}
    with pytest.raises(ValueError, match="start_ticket"):
        cls(shards, batch=4, seq=32, start_ticket=-1)


def test_invalid_shard_refused(tmp_path):
    p = str(tmp_path / "bad.ktsh")
    with open(p, "wb") as f:
        f.write(b"JUNKJUNKJUNKJUNK")
    with pytest.raises(ValueError):
        dl.PyTokenLoader([p], batch=1, seq=4)
    short = str(tmp_path / "short.ktsh")
    with open(short, "wb") as f:
        f.write(b"KTSH")
    with pytest.raises(ValueError):
        dl.PyTokenLoader([short], batch=1, seq=4)
    if dl.native_available():
        with pytest.raises(ValueError, match="bad magic"):
            dl.TokenShardLoader([p], batch=1, seq=4)


def test_truncated_shard_refused(tmp_path):
    p = str(tmp_path / "cut.ktsh")
    dl.write_shard(p, np.arange(100, dtype=np.int32))
    with open(p, "r+b") as f:
        f.truncate(16 + 4 * 50)
    with pytest.raises(ValueError, match="truncated"):
        dl.PyTokenLoader([p], batch=1, seq=4)
    if dl.native_available():
        with pytest.raises(ValueError):
            dl.TokenShardLoader([p], batch=1, seq=4)


def test_too_small_dataset_refused(tmp_path):
    p = str(tmp_path / "tiny.ktsh")
    dl.write_shard(p, np.arange(10, dtype=np.int32))
    with pytest.raises(ValueError, match="not enough windows"):
        dl.PyTokenLoader([p], batch=4, seq=64)
    if dl.native_available():
        with pytest.raises(ValueError, match="not enough windows"):
            dl.TokenShardLoader([p], batch=4, seq=64)


@pytest.mark.parametrize("args", [dict(host=2, n_hosts=2),
                                  dict(batch=0), dict(seq=0)])
def test_invalid_arguments_refused(shards, args):
    kw = {**dict(batch=2, seq=16), **args}
    with pytest.raises(ValueError, match="invalid arguments"):
        dl.PyTokenLoader(shards, **kw)
    if dl.native_available():
        with pytest.raises(ValueError, match="invalid arguments"):
            dl.TokenShardLoader(shards, **kw)


class _StaleLib:
    """A library that predates the ABI export (or any other)."""

    def __init__(self, abi=None):
        self.abi = abi

    def __getattr__(self, name):
        if name == "kt_abi_version":
            if self.abi is None:
                raise AttributeError(name)
            abi = self.abi
            return type("F", (), {"restype": None,
                                  "__call__": lambda s: abi})()
        raise AssertionError("a stale library must not be configured")


@pytest.mark.parametrize("abi", [None, 1, 3])
def test_stale_abi_refused(monkeypatch, shards, abi):
    monkeypatch.setattr(dl, "_lib", None)
    monkeypatch.setattr(dl, "_build_failed", False)
    monkeypatch.setattr(dl, "_error", "")
    monkeypatch.setattr(dl, "_build", lambda: "stale.so")
    monkeypatch.setattr(dl.ctypes, "CDLL", lambda path: _StaleLib(abi))
    assert dl._load_lib() is None
    assert not dl.native_available()
    assert "ABI" in dl.native_error()
    # open_loader says which loader it gave: the Python one here
    ld = dl.open_loader(shards, batch=2, seq=16)
    assert type(ld) is dl.PyTokenLoader
    with pytest.raises(RuntimeError, match="unavailable"):
        dl.TokenShardLoader(shards, batch=2, seq=16)


def test_failed_build_is_visible(monkeypatch):
    def no_compiler():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(dl, "_lib", None)
    monkeypatch.setattr(dl, "_build_failed", False)
    monkeypatch.setattr(dl, "_error", "")
    monkeypatch.setattr(dl, "_build", no_compiler)
    assert not dl.native_available()
    assert dl.native_error() == "no C++ compiler"


@pytest.mark.parametrize("kind", ["native", "python"])
def test_next_batch_on_is_the_stream_as_a_tensor(shards, kind):
    if kind == "native" and not dl.native_available():
        pytest.skip("no C++ compiler on this machine")
    cls = dl.TokenShardLoader if kind == "native" else dl.PyTokenLoader
    kw = dict(batch=2, seq=48, seed=5)
    with cls(shards, **kw) as a, cls(shards, **kw) as b:
        for _ in range(6):
            got = a.next_batch_on("cpu")
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), b.next_batch())
        assert a.state_dict() == b.state_dict()


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_next_batch_on_card_is_the_stream(shards):
    kw = dict(batch=2, seq=48, seed=5)
    with dl.open_loader(shards, **kw) as a, \
            dl.PyTokenLoader(shards, **kw) as b:
        for _ in range(6):
            got = a.next_batch_on("cuda")
            assert got.device.type == "cuda"
            np.testing.assert_array_equal(got.cpu().numpy(), b.next_batch())


@needs_native
def test_open_loader_is_native(shards):
    with dl.open_loader(shards, batch=2, seq=16, seed=0) as ld:
        assert type(ld) is dl.TokenShardLoader
        assert ld.next_batch().shape == (2, 17)


def test_library_builds_outside_native_dir(tmp_path, monkeypatch):
    """The library lands in the port's build directory under a name
    keyed by its source: an edited source gets a new library."""
    path = _native.lib_path("dataloader")
    assert path.parent == _native.BUILD_DIR
    assert _native.NATIVE_SRC not in path.parents
    src = tmp_path / "native"
    src.mkdir()
    text = (_native.NATIVE_SRC / "dataloader.cpp").read_text()
    (src / "dataloader.cpp").write_text(text)
    monkeypatch.setattr(_native, "NATIVE_SRC", src)
    assert _native.lib_path("dataloader").name == path.name
    (src / "dataloader.cpp").write_text(text + "\n// edited\n")
    assert _native.lib_path("dataloader").name != path.name


def test_data_story_end_to_end(tmp_path):
    """Tokenize a corpus, write a shard, stream batches through
    open_loader and train the tiny Llama with the port's Trainer on the
    CPU: the loss falls."""
    from kubeflow_tpu_torch.data import bpe
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    corpus = ["the quick brown fox jumps over the lazy dog " * 20,
              "tpu chips stream tokens through the loader " * 20]
    tok = bpe.train(corpus, vocab_size=300)
    ids = []
    for text in corpus * 8:
        ids.extend(tok.encode(text, eos=True))
    shard = str(tmp_path / "corpus.ktsh")
    dl.write_shard(shard, np.asarray(ids, np.int32))

    cfg = llama.LLAMA_TINY
    assert tok.vocab_size <= cfg.vocab_size
    trainer = Trainer(
        apply_fn=lambda p, t: llama.apply(p, cfg, t),
        init_fn=lambda seed: llama.init(cfg, seed, "cpu", train=True),
        train_config=TrainConfig(warmup_steps=2, total_steps=40,
                                 learning_rate=3e-3),
        device="cpu")
    state = trainer.init(0)
    losses = []
    with dl.open_loader([shard], batch=8, seq=32, seed=3) as loader:
        for _ in range(12):
            arr = loader.next_batch_on("cpu")  # [b, seq+1]: shift, don't wrap
            state, loss = trainer.step(state, arr[:, :-1], arr[:, 1:])
            losses.append(float(loss))
    assert min(losses[-4:]) < losses[0] * 0.8, losses
