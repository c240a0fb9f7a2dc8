"""The port's data tools (`python -m kubeflow_tpu_torch.tools.
prepare_data` / `.eval_ppl`) against the repository's tools/ on the CPU:
the same tokenizer file, shard bytes and JSON summary keys from
prepare_data; eval_ppl with `--random` and with `--checkpoint` (a port
checkpoint of a trained llama-tiny); and over the same shards with the
reference's weights carried over by `bridge.from_jax` the port's NLL is
the reference tool's within 1e-5 (fp32 llama-tiny, the reference's
printed loss is rounded to 6 decimals).

The reference tools run in-process with their loaders and encoder held
to their Python paths, which give the same batches and ids: their
native builds write into native/."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.data import loader as dl
from kubeflow_tpu_torch.tools import eval_ppl, prepare_data

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool(name):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT / "tools"))


@pytest.fixture
def reference_python_paths(monkeypatch):
    from kubeflow_tpu.data import loader as jdl

    monkeypatch.setenv("KFTPU_BPE_FORCE_PY", "1")
    monkeypatch.setattr(jdl, "native_available", lambda: False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    for name in ("PAPER.md", "BASELINE.md", "ADVICE.md"):
        (d / name).write_text((ROOT / name).read_text())
    return d


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_prepare_data_matches_reference(corpus, tmp_path, capsys,
                                        reference_python_paths):
    args = ["--vocab-size", "320", "--shard-tokens", "1500"]
    assert prepare_data.main(["--input", str(corpus / "*.md"), "--out",
                              str(tmp_path / "port"), *args]) == 0
    got = _last_json(capsys)
    assert _reference_tool("prepare_data").main(
        ["--input", str(corpus / "*.md"), "--out", str(tmp_path / "ref"),
         *args]) == 0
    want = _last_json(capsys)
    assert set(got) == set(want)
    for key in ("files", "tokens", "shards", "vocab_size"):
        assert got[key] == want[key], key
    assert got["shards"] >= 2
    port, ref = tmp_path / "port", tmp_path / "ref"
    assert (port / "tokenizer.json").read_text() == \
        (ref / "tokenizer.json").read_text()
    for i in range(got["shards"]):
        name = f"shard-{i:05d}.ktsh"
        assert (port / name).read_bytes() == (ref / name).read_bytes()
    # reusing the tokenizer: the same ids
    assert prepare_data.main(["--input", str(corpus / "PAPER.md"), "--out",
                              str(tmp_path / "val"), "--tokenizer",
                              str(port / "tokenizer.json")]) == 0
    assert _last_json(capsys)["tokenizer"] == str(port / "tokenizer.json")
    assert prepare_data.main(["--input", str(corpus / "*.txt"), "--out",
                              str(tmp_path / "none")]) == 1


@pytest.fixture(scope="module")
def shards(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("shards")
    summary = prepare_data.prepare(sorted(map(str, corpus.glob("*.md"))),
                                   str(out), vocab_size=300,
                                   shard_tokens=2000)
    return summary["shard_paths"]


def test_eval_ppl_random_matches_reference_keys_and_nll(
        shards, capsys, reference_python_paths):
    import jax

    from kubeflow_tpu.models import llama as jllama
    from kubeflow_tpu_torch.models import llama

    flags = ["--shards", *shards, "--model", "llama-tiny", "--random",
             "--cpu", "--batch", "4", "--seq", "64", "--max-batches", "3"]
    assert _reference_tool("eval_ppl").main(flags) == 0
    want = _last_json(capsys)
    assert eval_ppl.main(flags) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    assert got["backend"] == "cpu"
    assert (got["tokens"], got["batches"]) == (want["tokens"],
                                               want["batches"]) == (768, 3)
    # random init draws other values than the reference's: plumbing only
    assert abs(got["loss"] - np.log(llama.LLAMA_TINY.vocab_size)) < 1.0

    # the reference tool's --random weights, carried over
    ref = jax.tree.map(np.asarray, jllama.init(jax.random.key(0),
                                               jllama.LLAMA_TINY))
    params = bridge.from_jax(ref, llama.LLAMA_TINY, "cpu")
    out = eval_ppl.evaluate(eval_ppl.model_apply("llama", llama.LLAMA_TINY),
                            params, shards, batch=4, seq=64, max_batches=3,
                            device="cpu")
    assert out["tokens"] == want["tokens"]
    assert out["loader"] == ("TokenShardLoader" if dl.native_available()
                             else "PyTokenLoader")
    np.testing.assert_allclose(out["loss"], want["loss"], atol=1e-5)
    np.testing.assert_allclose(out["ppl"], want["ppl"], rtol=2e-5)


def test_eval_ppl_checkpoint(shards, tmp_path, capsys):
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.obs.metrics import Registry
    from kubeflow_tpu_torch.train import TrainConfig, Trainer
    from kubeflow_tpu_torch.train.checkpoint import (
        CheckpointConfig,
        Checkpointer,
    )

    cfg = llama.LLAMA_TINY
    trainer = Trainer(
        apply_fn=lambda p, t: llama.apply(p, cfg, t),
        init_fn=lambda seed: llama.init(cfg, seed, "cpu", train=True),
        train_config=TrainConfig(learning_rate=3e-3, warmup_steps=1,
                                 total_steps=20),
        device="cpu", registry=Registry())
    state = trainer.init(0)
    apply = eval_ppl.model_apply("llama", cfg)
    kw = dict(batch=4, seq=64, device="cpu")
    before = eval_ppl.evaluate(apply, state.params, shards, **kw)
    with dl.open_loader(shards, batch=4, seq=64, seed=1) as ld:
        for _ in range(6):
            arr = ld.next_batch_on("cpu")
            state, _ = trainer.step(state, arr[:, :-1], arr[:, 1:])
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "ck"),
                                         save_interval_steps=1,
                                         enable_async=False),
                        trainer, registry=Registry())
    assert ckpt.save(state)
    ckpt.wait()
    ckpt.close()
    assert eval_ppl.main(["--shards", *shards, "--model", "llama-tiny",
                          "--checkpoint", str(tmp_path / "ck"), "--cpu",
                          "--batch", "4", "--seq", "64"]) == 0
    got = _last_json(capsys)
    assert got["source"] == str(tmp_path / "ck")
    after = eval_ppl.evaluate(apply, state.params, shards, **kw)
    # one full epoch; the served (bf16-stored) weights of the checkpoint
    # evaluate within bf16 rounding of the fp32 masters
    assert got["batches"] == after["batches"] == before["batches"]
    assert abs(got["loss"] - after["loss"]) < 0.02
    assert after["loss"] < before["loss"] - 0.2
    with pytest.raises(SystemExit):
        eval_ppl.main(["--shards", *shards])    # no weight source
    with pytest.raises(SystemExit):
        eval_ppl.main(["--shards", *shards, "--model", "llama-tiny",
                       "--checkpoint", str(tmp_path / "empty"), "--cpu"])


def test_tools_run_as_modules():
    import subprocess

    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    for name in ("prepare_data", "eval_ppl"):
        proc = subprocess.run(
            [sys.executable, "-m", f"kubeflow_tpu_torch.tools.{name}",
             "--help"], capture_output=True, text=True, env=env,
            timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert f"kubeflow_tpu_torch.tools.{name}" in proc.stdout
