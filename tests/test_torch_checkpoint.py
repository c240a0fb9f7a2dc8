"""Checkpoint / resume of the port's trainer (kubeflow_tpu_torch/train/
checkpoint.py), on the CPU.

The first three cases mirror tests/test_checkpoint.py's, names prefixed
`torch_`: a TrainState survives the round trip bit for bit and training
continues identically; `restore_or_init` and the save interval; the
data stream's position rides along, so a resumed run reproduces the
uninterrupted one bit for bit (the port has no token-shard loader yet,
so the position is a batch index into a seeded numpy stream). Then the
COMMITTED semantics (uncommitted dirs skipped and cleared, fallback to
an older step), `max_to_keep`, the async commit, the carried tokenizer,
and a checkpoint the JAX reference wrote (orbax) served by the port:
restored by the reference, converted with `bridge.from_jax`, saved by
the port, loaded by the port's serving CLI, whose greedy tokens must
equal the reference app's from its own checkpoint.
"""

import argparse
import asyncio
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu_torch.data import bpe
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs.metrics import Registry
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.train import TrainConfig, Trainer
from kubeflow_tpu_torch.train.checkpoint import (
    COMMIT_MARKER,
    CheckpointConfig,
    Checkpointer,
    flatten,
)

CFG = llama.LLAMA_TINY


@pytest.fixture(scope="module")
def trainer():
    return Trainer(
        apply_fn=lambda p, t: llama.apply(p, CFG, t),
        init_fn=lambda seed: llama.init(CFG, seed, "cpu", train=True),
        train_config=TrainConfig(warmup_steps=1, total_steps=10),
        device="cpu")


def _batch(seed=0, batch=8, seq=16):
    toks = np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (batch, seq))
    t = torch.from_numpy(toks)
    return t, torch.roll(t, -1, dims=1)


def _assert_states_equal(a, b):
    assert int(a.step) == int(b.step)
    pa, pb = flatten(a.params), flatten(b.params)
    assert list(pa) == list(pb)
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    assert a.opt_state["count"] == b.opt_state["count"]
    for key in ("mu", "nu"):
        for x, y in zip(a.opt_state[key], b.opt_state[key], strict=True):
            assert torch.equal(x, y)


def _ckpt(path, trainer, **kw):
    return Checkpointer(CheckpointConfig(str(path), **kw), trainer,
                        registry=Registry())


def test_torch_save_restore_roundtrip(trainer, tmp_path):
    ckpt = Checkpointer(
        CheckpointConfig(str(tmp_path / "ckpt"), save_interval_steps=1,
                         enable_async=False),
        trainer, run_metadata={"model": "llama-tiny"}, registry=Registry())
    state = trainer.init(0)
    toks, tgts = _batch()
    state, _ = trainer.step(state, toks, tgts)
    assert ckpt.save(state)
    ckpt.wait()
    assert ckpt.latest_step() == 1

    restored = ckpt.restore()
    _assert_states_equal(state, restored)
    for leaf in flatten(restored.params).values():
        assert leaf.requires_grad and leaf.device == trainer.device

    # training continues identically from the restored state
    toks2, tgts2 = _batch(1)
    state, loss_a = trainer.step(state, toks2, tgts2)
    restored, loss_b = trainer.step(restored, toks2, tgts2)
    assert float(loss_a) == float(loss_b)
    _assert_states_equal(state, restored)

    meta = ckpt.restore_metadata()
    assert meta["model"] == "llama-tiny"
    assert meta["virtual_replicas"] == ckpt.virtual_replicas == 1
    assert ckpt.save_seconds.count() == 1
    assert ckpt.restore_seconds.count() == 1
    ckpt.close()


def test_torch_restore_or_init_and_interval(trainer, tmp_path):
    ckpt = _ckpt(tmp_path / "c2", trainer, save_interval_steps=2,
                 max_to_keep=2, enable_async=False)
    # empty dir: fresh init
    state = ckpt.restore_or_init(1)
    assert int(state.step) == 0

    toks, tgts = _batch()
    for _ in range(4):
        state, _ = trainer.step(state, toks, tgts)
        ckpt.maybe_save(state)
    ckpt.wait()
    # interval 2: steps 2 and 4 kept, 1 and 3 skipped
    assert ckpt.latest_step() == 4
    assert ckpt.all_steps() == [2, 4]

    # a fresh Checkpointer (a new process) resumes from 4
    ckpt2 = _ckpt(tmp_path / "c2", trainer, enable_async=False)
    resumed = ckpt2.restore_or_init(2)
    assert int(resumed.step) == 4
    _assert_states_equal(state, resumed)
    ckpt.close()
    ckpt2.close()


def test_torch_data_state_resume_reproduces_uninterrupted_run(trainer,
                                                              tmp_path):
    """TrainState and the data stream's position ride one checkpoint,
    and the resumed run's params are bit-identical to a run that never
    stopped."""
    def batch(i):
        toks = np.random.default_rng([5, i]).integers(0, CFG.vocab_size,
                                                      (8, 17))
        t = torch.from_numpy(toks)
        return t[:, :-1], t[:, 1:]

    def steps(state, start, n):
        for i in range(start, start + n):
            state, _ = trainer.step(state, *batch(i))
        return state

    ref = steps(trainer.init(3), 0, 6)

    ckpt = _ckpt(tmp_path / "c3", trainer, save_interval_steps=1,
                 enable_async=False)
    state = steps(trainer.init(3), 0, 3)
    assert ckpt.save(state, force=True, data_state={"batch": 3})
    ckpt.wait()

    # a new process: restore both halves, continue 3 more steps
    ckpt2 = _ckpt(tmp_path / "c3", trainer, enable_async=False)
    resumed = ckpt2.restore_or_init(9)   # seed unused
    ds = ckpt2.restore_data_state()
    assert ds == {"batch": 3}
    resumed = steps(resumed, ds["batch"], 3)
    _assert_states_equal(ref, resumed)

    data_files = list((tmp_path / "c3").glob("*/data_state.json"))
    assert data_files, "expected a data_state item on disk"
    # present but unreadable must raise: restoring {} would restart the
    # data stream from its start with no error
    data_files[0].write_text("{truncated")
    with pytest.raises(ValueError):
        _ckpt(tmp_path / "c3", trainer).restore_data_state()
    # absent (a checkpoint written without one) degrades to {}
    for f in data_files:
        f.unlink()
    assert _ckpt(tmp_path / "c3", trainer).restore_data_state() == {}
    ckpt.close()
    ckpt2.close()


def test_torch_uncommitted_dirs_are_skipped_and_cleared(trainer, tmp_path):
    d = tmp_path / "c4"
    ckpt = _ckpt(d, trainer, save_interval_steps=1, enable_async=False)
    state = trainer.init(0)
    toks, tgts = _batch()
    state, _ = trainer.step(state, toks, tgts)
    ckpt.save(state)
    state, _ = trainer.step(state, toks, tgts)
    ckpt.save(state)
    # a crash between the write and the commit: no marker on step 2
    os.remove(d / "2" / COMMIT_MARKER)
    fresh = _ckpt(d, trainer, enable_async=False)
    assert fresh.committed_steps() == [1]
    assert int(fresh.restore().step) == 1
    assert int(fresh.restore_or_init(5).step) == 1
    with pytest.raises(Exception):
        fresh.restore(step=7)
    # a re-save of the step clears the stale dir and commits
    (d / "2" / "junk").write_text("left by the crash")
    assert fresh.save(state, force=True)
    assert not (d / "2" / "junk").exists()
    assert fresh.committed_steps() == [1, 2]
    # an already-committed step is not written again
    assert not fresh.save(state, force=True)
    # only uncommitted saves: restore refuses, restore_or_init starts over
    only = tmp_path / "c5"
    shutil.copytree(d / "2", only / "3")
    os.remove(only / "3" / COMMIT_MARKER)
    lone = _ckpt(only, trainer)
    with pytest.raises(FileNotFoundError, match="COMMITTED"):
        lone.restore()
    assert int(lone.restore_or_init(0).step) == 0
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _ckpt(tmp_path / "empty", trainer).restore()


def test_torch_restore_falls_back_to_an_older_step(trainer, tmp_path):
    d = tmp_path / "c6"
    ckpt = _ckpt(d, trainer, save_interval_steps=1, enable_async=False)
    state = trainer.init(0)
    toks, tgts = _batch()
    for _ in range(2):
        state, _ = trainer.step(state, toks, tgts)
        ckpt.save(state)
    (d / "2" / "params.pt").write_bytes(b"not a checkpoint")
    assert int(ckpt.restore().step) == 1
    with pytest.raises(Exception):
        ckpt.restore(step=2)


def test_torch_max_to_keep(trainer, tmp_path):
    ckpt = _ckpt(tmp_path / "c7", trainer, save_interval_steps=1,
                 max_to_keep=2, enable_async=False)
    state = trainer.init(0)
    toks, tgts = _batch()
    for _ in range(4):
        state, _ = trainer.step(state, toks, tgts)
        ckpt.save(state)
    assert ckpt.all_steps() == [3, 4]


def test_torch_async_save_commits_on_wait_or_next_save(trainer, tmp_path):
    """The host copy is taken before save returns, so the next step's
    in-place update cannot reach the checkpoint; the write's COMMITTED
    marker appears on wait() or the next save, never before."""
    d = tmp_path / "c8"
    ckpt = _ckpt(d, trainer, save_interval_steps=1, enable_async=True)
    state = trainer.init(0)
    toks, tgts = _batch()
    state, _ = trainer.step(state, toks, tgts)
    snapshot = {n: t.detach().clone()
                for n, t in flatten(state.params).items()}
    assert ckpt.save(state)
    assert not (d / "1" / COMMIT_MARKER).exists()
    state, _ = trainer.step(state, toks, tgts)    # updates in place
    assert ckpt.save(state)                       # commits step 1
    assert (d / "1" / COMMIT_MARKER).exists()
    assert not (d / "2" / COMMIT_MARKER).exists()
    ckpt.wait()
    assert (d / "2" / COMMIT_MARKER).exists()
    first = ckpt.restore(step=1)
    for name, t in flatten(first.params).items():
        assert torch.equal(t.detach(), snapshot[name]), name
    _assert_states_equal(state, ckpt.restore())
    ckpt.close()


def test_torch_tokenizer_carried_to_the_serving_cli(trainer, tmp_path):
    tok = bpe.train(["the port carries its tokenizer " * 4], vocab_size=270)
    tok.save(str(tmp_path / "tok.json"))
    d = tmp_path / "c9"
    ckpt = _ckpt(d, trainer, save_interval_steps=1, enable_async=False,
                 tokenizer_path=str(tmp_path / "tok.json"))
    state = trainer.init(0)
    toks, tgts = _batch()
    state, _ = trainer.step(state, toks, tgts)
    ckpt.save(state)
    assert (d / "tokenizer.json").read_text() == tok.dumps()
    args = cli.parse_args(["--model", "llama-tiny", "--checkpoint", str(d),
                           "--tokenizer", "auto", "--cpu"])
    assert cli.load_tokenizer(args) == tok
    # auto without a carried tokenizer: the byte fallback
    bare = cli.parse_args(["--model", "llama-tiny", "--random",
                           "--tokenizer", "auto", "--cpu"])
    assert cli.load_tokenizer(bare) is None
    with pytest.raises(SystemExit):   # one weight source, not both
        cli.parse_args(["--model", "llama-tiny", "--random",
                        "--checkpoint", str(d)])


def test_torch_reference_checkpoint_served_by_the_port(tmp_path):
    """orbax checkpoint (reference Trainer, one-device mesh) -> the
    reference's restore -> bridge.from_jax -> the port's Checkpointer ->
    the port's CLI loader; the served greedy tokens equal the reference
    app's, served from its own checkpoint through its own loader."""
    from kubeflow_tpu.models import llama as jllama
    from kubeflow_tpu.parallel import MeshSpec, create_mesh
    from kubeflow_tpu.serving import EngineConfig as JEngineConfig
    from kubeflow_tpu.serving import InferenceEngine as JEngine
    from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
    from kubeflow_tpu.serving import server as jserver
    from kubeflow_tpu.serving.__main__ import _load_params
    from kubeflow_tpu.train import trainer as jtrain
    from kubeflow_tpu.train.checkpoint import CheckpointConfig as JConfig
    from kubeflow_tpu.train.checkpoint import Checkpointer as JCheckpointer
    from kubeflow_tpu_torch import bridge

    jcfg = jllama.LLAMA_TINY
    jt = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jllama.apply(p, jcfg, t),
        init_fn=lambda k: jllama.init(k, jcfg),
        logical_axes=jllama.param_logical_axes(jcfg),
        train_config=jtrain.TrainConfig(warmup_steps=1, total_steps=10))
    state = jt.init(jax.random.key(0))
    toks, tgts = _batch()
    state, _ = jt.step(state, jnp.asarray(toks.numpy(), jnp.int32),
                       jnp.asarray(tgts.numpy(), jnp.int32))
    # lm_head x50: greedy argmax cannot flip on fp32 rounding between
    # the frameworks (the reference's own test idiom)
    params = dict(state.params, lm_head=state.params["lm_head"] * 50.0)
    state = jtrain.TrainState(params, state.opt_state, state.step)
    jdir = str(tmp_path / "orbax")
    jck = JCheckpointer(JConfig(jdir, save_interval_steps=1,
                                enable_async=False), jt)
    assert jck.save(state)
    jck.wait()
    restored = jck.restore()
    jck.close()

    # the port saves the reference's restored state in its own format
    t = Trainer(apply_fn=lambda p, x: llama.apply(p, CFG, x),
                init_fn=None, device="cpu")
    tstate = t.init_from_params(bridge.from_jax(
        jax.tree.map(np.asarray, restored.params), CFG, "cpu"))
    tstate.step = int(restored.step)
    tdir = str(tmp_path / "port")
    ck = _ckpt(tdir, t, save_interval_steps=1, enable_async=True)
    assert ck.save(tstate)
    ck.wait()

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, CFG.vocab_size, 12).tolist()
               for _ in range(2)]

    def serve(app):
        async def go():
            async with TestClient(TestServer(app)) as client:
                out = []
                for p in prompts:
                    r = await client.post(
                        "/v1/models/llama-tiny:generate",
                        json={"tokens": [p], "max_new": 8})
                    assert r.status == 200, await r.text()
                    out.append((await r.json())["tokens"][0])
                return out

        return asyncio.run(go())

    jparams = _load_params(
        argparse.Namespace(random=False, checkpoint=jdir, seed=0),
        lambda k: jllama.init(k, jcfg))
    want = serve(jserver.create_serving_app({"llama-tiny": JEngine(
        jparams, jcfg, J_LLAMA, JEngineConfig(max_len=96))}))
    got = serve(cli.build_app(cli.parse_args(
        ["--model", "llama-tiny", "--checkpoint", tdir, "--max-len", "96",
         "--cpu"])))
    assert got == want
    # the port's loader read params.pt and nothing else of the step
    meta = json.loads(open(os.path.join(tdir, "1", "run_metadata.json"))
                      .read())
    assert meta == {"virtual_replicas": 1}
