"""The port trainer's obs bridge against the JAX reference's, on the CPU.

LLAMA_TINY trains two steps on one batch in both frameworks, each with
its own registry and tracer, then one step on a batch of another shape.
Both expose the same families (`train_step_seconds`,
`train_compile_seconds`, `train_step_phase_seconds` seeded for `step`
and `host_gap`, `train_recompiles_total{fn="train_step"}`) with the same
sample counts, and the same `train.step` spans (one a step, `compile`
on the first); the new shape is one recompile in both, with a
`recompile` span. Without arguments the port's trainers share the
process defaults (`obs.DEFAULT_TRACER`, `obs.default_registry()`).
"""

import re

import jax
import numpy as np
import torch

from kubeflow_tpu.controlplane.metrics import Registry as JRegistry
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.obs import tracing as jtr
from kubeflow_tpu.parallel import MeshSpec, create_mesh
from kubeflow_tpu.train import trainer as jtrain
from kubeflow_tpu_torch import obs as tobs
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import tracing as ttr
from kubeflow_tpu_torch.train import trainer as ttrain

FAMILIES = ("train_step_seconds", "train_compile_seconds",
            "train_step_phase_seconds", "train_recompiles_total")
TC = dict(learning_rate=1e-2, warmup_steps=2, total_steps=50)


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for b, s in ((2, 16), (2, 16), (2, 8)):
        toks = rng.integers(0, 512, (b, s)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _samples(text: str) -> dict:
    """{(family line name, labels): value} of the train families, sums
    and bucket lines left out (wall times)."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"([a-z_]+)(\{[^}]*\})? (\S+)$", line)
        if not m or not m.group(1).startswith(FAMILIES):
            continue
        name = m.group(1)
        if name.endswith(("_sum", "_bucket")):
            continue
        out[(name, m.group(2) or "")] = float(m.group(3))
    return out


def _spans(tracer):
    return [(s["name"], s["attrs"]) for t in reversed(tracer.traces())
            for s in t["spans"]]


def _reference(batches):
    cfg = jllama.LLAMA_TINY
    reg, tracer = JRegistry(), jtr.Tracer()
    trainer = jtrain.Trainer(
        mesh=create_mesh(MeshSpec(data=1, fsdp=1, tensor=1),
                         devices=jax.devices()[:1]),
        apply_fn=lambda p, t: jllama.apply(p, cfg, t),
        init_fn=lambda k: jllama.init(k, cfg),
        logical_axes=jllama.param_logical_axes(cfg),
        train_config=jtrain.TrainConfig(**TC), registry=reg, tracer=tracer)
    state = trainer.init(jax.random.key(0))
    for toks, tgts in batches:
        state, _ = trainer.step(state, toks, tgts)
    return reg.render(), tracer


def _port(batches, **kw):
    cfg = tllama.LLAMA_TINY
    trainer = ttrain.Trainer(
        apply_fn=lambda p, t: tllama.apply(p, cfg, t),
        init_fn=lambda seed: tllama.init(cfg, seed, "cpu", train=True),
        train_config=ttrain.TrainConfig(**TC), device="cpu", **kw)
    state = trainer.init(0)
    for toks, tgts in batches:
        state, _ = trainer.step(state, torch.from_numpy(toks),
                                torch.from_numpy(tgts))
    return trainer


def test_two_steps_give_the_reference_families_and_spans():
    batches = _batches()[:2]
    jtext, jtracer = _reference(batches)
    reg, tracer = tobs.metrics.Registry(), ttr.Tracer()
    trainer = _port(batches, registry=reg, tracer=tracer)
    got, want = _samples(reg.render()), _samples(jtext)
    assert got == want
    assert got[("train_step_seconds_count", "")] == 2
    assert got[("train_compile_seconds_count", "")] == 1
    assert got[("train_step_phase_seconds_count", '{phase="step"}')] == 2
    assert got[("train_step_phase_seconds_count",
                '{phase="host_gap"}')] == 1
    assert got[("train_recompiles_total", '{fn="train_step"}')] == 0
    assert _spans(tracer) == _spans(jtracer)
    assert _spans(tracer) == [("train.step", {"batch": 2, "compile": True}),
                              ("train.step", {"batch": 2,
                                              "compile": False})]
    assert set(trainer.profiler.totals()) == {"step", "host_gap"}


def test_a_new_batch_shape_is_one_recompile_in_both():
    batches = _batches()
    jtext, jtracer = _reference(batches)
    reg, tracer = tobs.metrics.Registry(), ttr.Tracer()
    _port(batches, registry=reg, tracer=tracer)
    got, want = _samples(reg.render()), _samples(jtext)
    assert got == want
    assert got[("train_recompiles_total", '{fn="train_step"}')] == 1
    assert [n for n, _ in _spans(tracer)] == [n for n, _ in _spans(jtracer)]
    # under the third step's span
    (rec,) = [a for n, a in _spans(tracer) if n == "recompile"]
    assert rec["fn"] == "train_step"
    assert "int32[2,8]" in rec["signature"]


def test_trainers_share_the_process_defaults():
    batch = _batches()[:1]
    before = len(tobs.DEFAULT_TRACER.traces(name="train.step",
                                            limit=None))
    a = _port(batch)
    b = _port(batch)
    assert a.tracer is b.tracer is tobs.DEFAULT_TRACER
    after = tobs.DEFAULT_TRACER.traces(name="train.step", limit=None)
    assert len(after) == min(before + 2, tobs.DEFAULT_TRACER.max_traces)
    hist = tobs.default_registry().get("train_step_seconds")
    assert a.step_seconds is b.step_seconds is hist
    assert hist.count() >= 2
