"""The serving CLI's and app's reference knobs on the port: `--name`,
`--paged-attention-impl` and `create_serving_app(max_pending=)`, each
refusal held to the JAX reference's text on the same call."""

import asyncio
import types

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import EngineConfig as JEngineConfig
from kubeflow_tpu.serving import InferenceEngine as JEngine
from kubeflow_tpu.serving import LLAMA_FAMILY as J_LLAMA
from kubeflow_tpu.serving import __main__ as jcli
from kubeflow_tpu.serving import server as jserver
from kubeflow_tpu.serving.continuous import Overloaded as JOverloaded
from kubeflow_tpu_torch import bridge
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.serving import __main__ as cli
from kubeflow_tpu_torch.serving.continuous import Overloaded
from kubeflow_tpu_torch.serving.engine import (
    LLAMA_FAMILY,
    EngineConfig,
    InferenceEngine,
)
from kubeflow_tpu_torch.serving.server import (
    BATCHERS_KEY,
    ENGINES_KEY,
    create_serving_app,
)

pytest_plugins = ("aiohttp.pytest_plugin",)

TINY = ["--model", "llama-tiny", "--random", "--max-len", "64"]


@pytest.fixture(scope="module")
def engines():
    params = jllama.init(jax.random.key(0), jllama.LLAMA_TINY)
    jeng = JEngine(params, jllama.LLAMA_TINY, J_LLAMA,
                   JEngineConfig(max_len=64))
    teng = InferenceEngine(
        bridge.from_jax(jax.tree.map(np.asarray, params),
                        tllama.LLAMA_TINY, "cpu"),
        tllama.LLAMA_TINY, LLAMA_FAMILY, EngineConfig(max_len=64),
        device="cpu")
    return jeng, teng


def _cli_error(main, argv, capsys) -> str:
    """The text after `error: ` of an argparse refusal."""
    with pytest.raises(SystemExit):
        main(argv)
    return capsys.readouterr().err.strip().split("error: ", 1)[1]


async def test_name_reaches_models_and_the_route(aiohttp_client):
    app = cli.build_app(cli.parse_args(TINY + ["--cpu", "--name", "x"]))
    assert list(app[ENGINES_KEY]) == ["x"]
    client = await aiohttp_client(app)
    models = await (await client.get("/v1/models")).json()
    assert [m["name"] for m in models["models"]] == ["x"]
    r = await client.post("/v1/models/x:generate",
                          json={"tokens": [[3, 1, 4]], "max_new": 2})
    assert r.status == 200
    assert len((await r.json())["tokens"][0]) == 2
    r = await client.post("/v1/models/llama-tiny:generate",
                          json={"tokens": [[3, 1, 4]], "max_new": 2})
    assert r.status == 404


def test_name_defaults_to_the_model():
    assert cli.parse_args(TINY).name == ""
    app = cli.build_app(cli.parse_args(TINY + ["--cpu"]))
    assert list(app[ENGINES_KEY]) == ["llama-tiny"]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_paged_attention_impl_needs_continuous(impl, capsys):
    """Refused without --continuous, in the reference's words."""
    argv = TINY + ["--cpu", "--paged-attention-impl", impl]
    want = _cli_error(jcli.main, argv, capsys)
    assert want == "--paged-attention-impl requires --continuous"
    assert _cli_error(cli.main, argv, capsys) == want


def test_paged_attention_impl_xla_is_refused_on_the_card(capsys,
                                                         monkeypatch):
    """`xla` off --cpu is refused at start-up, before any engine is
    built: on the card the paged path is the kernel."""
    def no_build(args):
        raise AssertionError("an engine was built")

    monkeypatch.setattr(cli, "build_app", no_build)
    err = _cli_error(cli.main, TINY + ["--continuous",
                                       "--paged-attention-impl", "xla"],
                     capsys)
    assert "--cpu only" in err and "CUDA kernel" in err


@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
async def test_paged_attention_impl_serves_on_the_cpu(impl, aiohttp_client):
    app = cli.build_app(cli.parse_args(
        TINY + ["--cpu", "--continuous", "--paged-attention-impl", impl]))
    batcher = app[BATCHERS_KEY]["llama-tiny"]
    assert batcher.cengine.attention_impl == "torch"
    client = await aiohttp_client(app)
    r = await client.post("/v1/models/llama-tiny:generate",
                          json={"tokens": [[3, 1, 4]], "max_new": 2})
    assert r.status == 200


def test_xla_is_refused_for_an_engine_on_the_card():
    card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="on the card the paged path is "
                                         "the CUDA kernel"):
        create_serving_app({"m": card}, continuous=True,
                           paged_attention_impl="xla")
    with pytest.raises(ValueError, match="'auto', 'xla' or 'pallas'"):
        create_serving_app({"m": card}, continuous=True,
                           paged_attention_impl="triton")


@pytest.mark.parametrize("knob", [dict(max_pending=4),
                                  dict(paged_attention_impl="pallas"),
                                  dict(prefill_chunk_tokens=8)])
def test_continuous_only_knobs_refused_as_the_reference(engines, knob):
    jeng, teng = engines
    with pytest.raises(ValueError) as want:
        jserver.create_serving_app({"m": jeng}, **knob)
    with pytest.raises(ValueError) as got:
        create_serving_app({"m": teng}, **knob)
    assert str(got.value) == str(want.value)


def test_max_pending_sheds_at_that_depth(engines):
    """Continuous mode: the batcher holds max_pending queued requests
    and sheds the next, as the reference's does on the same calls."""
    jeng, teng = engines

    async def fill(app, key, overloaded):
        batcher = app[key]["m"]
        opened = [batcher.open_stream([1, 2, 3], 2, {}) for _ in range(2)]
        with pytest.raises(overloaded, match="max_pending=2"):
            batcher.open_stream([1, 2, 3], 2, {})
        for fut, _ in opened:
            fut.cancel()
        return batcher.max_pending

    assert asyncio.run(fill(jserver.create_serving_app(
        {"m": jeng}, continuous=True, max_pending=2), jserver.BATCHERS_KEY,
        JOverloaded)) == 2
    assert asyncio.run(fill(create_serving_app(
        {"m": teng}, continuous=True, max_pending=2), BATCHERS_KEY,
        Overloaded)) == 2
    default = create_serving_app({"m": teng}, continuous=True)
    assert default[BATCHERS_KEY]["m"].max_pending == 256


async def test_max_pending_zero_sheds_every_request(engines, aiohttp_client):
    _, teng = engines
    client = await aiohttp_client(create_serving_app(
        {"m": teng}, continuous=True, max_pending=0))
    r = await client.post("/v1/models/m:generate",
                          json={"tokens": [[3, 1, 4]], "max_new": 2})
    assert r.status == 429
