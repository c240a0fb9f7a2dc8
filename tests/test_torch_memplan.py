"""The port's memory-fit planner (kubeflow_tpu_torch/tools/memplan.py)
against the repository's JAX planner (tools/memplan.py), on the CPU.

`plan` and `plan_serving` must give dicts equal to the reference's for
every case of tests/test_memplan.py (and a few more meshes and
models): the port sizes its params on the meta device where the
reference runs `jax.eval_shape`, and keeps its accounting, so every
number agrees exactly. The CLI keeps the reference's contract: one JSON
line on stdout equal to the plan, the table on stderr, exit 1 when the
plan does not fit and 2 (argparse) on a mesh that does not cover the
slice or an unknown axis. No device is allocated: the params are meta
tensors.
"""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import memplan as jmemplan  # noqa: E402

from kubeflow_tpu_torch.tools import memplan  # noqa: E402

ONE = {"data": 1, "fsdp": 1, "tensor": 1}
PLANS = [
    ("llama3-8b", {"data": 1, "fsdp": 16, "tensor": 1}, 16, 2048, "v5e"),
    ("llama3-8b", ONE, 1, 128, "v5e"),
    ("llama3-8b", {"data": 1, "fsdp": 8, "tensor": 2}, 16, 2048, "v5e"),
    ("llama3-8b", {"data": 2, "fsdp": 8, "tensor": 1}, 16, 2048, "v5e"),
    ("llama3-1b", {"data": 1, "fsdp": 4, "tensor": 1}, 16, 2048, "v5e"),
    ("llama3-1b", ONE, 2, 2048, "v5p"),
    ("gemma-2b", {"data": 2, "fsdp": 2, "tensor": 2}, 8, 1024, "v4"),
    ("gemma-tiny", ONE, 2, 64, "v6e"),
    ("tiny", {"data": 1, "fsdp": 2, "tensor": 2}, 4, 32, "v5e"),
]
SERVING = [
    ("llama3-8b", ONE, 8, 4096, "v5e", ""),
    ("llama3-8b", ONE, 8, 4096, "v5e", "int8"),
    ("llama3-8b", {"data": 1, "fsdp": 1, "tensor": 4}, 16, 8192, "v5e", ""),
    ("gemma-2b", {"data": 1, "fsdp": 1, "tensor": 4}, 8, 2048, "v5p",
     "int8"),
    ("llama3-1b", ONE, 0, 1024, "v5e", ""),
]


def test_registry_matches_reference():
    assert sorted(memplan.model_registry()) == sorted(
        jmemplan.model_registry())


@pytest.mark.parametrize("case", PLANS, ids=lambda c: f"{c[0]}-{c[4]}")
def test_plan_matches_reference(case):
    assert memplan.plan(*case) == jmemplan.plan(*case)


@pytest.mark.parametrize("case", SERVING, ids=lambda c: f"{c[0]}-{c[5]}")
def test_plan_serving_matches_reference(case):
    assert memplan.plan_serving(*case) == jmemplan.plan_serving(*case)


@pytest.mark.parametrize("argv,rc,want", [
    (["--model", "llama3-1b", "--topology", "v5e-4"], 0,
     ("llama3-1b", {"data": 1, "fsdp": 4, "tensor": 1}, 16, 2048, "v5e")),
    (["--model", "llama3-8b", "--topology", "v5e-1"], 1,
     ("llama3-8b", ONE, 16, 2048, "v5e")),
    (["--model", "gemma-2b", "--topology", "v4-8", "--mesh",
      "data=2,fsdp=2,tensor=2", "--batch", "4", "--seq", "512"], 0,
     ("gemma-2b", {"data": 2, "fsdp": 2, "tensor": 2}, 4, 512, "v4")),
])
def test_cli_contract(argv, rc, want, capsys):
    assert memplan.main(argv) == rc
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == jmemplan.plan(*want)
    assert "fits" in err


def test_cli_serving_and_usage_errors(capsys):
    assert memplan.main(["--model", "llama3-8b", "--topology", "v5e-1",
                         "--serve", "--quant", "int8", "--slots", "8",
                         "--max-len", "4096"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip()) == jmemplan.plan_serving(
        "llama3-8b", ONE, 8, 4096, "v5e", "int8")
    assert "slots fit" in err
    for argv in (["--topology", "v5e-16", "--mesh", "data=2,fsdp=2,tensor=2"],
                 ["--topology", "v5e-4", "--mesh", "data=1,fdsp=4"],
                 ["--topology", "v9-4"]):
        with pytest.raises(SystemExit) as e:
            memplan.main(argv)
        assert e.value.code == 2
