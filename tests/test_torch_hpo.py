"""The port's HPO layer (kubeflow_tpu_torch/hpo/, numpy only) against
the reference's (kubeflow_tpu/hpo/): for the same seed and the same
observations the random, grid and TPE suggesters give the same
assignments, exactly, and `run_sweep` gives the same trials (failing
trials included)."""

import math

import numpy as np
import pytest

from kubeflow_tpu import hpo as jhpo
from kubeflow_tpu_torch import hpo


def _space(mod):
    return mod.SearchSpace((
        mod.Double("lr", 1e-4, 1.0, log=True),
        mod.Double("dropout", 0.0, 0.5),
        mod.Integer("layers", 1, 6),
        mod.Categorical("opt", ("adamw", "adafactor", "sgd")),
    ))


def _objective(a):
    return (math.log10(a["lr"]) + 2) ** 2 + a["dropout"] \
        + 0.1 * a["layers"] + (0.3 if a["opt"] == "sgd" else 0.0)


@pytest.mark.parametrize("algorithm,kw", [
    ("random", dict(seed=3)), ("random", dict(seed=11)),
    ("grid", dict(grid_points=3)), ("tpe", dict(seed=5)),
    ("bayesianoptimization", dict(seed=2))])
def test_suggestions_match_reference(algorithm, kw):
    got = hpo.make_suggester(algorithm, _space(hpo), **kw)
    want = jhpo.make_suggester(algorithm, _space(jhpo), **kw)
    for round_ in range(4):
        if hasattr(want, "observe"):
            # the same observations, a different set each round
            rng = np.random.default_rng(round_)
            seen = jhpo.make_suggester("random", _space(jhpo),
                                       seed=round_).suggest(12)
            obs = [(a, float(rng.normal())) for a in seen]
            want.observe(obs, "minimize")
            got.observe(obs, "minimize")
        assert got.suggest(7) == want.suggest(7)


@pytest.mark.parametrize("algorithm", ["random", "grid", "tpe"])
def test_run_sweep_matches_reference(algorithm):
    kw = dict(n_trials=12, goal="minimize", algorithm=algorithm, seed=4)
    got = hpo.run_sweep(_objective, _space(hpo), **kw)
    want = jhpo.run_sweep(_objective, _space(jhpo), **kw)
    assert [(t.assignment, t.value) for t in got.trials] == \
        [(t.assignment, t.value) for t in want.trials]
    assert got.best_assignment == want.best_assignment
    assert got.best_value == want.best_value


def test_run_sweep_survives_failing_trials():
    def objective(a):
        if a["layers"] % 2:
            raise RuntimeError("diverged")
        return _objective(a)

    kw = dict(n_trials=10, algorithm="tpe", seed=1)
    got = hpo.run_sweep(objective, _space(hpo), **kw)
    want = jhpo.run_sweep(objective, _space(jhpo), **kw)
    assert len(got.trials) == 10
    failed = [t for t in got.trials if t.value is None]
    assert failed and all(t.error == "diverged" for t in failed)
    assert [(t.assignment, t.value, t.error) for t in got.trials] == \
        [(t.assignment, t.value, t.error) for t in want.trials]
    assert got.best.value == min(t.value for t in got.trials
                                 if t.value is not None)


def test_all_failed_and_bad_goal():
    def boom(a):
        raise ValueError("no")

    res = hpo.run_sweep(boom, _space(hpo), n_trials=3)
    with pytest.raises(RuntimeError, match="no trial completed"):
        res.best
    with pytest.raises(ValueError, match="goal"):
        hpo.run_sweep(_objective, _space(hpo), goal="sideways")
    with pytest.raises(ValueError, match="unknown algorithm"):
        hpo.make_suggester("anneal", _space(hpo))
