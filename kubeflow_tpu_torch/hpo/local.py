"""In-process HPO sweeps: run an objective function over a search space.

The notebook-user entry point (no control plane needed): the
suggesters of hpo/search.py, executed inline (a copy of
kubeflow_tpu/hpo/local.py).

    from kubeflow_tpu_torch.hpo import Double, SearchSpace, run_sweep
    result = run_sweep(
        lambda a: train(lr=a["lr"]),           # returns the metric
        SearchSpace((Double("lr", 1e-5, 1e-2, log=True),)),
        n_trials=20, goal="minimize",
    )
    result.best_assignment, result.best_value
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

from kubeflow_tpu_torch.hpo.search import (
    SEEDED_ALGORITHMS,
    Assignment,
    SearchSpace,
    better,
    make_suggester,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrialResult:
    assignment: Assignment
    value: float | None       # None = trial raised
    error: str = ""


@dataclasses.dataclass
class SweepResult:
    goal: str
    trials: list[TrialResult]

    @property
    def best(self) -> TrialResult:
        done = [t for t in self.trials if t.value is not None]
        if not done:
            raise RuntimeError("no trial completed successfully")
        out = done[0]
        for t in done[1:]:
            if better(self.goal, t.value, out.value):
                out = t
        return out

    @property
    def best_assignment(self) -> Assignment:
        return self.best.assignment

    @property
    def best_value(self) -> float:
        return self.best.value


def run_sweep(
    objective: Callable[[Assignment], float],
    space: SearchSpace,
    *,
    n_trials: int = 10,
    goal: str = "minimize",
    algorithm: str = "random",
    seed: int = 0,
    **algo_kwargs: Any,
) -> SweepResult:
    """Sequentially evaluate suggested assignments; exceptions in the
    objective mark the trial failed and the sweep continues."""
    better(goal, 0.0, 1.0)  # validates goal early
    if algorithm in SEEDED_ALGORITHMS:
        algo_kwargs.setdefault("seed", seed)
    suggester = make_suggester(algorithm, space, **algo_kwargs)
    trials: list[TrialResult] = []
    while len(trials) < n_trials:
        if hasattr(suggester, "observe"):
            # Adaptive algorithms (TPE) must see finished results or
            # they degrade to their random fallback forever.
            suggester.observe(
                [(t.assignment, t.value) for t in trials
                 if t.value is not None], goal)
        batch = suggester.suggest(min(8, n_trials - len(trials)))
        if not batch:
            break  # grid exhausted
        for a in batch:
            try:
                v = float(objective(a))
                trials.append(TrialResult(a, v))
            except Exception as e:  # noqa: BLE001 — user objective
                log.warning("trial %s failed: %s", a, e)
                trials.append(TrialResult(a, None, error=str(e)))
    return SweepResult(goal=goal, trials=trials)
