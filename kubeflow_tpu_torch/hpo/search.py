"""HPO search spaces and suggestion algorithms (a copy of
kubeflow_tpu/hpo/search.py, numpy only: for the same seed and the same
observations it gives the same suggestions).

Deterministic, seeded suggesters (random, grid, TPE) over typed
parameter domains, for in-process sweeps (hpo/local.py). The
reference's Experiment/Trial controllers are control plane and are not
part of the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

Assignment = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Double:
    name: str
    min: float
    max: float
    log: bool = False    # sample in log space (learning rates)

    def validate(self) -> None:
        if not (self.max > self.min):
            raise ValueError(f"{self.name}: max must exceed min")
        if self.log and self.min <= 0:
            raise ValueError(f"{self.name}: log scale needs min > 0")


@dataclasses.dataclass(frozen=True)
class Integer:
    name: str
    min: int
    max: int             # inclusive

    def validate(self) -> None:
        if not (self.max >= self.min):
            raise ValueError(f"{self.name}: max must be >= min")


@dataclasses.dataclass(frozen=True)
class Categorical:
    name: str
    values: tuple[Any, ...]

    def validate(self) -> None:
        if not self.values:
            raise ValueError(f"{self.name}: needs at least one value")


Parameter = Double | Integer | Categorical


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    parameters: tuple[Parameter, ...]

    def __post_init__(self):
        names = [p.name for p in self.parameters]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate parameter names in {names}")
        for p in self.parameters:
            p.validate()

    def parse(self, assignment: Mapping[str, str]) -> Assignment:
        """Typed values from a Trial's string assignment (the CR stores
        strings); unknown names are ignored, out-of-domain or unmatched
        values raise ValueError (a hand-edited lr="0" on a log-scale
        Double would otherwise detonate later inside TPE's math.log)."""
        out: Assignment = {}
        for p in self.parameters:
            if p.name not in assignment:
                continue
            raw = assignment[p.name]
            if isinstance(p, (Double, Integer)):
                # range-check BEFORE integer truncation: "5.9" against
                # max=5 must raise, not silently become 5
                v = float(raw)
                if not p.min <= v <= p.max:
                    raise ValueError(
                        f"{p.name}: {v} outside [{p.min}, {p.max}]")
                out[p.name] = v if isinstance(p, Double) else int(v)
            else:
                matches = [v for v in p.values if str(v) == str(raw)]
                if not matches:
                    raise ValueError(
                        f"{p.name}: value {raw!r} not in {p.values}")
                out[p.name] = matches[0]
        return out


class RandomSuggester:
    """Independent uniform (log-uniform for Double(log=True)) sampling."""

    def __init__(self, space: SearchSpace, seed: int = 0):
        self.space = space
        self._rng = np.random.default_rng(seed)

    def advance(self, n: int) -> None:
        """Skip past n prior suggestions (controller replay)."""
        self.suggest(n)

    def suggest(self, n: int) -> list[Assignment]:
        out = []
        for _ in range(n):
            a: Assignment = {}
            for p in self.space.parameters:
                if isinstance(p, Double):
                    if p.log:
                        a[p.name] = float(np.exp(self._rng.uniform(
                            math.log(p.min), math.log(p.max))))
                    else:
                        a[p.name] = float(self._rng.uniform(p.min, p.max))
                elif isinstance(p, Integer):
                    a[p.name] = int(self._rng.integers(p.min, p.max + 1))
                else:
                    a[p.name] = p.values[
                        int(self._rng.integers(len(p.values)))]
            out.append(a)
        return out


class GridSuggester:
    """Cartesian grid; Doubles get `grid_points` samples (log-aware).
    Exhausts after the full grid — suggest() then returns []."""

    def __init__(self, space: SearchSpace, grid_points: int = 5):
        self.space = space
        axes: list[list[Any]] = []
        for p in space.parameters:
            if isinstance(p, Double):
                if p.log:
                    pts = np.exp(np.linspace(math.log(p.min),
                                             math.log(p.max), grid_points))
                else:
                    pts = np.linspace(p.min, p.max, grid_points)
                axes.append([float(x) for x in pts])
            elif isinstance(p, Integer):
                span = p.max - p.min + 1
                if span <= grid_points:
                    axes.append(list(range(p.min, p.max + 1)))
                else:
                    axes.append(sorted({
                        int(round(x)) for x in
                        np.linspace(p.min, p.max, grid_points)}))
            else:
                axes.append(list(p.values))
        self._grid = itertools.product(*axes)
        self._names = [p.name for p in space.parameters]

    def advance(self, n: int) -> None:
        """Skip past n prior suggestions (controller replay)."""
        self.suggest(n)

    def suggest(self, n: int) -> list[Assignment]:
        out = []
        for combo in itertools.islice(self._grid, n):
            out.append(dict(zip(self._names, combo)))
        return out


class TpeSuggester:
    """Tree-structured Parzen Estimator (Bergstra et al. 2011) — the
    algorithm behind Katib's "tpe"/"bayesianoptimization" modes.

    Completed trials split into a good set (top `gamma` fraction under
    the goal) and a bad set; per dimension, Parzen/kernel densities
    l(x) (good) and g(x) (bad) are fit, candidates are drawn from l and
    the candidate maximizing l(x)/g(x) wins — "look like the good
    trials, not like the bad ones". With fewer than `min_observations`
    results it falls back to seeded random exploration.

    Controller protocol: the suggester is recreated every reconcile.
    `observe()` feeds finished-trial (assignment, value) pairs; the
    replay call `suggest(len(existing_trials))` only advances an
    internal counter that salts the RNG, so fresh batches never repeat
    earlier randomness — cheap, and observation-dependent suggestions
    need no replayability (existing trials are already pinned to their
    assignments in the store).
    """

    def __init__(self, space: SearchSpace, seed: int = 0,
                 gamma: float = 0.25, n_candidates: int = 24,
                 min_observations: int = 8):
        self.space = space
        self.seed = seed
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.min_observations = min_observations
        self._good: list[Assignment] = []
        self._bad: list[Assignment] = []
        self._counter = 0

    def observe(self, observations: Sequence[tuple[Assignment, float]],
                goal: str) -> None:
        if not observations:
            return
        ranked = sorted(
            observations, key=lambda av: av[1],
            reverse=(goal == "maximize"))
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        self._good = [a for a, _ in ranked[:n_good]]
        self._bad = [a for a, _ in ranked[n_good:]]

    # -- per-dimension Parzen machinery -----------------------------------

    def _to_unit(self, p: Parameter, v: Any) -> float:
        """Map a Double/Integer value into [0, 1] (log-aware)."""
        if isinstance(p, Double) and p.log:
            return ((math.log(v) - math.log(p.min))
                    / (math.log(p.max) - math.log(p.min)))
        lo, hi = float(p.min), float(p.max)
        return (float(v) - lo) / max(hi - lo, 1e-12)

    def _from_unit(self, p: Parameter, u: float) -> Any:
        u = min(max(u, 0.0), 1.0)
        if isinstance(p, Double):
            if p.log:
                v = float(math.exp(
                    math.log(p.min)
                    + u * (math.log(p.max) - math.log(p.min))))
            else:
                v = float(p.min + u * (p.max - p.min))
            # exp/log round-trips can land an ulp past the declared
            # domain; suggestions must honor it exactly
            return min(max(v, p.min), p.max)
        return int(round(p.min + u * (p.max - p.min)))

    @staticmethod
    def _kde_logpdf(u: float, centers: list[float], bw: float) -> float:
        """Parzen density MIXED with a uniform prior (weight 0.25).

        The prior is load-bearing, not a nicety: where the bad set has
        no mass (domain edges, under-explored regions) a bare KDE ratio
        l/g explodes and every suggestion piles onto the clip boundary
        — observed as 16/16 candidates at lr == max. The uniform floor
        bounds the ratio where data is sparse, so the argmax lands
        where the GOOD density actually peaks."""
        if not centers:
            return 0.0  # pure prior: uniform over the unit interval
        kde = np.mean(np.exp(
            -0.5 * ((u - np.asarray(centers)) / bw) ** 2
        )) / (bw * math.sqrt(2 * math.pi))
        return float(np.log(0.75 * kde + 0.25))

    def _cat_probs(self, p: Categorical,
                   assignments: list[Assignment]) -> np.ndarray:
        counts = np.ones(len(p.values))  # +1 Dirichlet smoothing
        for a in assignments:
            if p.name in a:
                counts[p.values.index(a[p.name])] += 1
        return counts / counts.sum()

    def advance(self, n: int) -> None:
        """Controller replay: salt the RNG past n prior suggestions
        WITHOUT scoring candidates that would be thrown away."""
        self._counter += n

    def suggest(self, n: int) -> list[Assignment]:
        rng = np.random.default_rng((self.seed, self._counter))
        self._counter += n
        n_obs = len(self._good) + len(self._bad)
        if n_obs < self.min_observations:
            rand = RandomSuggester(self.space, seed=0)
            rand._rng = rng
            return rand.suggest(n)

        bw = max(0.1, 1.0 / max(len(self._good), 1) ** 0.5)
        # Per-dimension stats are invariant across candidates: one pass.
        dim: dict[str, Any] = {}
        for p in self.space.parameters:
            if isinstance(p, Categorical):
                dim[p.name] = (self._cat_probs(p, self._good),
                               self._cat_probs(p, self._bad))
            else:
                dim[p.name] = (
                    [self._to_unit(p, x[p.name])
                     for x in self._good if p.name in x],
                    [self._to_unit(p, x[p.name])
                     for x in self._bad if p.name in x])
        out = []
        for _ in range(n):
            best_a, best_score = None, -np.inf
            for _ in range(self.n_candidates):
                a: Assignment = {}
                score = 0.0
                for p in self.space.parameters:
                    if isinstance(p, Categorical):
                        lp, gp = dim[p.name]
                        i = int(rng.choice(len(p.values), p=lp))
                        a[p.name] = p.values[i]
                        score += math.log(lp[i]) - math.log(gp[i])
                    else:
                        centers, bad_centers = dim[p.name]
                        if centers:
                            u = float(np.clip(
                                rng.choice(centers)
                                + bw * rng.standard_normal(), 0, 1))
                        else:
                            u = float(rng.uniform())
                        a[p.name] = self._from_unit(p, u)
                        score += (self._kde_logpdf(u, centers, bw)
                                  - self._kde_logpdf(u, bad_centers, bw))
                if score > best_score:
                    best_a, best_score = a, score
            out.append(best_a)
        return out


SUGGESTERS = {"random": RandomSuggester, "grid": GridSuggester,
              "tpe": TpeSuggester, "bayesianoptimization": TpeSuggester}
# Algorithms whose constructor takes a seed: how run_sweep decides
# whether to pass its seed through.
SEEDED_ALGORITHMS = frozenset(
    {"random", "tpe", "bayesianoptimization"})


def make_suggester(algorithm: str, space: SearchSpace, **kwargs):
    try:
        cls = SUGGESTERS[algorithm]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {algorithm!r}; have {sorted(SUGGESTERS)}"
        ) from None
    return cls(space, **kwargs)


def better(goal: str, a: float, b: float) -> bool:
    """Is metric `a` better than `b` under goal 'minimize'/'maximize'?"""
    if goal == "minimize":
        return a < b
    if goal == "maximize":
        return a > b
    raise ValueError(f"goal must be minimize|maximize, got {goal!r}")
