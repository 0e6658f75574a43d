"""COMPASS-V: feasible-configuration search (paper §IV, Algorithm 1).

Reformulated hyperparameter optimization: instead of a single optimum, find the
*feasible set* ``F = {(c, Acc(c)) : Acc(c) >= tau}`` (Eq. 2), because runtime
adaptation needs multiple configurations to switch between.

Navigation (paper §IV-B):
  - seed with Latin Hypercube Sampling for coverage of disconnected regions;
  - *hill-climbing* while infeasible: follow the IDW gradient estimate toward
    higher accuracy until reaching the feasible region;
  - *lateral expansion* once feasible: explore neighbors, prioritizing
    low-gradient axes, to trace the feasible boundary (breadth-first over the
    adjacency graph — this is what yields the 100% recall completeness
    property of §IV-C for connected feasible regions);
  - progressive budgeting with Wilson-CI early stopping throughout.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_Z95 = 1.959963984540054

from .evaluate import EvalResult, ProgressiveEvaluator, SampleEvaluator
from .gradient import GradientEstimate, idw_gradient, low_gradient_axes
from .space import Config, ConfigSpace


@dataclass
class TracePoint:
    """Anytime-convergence record (paper Fig. 3)."""

    evaluations: int            # configurations evaluated so far
    samples: int                # workflow sample executions consumed so far
    feasible_found: int


@dataclass
class SearchResult:
    feasible: "OrderedDict[Config, float]"          # config -> accuracy estimate
    evaluated: Dict[Config, float]                  # all evaluated configs
    results: Dict[Config, EvalResult]
    samples_consumed: int
    trace: List[TracePoint]

    @property
    def num_evaluations(self) -> int:
        return len(self.evaluated)

    def savings_vs_exhaustive(self, space: ConfigSpace, max_budget: int) -> float:
        """Fractional reduction in sample evaluations vs. exhaustive grid
        search at full budget (paper Fig. 4's y-axis)."""
        exhaustive = space.cardinality * max_budget
        return 1.0 - self.samples_consumed / exhaustive

    def recall(self, ground_truth: Sequence[Config]) -> float:
        gt = set(ground_truth)
        if not gt:
            return 1.0
        return len(gt & set(self.feasible)) / len(gt)


@dataclass
class CompassV:
    """Algorithm 1 driver.

    Parameters
    ----------
    space: the configuration space C.
    evaluator: per-sample workflow scorer.
    tau: accuracy threshold defining feasibility.
    budget_schedule: progressive budgets {b_1..b_K}; b_K is B_max.
    n_init: Latin-Hypercube seed count.  Defaults to a size that makes the
        seeding probability of §IV-C high even for small feasible fractions.
    k_neighbors / idw_power: Eq. 3 hyperparameters.
    confidence: Wilson confidence level.
    seed: RNG seed for LHS.
    """

    space: ConfigSpace
    evaluator: SampleEvaluator
    tau: float
    budget_schedule: Tuple[int, ...]
    n_init: Optional[int] = None
    k_neighbors: int = 8
    idw_power: float = 2.0
    confidence: float = 0.95
    infeasible_confidence: Optional[float] = 0.99
    climb_axes: int = 1
    seed: int = 0
    sample_order: Optional[Sequence[int]] = None

    def run(self) -> SearchResult:
        space = self.space
        progressive = ProgressiveEvaluator(
            evaluator=self.evaluator,
            budget_schedule=self.budget_schedule,
            confidence=self.confidence,
            infeasible_confidence=self.infeasible_confidence,
            sample_order=self.sample_order,
        )
        n_init = self.n_init
        if n_init is None:
            # P_seed >= 1 - (1 - f)^n_init (§IV-C): cover the space enough
            # that even ~3% feasible fractions seed w.h.p., capped at |C|.
            n_init = min(space.cardinality, max(12, space.cardinality // 10))

        feasible: "OrderedDict[Config, float]" = OrderedDict()
        evaluated: Dict[Config, float] = {}
        results: Dict[Config, EvalResult] = {}
        trace: List[TracePoint] = []

        # FIFO work queue with dedup (Algorithm 1: Q)
        queue: "OrderedDict[Config, None]" = OrderedDict()
        for c in space.lhs_sample(n_init, seed=self.seed):
            queue[c] = None

        while queue:
            config, _ = queue.popitem(last=False)
            if config in evaluated:
                continue
            res = progressive.evaluate(config, self.tau)       # lines 5-10
            evaluated[config] = res.estimate                   # line 11
            results[config] = res

            if res.classification == "feasible":               # line 12
                feasible[config] = res.estimate                # line 13
                for nxt in self._lateral_expand(config, evaluated):   # line 14
                    if nxt not in evaluated:
                        queue[nxt] = None
            else:
                # Boundary persistence: a config that exhausted B_max with the
                # Wilson interval still straddling tau AND a point estimate
                # within half the terminal CI half-width of tau sits ON the
                # feasibility boundary (the tie-break resolved it by point
                # estimate).  The feasible region's frontier — including
                # isolated feasible cells the LHS seeding missed — is adjacent
                # to exactly such configs, so expand all their neighbors like
                # a feasible boundary point.  Clearly-infeasible configs
                # (CI_hi < tau) still prune hard, preserving the savings
                # profile; the margin gate keeps merely-noisy configs (est
                # well below tau but wide CI) on the cheap hill-climb path.
                half_w = 0.5 * _Z95 * math.sqrt(
                    self.tau * (1.0 - self.tau) / self.budget_schedule[-1]
                )
                if (
                    res.interval.upper >= self.tau
                    and res.estimate >= self.tau - half_w
                ):
                    for nxt in self._lateral_expand(config, evaluated):
                        if nxt not in evaluated:
                            queue[nxt] = None
                else:
                    grad = idw_gradient(
                        space, config, evaluated,
                        k=self.k_neighbors, power=self.idw_power,
                    )                                          # line 16
                    for nxt in self._hill_climb(config, grad):  # line 17
                        if nxt not in evaluated:
                            queue[nxt] = None

            trace.append(TracePoint(
                evaluations=len(evaluated),
                samples=progressive.total_samples_consumed,
                feasible_found=len(feasible),
            ))

        return SearchResult(
            feasible=feasible,
            evaluated=evaluated,
            results=results,
            samples_consumed=progressive.total_samples_consumed,
            trace=trace,
        )

    # -- navigation ----------------------------------------------------------

    def _lateral_expand(self, config: Config, evaluated: Dict[Config, float]) -> List[Config]:
        """LATERALEXPAND (line 14): enqueue all unevaluated neighbors of a
        feasible configuration, ordered so that low-gradient axes come first.

        Expanding *all* neighbors (not only low-gradient axes) is what the
        completeness argument of §IV-C relies on ('all neighbors are explored
        at each expansion step'); the gradient only prioritizes the frontier
        ordering so that anytime recall grows fast along the boundary.
        """
        grad = idw_gradient(
            self.space, config, evaluated, k=self.k_neighbors, power=self.idw_power
        )
        lateral_first = low_gradient_axes(grad, fraction=0.5)
        ordered_axes = lateral_first + [
            ax for ax in range(self.space.num_parameters) if ax not in lateral_first
        ]
        out: List[Config] = []
        for ax in ordered_axes:
            out.extend(self.space.neighbors_on_axis(config, ax))
        return out

    def _hill_climb(self, config: Config, grad: GradientEstimate) -> List[Config]:
        """HILLCLIMB (line 17): step along the estimated ascent direction.

        With no gradient support yet (early in the run) fall back to all
        neighbors of the infeasible config — pure exploration.  Otherwise take
        a single ladder step on the ``climb_axes`` steepest-ascent axes; a
        narrow frontier is what keeps the evaluation count to "a small
        fraction of the space" at tight thresholds (paper §VI-B1).
        """
        if grad.support == 0 or grad.magnitude == 0.0:
            return self.space.neighbors(config)
        ranked = sorted(
            range(len(grad.vector)), key=lambda i: -abs(grad.vector[i])
        )
        out: List[Config] = []
        for ax in ranked[: max(1, self.climb_axes)]:
            if self.space.parameters[ax].kind == "categorical":
                # a ladder step is meaningless across unordered values;
                # explore the categorical alternatives on that axis instead
                out.extend(self.space.neighbors_on_axis(config, ax))
                continue
            direction = 1 if grad.vector[ax] > 0 else -1
            nxt = self.space.step_on_axis(config, ax, direction)
            if nxt is not None:
                out.append(nxt)
        if not out:
            out = self.space.neighbors(config)
        return out


def exhaustive_search(
    space: ConfigSpace,
    evaluator: SampleEvaluator,
    tau: float,
    max_budget: int,
    *,
    sample_order: Optional[Sequence[int]] = None,
) -> SearchResult:
    """Ground-truth grid search (paper §VI-B): every configuration at full
    budget.  Used to establish recall and the savings baseline."""
    feasible: "OrderedDict[Config, float]" = OrderedDict()
    evaluated: Dict[Config, float] = {}
    results: Dict[Config, EvalResult] = {}
    trace: List[TracePoint] = []
    consumed = 0
    for config in space.enumerate():
        idx = list(sample_order[:max_budget]) if sample_order is not None else list(range(max_budget))
        scores = [float(s) for s in evaluator(config, idx)]
        consumed += len(scores)
        est = sum(scores) / len(scores)
        evaluated[config] = est
        from .wilson import wilson_interval
        res = EvalResult(
            config=config,
            estimate=est,
            interval=wilson_interval(sum(scores), len(scores)),
            samples_used=len(scores),
            classification="feasible" if est >= tau else "infeasible",
        )
        results[config] = res
        if est >= tau:
            feasible[config] = est
        trace.append(TracePoint(len(evaluated), consumed, len(feasible)))
    return SearchResult(
        feasible=feasible,
        evaluated=evaluated,
        results=results,
        samples_consumed=consumed,
        trace=trace,
    )
