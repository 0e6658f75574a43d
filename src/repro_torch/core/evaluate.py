"""Progressive-budget evaluation with Wilson-CI early stopping (paper §IV-B).

Accuracy evaluation of a compound workflow is expensive (each sample is a full
workflow execution).  COMPASS-V therefore evaluates on a *budget schedule*
``{b_1 < b_2 < ... < b_K}``: it draws ``b_1`` samples, classifies against tau
with a Wilson interval, and only continues to the next budget level while the
classification is uncertain (Algorithm 1, lines 5-10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from .space import Config
from .wilson import WilsonInterval, classify, wilson_interval


class SampleEvaluator(Protocol):
    """Per-sample workflow evaluation.

    ``__call__(config, sample_indices)`` runs the workflow under ``config`` on
    the given dataset sample indices and returns one score in [0, 1] per
    sample (exact-match / F1 / detection hit).
    """

    def __call__(self, config: Config, sample_indices: Sequence[int]) -> Sequence[float]:
        ...


@dataclass
class EvalResult:
    config: Config
    estimate: float            # point estimate a-hat over all consumed samples
    interval: WilsonInterval
    samples_used: int
    classification: str        # "feasible" | "infeasible" | "uncertain"


@dataclass
class ProgressiveEvaluator:
    """Evaluates configurations under the progressive budget schedule.

    Parameters
    ----------
    evaluator: per-sample scorer (one workflow execution per sample index).
    budget_schedule: increasing sample counts, e.g. (10, 25, 50, 100).
    confidence: Wilson confidence level (paper uses 95%).
    sample_order: optional fixed permutation of dataset indices so every
        configuration sees the same sample sequence (paired evaluation reduces
        variance between configs; also makes runs reproducible).
    """

    evaluator: SampleEvaluator
    budget_schedule: Tuple[int, ...]
    confidence: float = 0.95
    infeasible_confidence: Optional[float] = None
    sample_order: Optional[Sequence[int]] = None
    total_samples_consumed: int = field(default=0, init=False)
    evaluations: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        bs = tuple(self.budget_schedule)
        if not bs or any(b <= 0 for b in bs) or any(
            b2 <= b1 for b1, b2 in zip(bs, bs[1:])
        ):
            raise ValueError(f"budget schedule must be positive increasing, got {bs}")
        self.budget_schedule = bs

    def _indices(self, upto: int) -> Sequence[int]:
        if self.sample_order is not None:
            return list(self.sample_order[:upto])
        return list(range(upto))

    def evaluate(self, config: Config, tau: float) -> EvalResult:
        """Algorithm 1 lines 5-10: grow the budget until the Wilson interval
        clears tau on either side, or the final budget level is exhausted."""
        scores: List[float] = []
        consumed = 0
        classification = "uncertain"
        for b in self.budget_schedule:
            need = b - consumed
            if need > 0:
                idx = self._indices(b)[consumed:b]
                new = list(self.evaluator(config, idx))
                if len(new) != len(idx):
                    raise RuntimeError(
                        f"evaluator returned {len(new)} scores for {len(idx)} samples"
                    )
                for s in new:
                    if not (0.0 <= float(s) <= 1.0):
                        raise ValueError(f"sample score {s} outside [0,1]")
                scores.extend(float(s) for s in new)
                consumed = b
            classification = classify(sum(scores), consumed, tau, self.confidence)
            if classification == "infeasible" and self.infeasible_confidence is not None:
                # Asymmetric early stopping: declaring a configuration
                # infeasible prunes it from the feasible set forever, so a
                # false negative costs recall (the paper's headline metric)
                # while a false positive only costs extra samples.  Require a
                # stricter confidence on the infeasible side.
                classification = classify(
                    sum(scores), consumed, tau, self.infeasible_confidence
                )
                if classification == "feasible":
                    classification = "uncertain"
            if classification != "uncertain":
                break
        self.total_samples_consumed += consumed
        self.evaluations += 1
        interval = wilson_interval(sum(scores), consumed, self.confidence)
        estimate = sum(scores) / consumed if consumed else 0.0
        # At budget exhaustion an uncertain config is resolved by its point
        # estimate (the paper adds samples "until confident classification";
        # with a finite max budget the point estimate is the tie-breaker).
        if classification == "uncertain":
            classification = "feasible" if estimate >= tau else "infeasible"
        return EvalResult(
            config=config,
            estimate=estimate,
            interval=interval,
            samples_used=consumed,
            classification=classification,
        )


def make_budget_schedule(max_budget: int, levels: int = 4, first: int = 10) -> Tuple[int, ...]:
    """Geometric budget schedule ending exactly at ``max_budget``."""
    if max_budget <= first:
        return (max_budget,)
    out = [first]
    ratio = (max_budget / first) ** (1.0 / max(1, levels - 1))
    for _ in range(levels - 2):
        nxt = int(round(out[-1] * ratio))
        if nxt <= out[-1]:
            nxt = out[-1] + 1
        if nxt >= max_budget:
            break
        out.append(nxt)
    if out[-1] != max_budget:
        out.append(max_budget)
    return tuple(out)
