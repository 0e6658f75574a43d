"""Wilson score confidence intervals for progressive-budget early stopping.

COMPASS-V (paper §IV-B, 'Progressive Evaluation') evaluates a configuration on
a growing number of dataset samples and classifies it as feasible only when the
Wilson lower bound exceeds the threshold tau, infeasible only when the upper
bound falls below it; borderline cases receive more samples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# two-sided z for common confidence levels (avoid scipy dependency)
_Z_TABLE = {
    0.80: 1.2815515655446004,
    0.90: 1.6448536269514722,
    0.95: 1.959963984540054,
    0.98: 2.3263478740408408,
    0.99: 2.5758293035489004,
}


def z_value(confidence: float) -> float:
    if confidence in _Z_TABLE:
        return _Z_TABLE[confidence]
    # rational approximation of the normal quantile (Acklam) for other levels
    p = 1.0 - (1.0 - confidence) / 2.0
    if not 0.0 < p < 1.0:
        raise ValueError(f"bad confidence {confidence}")
    # Peter Acklam's inverse normal CDF approximation
    a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
    b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        # lower region: Acklam's rational form in q = sqrt(-2 ln p) is
        # already negative (z < 0 for p < 0.5)
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        # upper region: mirror of the lower region, negated
        q = math.sqrt(-2 * math.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
        (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


@dataclass(frozen=True)
class WilsonInterval:
    center: float
    lower: float
    upper: float
    successes: float
    trials: int

    @property
    def width(self) -> float:
        return self.upper - self.lower


def wilson_interval(successes: float, trials: int, confidence: float = 0.95) -> WilsonInterval:
    """Wilson score interval for a binomial proportion.

    ``successes`` may be fractional — per-sample scores like F1 in [0, 1] are
    treated as partial successes, which keeps the interval a conservative
    uncertainty proxy for bounded scores (the paper evaluates F1/mAP with the
    same machinery).
    """
    if trials <= 0:
        return WilsonInterval(0.5, 0.0, 1.0, 0.0, 0)
    if not 0.0 <= successes <= trials + 1e-9:
        raise ValueError(f"successes {successes} out of range for {trials} trials")
    z = z_value(confidence)
    n = float(trials)
    p_hat = successes / n
    z2 = z * z
    denom = 1.0 + z2 / n
    center = (p_hat + z2 / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p_hat * (1 - p_hat) / n + z2 / (4 * n * n))
    return WilsonInterval(
        center=center,
        lower=max(0.0, center - half),
        upper=min(1.0, center + half),
        successes=successes,
        trials=trials,
    )


def classify(successes: float, trials: int, tau: float,
             confidence: float = 0.95) -> str:
    """Classify a configuration against threshold tau (paper §IV-B).

    Returns ``"feasible"`` when CI_lo > tau... the paper states lower bound
    *exceeds* tau; ``"infeasible"`` when CI_hi < tau; else ``"uncertain"``.
    """
    ci = wilson_interval(successes, trials, confidence)
    if ci.lower > tau:
        return "feasible"
    if ci.upper < tau:
        return "infeasible"
    return "uncertain"
