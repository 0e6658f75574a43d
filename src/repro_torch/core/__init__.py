"""Compass core: the paper's contribution as composable modules.

- :mod:`repro.core.space` — compound-AI configuration spaces (§II-A).
- :mod:`repro.core.wilson` / :mod:`repro.core.evaluate` — progressive
  budgeting with Wilson-CI early stopping (§IV-B).
- :mod:`repro.core.gradient` — IDW finite-difference gradients (Eq. 3).
- :mod:`repro.core.compass_v` — Algorithm 1 feasible-set search (§IV).
- :mod:`repro.core.pareto` — accuracy/latency Pareto front (§III-A).
- :mod:`repro.core.aqm` — M/G/c switching thresholds, Erlang-C and
  Allen-Cunneen wait models, heterogeneous mix policies (§V + beyond).
- :mod:`repro.core.planner` — deployment planning (§III-A).
- :mod:`repro.core.elastico` — runtime adaptation controllers (§III-B, §V-F).
"""

from .aqm import (
    AQMPolicyTable,
    HysteresisSpec,
    MixPolicy,
    MixPolicyTable,
    SwitchingPolicy,
    allen_cunneen_mean_wait,
    derive_mix_policies,
    derive_policies,
    erlang_c,
    erlang_c_mean_wait,
    ladder_is_monotone,
    mix_ladder,
    mix_ladder_is_monotone,
    mix_mean_wait,
)
from .compass_v import CompassV, SearchResult, exhaustive_search
from .elastico import ElasticoController, ElasticoMixController, SwitchEvent
from .evaluate import ProgressiveEvaluator, make_budget_schedule
from .gradient import idw_gradient
from .pareto import LatencyProfile, ParetoPoint, pareto_front
from .planner import DeploymentPlan, Planner, summarize_latencies
from .space import Config, ConfigSpace, Parameter
from .wilson import wilson_interval

__all__ = [
    "AQMPolicyTable",
    "HysteresisSpec",
    "MixPolicy",
    "MixPolicyTable",
    "SwitchingPolicy",
    "allen_cunneen_mean_wait",
    "derive_mix_policies",
    "derive_policies",
    "erlang_c",
    "erlang_c_mean_wait",
    "ladder_is_monotone",
    "mix_ladder",
    "mix_ladder_is_monotone",
    "mix_mean_wait",
    "CompassV",
    "SearchResult",
    "exhaustive_search",
    "ElasticoController",
    "ElasticoMixController",
    "SwitchEvent",
    "ProgressiveEvaluator",
    "make_budget_schedule",
    "idw_gradient",
    "LatencyProfile",
    "ParetoPoint",
    "pareto_front",
    "DeploymentPlan",
    "Planner",
    "summarize_latencies",
    "Config",
    "ConfigSpace",
    "Parameter",
    "wilson_interval",
]
