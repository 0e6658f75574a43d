"""Carry a deployment plan across as plain data.

Compass has no weights: the state that crosses from the offline phase
(search and planning) to the runtime (Elastico) is the
:class:`~repro_torch.core.planner.DeploymentPlan` — the ladder's configs,
latency profiles, switching thresholds, ``num_servers``, ``slo_p95_s`` and
the degraded-capacity tables.  :func:`plan_to_numpy` flattens a plan into
Python numbers, strings, tuples and dicts tagged with their class names;
:func:`plan_from_numpy` rebuilds the port's plan from that data.  Neither
looks at which package built the plan, so a plan made by the JAX package
crosses into the port unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from .core.aqm import (
    AQMPolicyTable,
    HysteresisSpec,
    MixPolicy,
    MixPolicyTable,
    SwitchingPolicy,
)
from .core.pareto import BatchProfile, LatencyProfile, ParetoPoint
from .core.planner import DeploymentPlan

_TYPES: Dict[str, type] = {cls.__name__: cls for cls in (
    DeploymentPlan, AQMPolicyTable, SwitchingPolicy, HysteresisSpec,
    MixPolicyTable, MixPolicy, ParetoPoint, LatencyProfile, BatchProfile)}

_TYPE_KEY = "__type__"
_DICT_KEY = "__items__"


def plan_to_numpy(obj: Any) -> Any:
    """Flatten a plan (or any part of one) into plain data: a dataclass
    becomes a dict of its fields tagged ``__type__`` with its class name,
    a dict becomes ``{"__items__": ((key, value), ...)}`` (config tuples
    are keys), lists and tuples become tuples, numpy scalars Python ones."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _TYPES:
            raise TypeError(f"{name} is not part of a deployment plan")
        out = {_TYPE_KEY: name}
        for f in dataclasses.fields(obj):
            out[f.name] = plan_to_numpy(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {_DICT_KEY: tuple((plan_to_numpy(k), plan_to_numpy(v))
                                 for k, v in obj.items())}
    if isinstance(obj, (list, tuple)):
        return tuple(plan_to_numpy(x) for x in obj)
    if isinstance(obj, np.ndarray):
        return tuple(plan_to_numpy(x) for x in obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot carry {type(obj).__name__} across as plain "
                    f"data")


def _rebuild(d: Any) -> Any:
    if isinstance(d, dict):
        if _TYPE_KEY in d:
            cls = _TYPES.get(d[_TYPE_KEY])
            if cls is None:
                raise TypeError(f"unknown plan type {d[_TYPE_KEY]!r}")
            return cls(**{k: _rebuild(v) for k, v in d.items()
                          if k != _TYPE_KEY})
        if set(d) == {_DICT_KEY}:
            return {_rebuild(k): _rebuild(v) for k, v in d[_DICT_KEY]}
        raise ValueError(f"untagged dict in plan data: keys {sorted(d)}")
    if isinstance(d, (list, tuple)):
        return tuple(_rebuild(x) for x in d)
    if isinstance(d, np.ndarray):
        return tuple(_rebuild(x) for x in d.tolist())
    if isinstance(d, np.generic):
        return d.item()
    return d


def plan_from_numpy(d: Dict[str, Any]) -> DeploymentPlan:
    """The port's :class:`DeploymentPlan` from :func:`plan_to_numpy`'s
    plain data (numpy arrays and scalars are accepted where tuples and
    numbers are expected)."""
    plan = _rebuild(d)
    if not isinstance(plan, DeploymentPlan):
        raise TypeError(f"plan data describes a {type(plan).__name__}, "
                        f"not a DeploymentPlan")
    return plan
