"""Configuration-space machinery for Compound AI workflows (paper §II-A, §IV).

A *configuration* is one complete assignment of values to every exposed
component parameter (Eq. 1): ``c = (p_1, ..., p_n), p_i in P_i``.  The space
``C = P_1 x ... x P_n`` is finite and combinatorial.  Parameters are
heterogeneous (categorical / discrete-ordinal / continuous-discretized), so the
space is non-differentiable; COMPASS-V navigates it with estimated gradients
over a normalized [0, 1]^n embedding (paper Eq. 3).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Sequence, Tuple

Config = Tuple[Any, ...]


@dataclass(frozen=True)
class Parameter:
    """A single adjustable component parameter.

    ``kind`` distinguishes how values embed into [0, 1] for distance /
    gradient computation:

    - ``ordinal``: values have a meaningful order (retrieval-k, thresholds,
      model-size ladders).  Value i embeds at ``i / (m - 1)``.
    - ``categorical``: unordered (e.g. reranker family).  Values still embed
      on the index grid — the paper normalizes *all* parameters to [0, 1] to
      enable distance computation across heterogeneous types (§IV-B) — but
      gradient steps across categorical axes are treated as exploratory.
    """

    name: str
    values: Tuple[Any, ...]
    kind: str = "ordinal"  # "ordinal" | "categorical"

    def __post_init__(self) -> None:
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has no values")
        if self.kind not in ("ordinal", "categorical"):
            raise ValueError(f"unknown parameter kind {self.kind!r}")
        if len(set(map(repr, self.values))) != len(self.values):
            raise ValueError(f"parameter {self.name!r} has duplicate values")
        # value -> index lookup table (the dataclass is frozen, hence the
        # object.__setattr__); index_of() used to linear-scan the tuple and
        # was the inner loop of every distance/gradient computation.
        try:
            lookup = {v: i for i, v in enumerate(self.values)}
            if len(lookup) != len(self.values):   # e.g. 1 vs True collide
                lookup = None
        except TypeError:        # unhashable values: fall back to scanning
            lookup = None
        object.__setattr__(self, "_lookup", lookup)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def index_of(self, value: Any) -> int:
        lookup = self._lookup
        if lookup is not None:
            try:
                return lookup[value]
            except KeyError:
                raise KeyError(f"{value!r} not a valid value for {self.name!r}")
        try:
            return self.values.index(value)
        except ValueError:
            raise KeyError(f"{value!r} not a valid value for {self.name!r}")

    def normalized(self, value: Any) -> float:
        """Embed a value into [0, 1] (paper: 'all parameters are normalized
        to [0,1] to enable distance computation across heterogeneous types')."""
        if self.cardinality == 1:
            return 0.0
        return self.index_of(value) / (self.cardinality - 1)


class ConfigSpace:
    """Finite product space of component parameters with adjacency structure.

    Two configurations are *adjacent* iff they differ in exactly one parameter
    value (paper §IV-C) — for ordinal parameters we additionally require the
    differing indices to be neighbors on the value ladder, which matches how
    lateral expansion / hill-climbing actually move; categorical axes connect
    all value pairs.
    """

    def __init__(self, parameters: Sequence[Parameter]):
        if not parameters:
            raise ValueError("empty configuration space")
        names = [p.name for p in parameters]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")
        self.parameters: Tuple[Parameter, ...] = tuple(parameters)
        self._index = {p.name: i for i, p in enumerate(self.parameters)}
        # memoized [0,1]^n embeddings: COMPASS-V's gradient estimator
        # normalizes the same configurations thousands of times per search
        # (the space is finite, so the memo is bounded by |C|).
        self._norm_cache: Dict[Config, Tuple[float, ...]] = {}

    # -- basic structure ----------------------------------------------------

    @property
    def num_parameters(self) -> int:
        return len(self.parameters)

    @property
    def cardinality(self) -> int:
        n = 1
        for p in self.parameters:
            n *= p.cardinality
        return n

    def axis(self, name: str) -> int:
        return self._index[name]

    def validate(self, config: Config) -> None:
        if len(config) != self.num_parameters:
            raise ValueError(
                f"config arity {len(config)} != space arity {self.num_parameters}"
            )
        for p, v in zip(self.parameters, config):
            p.index_of(v)

    def as_dict(self, config: Config) -> Dict[str, Any]:
        return {p.name: v for p, v in zip(self.parameters, config)}

    def from_dict(self, d: Dict[str, Any]) -> Config:
        return tuple(d[p.name] for p in self.parameters)

    def indices(self, config: Config) -> Tuple[int, ...]:
        return tuple(p.index_of(v) for p, v in zip(self.parameters, config))

    def from_indices(self, idx: Sequence[int]) -> Config:
        return tuple(p.values[i] for p, i in zip(self.parameters, idx))

    def enumerate(self) -> Iterator[Config]:
        """Exhaustive grid enumeration (ground-truth baseline in §VI-B)."""
        for combo in itertools.product(*(p.values for p in self.parameters)):
            yield combo

    # -- geometry -----------------------------------------------------------

    def normalize(self, config: Config) -> Tuple[float, ...]:
        cached = self._norm_cache.get(config)
        if cached is None:
            cached = tuple(
                p.normalized(v) for p, v in zip(self.parameters, config))
            self._norm_cache[config] = cached
        return cached

    def distance(self, a: Config, b: Config) -> float:
        """Euclidean distance in the normalized embedding."""
        na, nb = self.normalize(a), self.normalize(b)
        return math.sqrt(sum((x - y) ** 2 for x, y in zip(na, nb)))

    def neighbors(self, config: Config) -> List[Config]:
        """All configurations adjacent to ``config`` (differ in one axis)."""
        out: List[Config] = []
        idx = self.indices(config)
        for ax, p in enumerate(self.parameters):
            i = idx[ax]
            if p.kind == "ordinal":
                steps = [i - 1, i + 1]
            else:  # categorical: all other values are one hop away
                steps = [j for j in range(p.cardinality) if j != i]
            for j in steps:
                if 0 <= j < p.cardinality:
                    nxt = list(idx)
                    nxt[ax] = j
                    out.append(self.from_indices(nxt))
        return out

    def neighbors_on_axis(self, config: Config, axis: int) -> List[Config]:
        p = self.parameters[axis]
        idx = self.indices(config)
        i = idx[axis]
        if p.kind == "ordinal":
            steps = [i - 1, i + 1]
        else:
            steps = [j for j in range(p.cardinality) if j != i]
        out = []
        for j in steps:
            if 0 <= j < p.cardinality:
                nxt = list(idx)
                nxt[axis] = j
                out.append(self.from_indices(nxt))
        return out

    def step_on_axis(self, config: Config, axis: int, direction: int) -> Config | None:
        """Move one ladder step along ``axis`` in ``direction`` (+1 / -1)."""
        idx = list(self.indices(config))
        j = idx[axis] + (1 if direction > 0 else -1)
        if not (0 <= j < self.parameters[axis].cardinality):
            return None
        idx[axis] = j
        return self.from_indices(idx)

    # -- sampling -----------------------------------------------------------

    def lhs_sample(self, n: int, *, seed: int = 0) -> List[Config]:
        """Latin Hypercube Sampling over the discrete grid (paper §IV-B,
        'Initialization'; McKay et al. [21]).

        Each axis is stratified into ``n`` intervals; one sample lands in each
        stratum per axis, strata are permuted independently per axis, and the
        continuous LHS points are snapped to the nearest grid value.
        Duplicates after snapping are deduplicated and topped up with fresh
        draws so that ``min(n, |C|)`` distinct configurations are returned.
        """
        import random as _random

        rng = _random.Random(seed)
        n = max(1, n)
        cols: List[List[float]] = []
        for _ in self.parameters:
            perm = list(range(n))
            rng.shuffle(perm)
            cols.append([(k + rng.random()) / n for k in perm])
        seen: Dict[Config, None] = {}
        for row in range(n):
            idx = []
            for ax, p in enumerate(self.parameters):
                u = cols[ax][row]
                idx.append(min(p.cardinality - 1, int(u * p.cardinality)))
            seen.setdefault(self.from_indices(idx), None)
        # top-up to n distinct samples (or the whole space if smaller)
        target = min(n, self.cardinality)
        guard = 0
        while len(seen) < target and guard < 50 * target:
            idx = [rng.randrange(p.cardinality) for p in self.parameters]
            seen.setdefault(self.from_indices(idx), None)
            guard += 1
        return list(seen.keys())


def rag_paper_space() -> ConfigSpace:
    """The paper's RAG configuration space (§VI-B): 6 generators x 5
    retriever-k x 4 reranker-k x 3 rerankers ... the paper quotes 234 usable
    configurations out of the 360-cell grid (some (k, rerank-k) combos are
    invalid because rerank-k must not exceed retrieval k — with ladder values
    below, 234 = 6 x 3 x 13 valid (k, rk) pairs).  We keep the full grid here
    and expose the validity predicate separately."""
    return ConfigSpace(
        [
            Parameter(
                "generator",
                ("llama3-1b", "llama3-3b", "llama3-8b", "gemma3-1b", "gemma3-4b", "gemma3-12b"),
                kind="ordinal",  # ladder by size within family; see surrogate for the accuracy model
            ),
            Parameter("retriever_k", (3, 5, 10, 20, 50), kind="ordinal"),
            Parameter("rerank_k", (1, 3, 5, 10), kind="ordinal"),
            Parameter("reranker", ("bge-v2", "bge-base", "ms-marco"), kind="categorical"),
        ]
    )


def detection_paper_space() -> ConfigSpace:
    """The paper's object-detection cascade space (§VI-B): 3 detectors x 4
    verifiers (incl. none) x 7 confidence thresholds x 5 NMS thresholds ...
    the paper quotes 385 configurations (the 'none' verifier collapses the
    confidence-threshold axis: 3*3*7*5 + 3*1*5)."""
    return ConfigSpace(
        [
            Parameter("detector", ("yolov8n", "yolov8s", "yolov8m"), kind="ordinal"),
            Parameter("verifier", ("none", "yolov8m", "yolov8l", "yolov8x"), kind="ordinal"),
            Parameter("confidence", (0.1, 0.1667, 0.2333, 0.3, 0.3667, 0.4333, 0.5), kind="ordinal"),
            Parameter("nms", (0.3, 0.4, 0.5, 0.6, 0.7), kind="ordinal"),
        ]
    )
