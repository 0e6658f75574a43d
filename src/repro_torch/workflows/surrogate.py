"""Calibrated surrogate workflow surfaces for the paper's two evaluations.

The paper's COMPASS-V experiments run on a RAG pipeline (SQuAD 2.0, LLaMA /
Gemma generators) and a YOLO detection cascade (COCO) — model checkpoints we
cannot ship in an offline container.  This module provides *surrogates*: the
exact configuration-space structure (§VI-B) with deterministic accuracy
surfaces calibrated to the paper's reported anchors (Table I F1 values, the
~0.86 F1 ceiling, feasible fractions spanning ~2 %..99 % across the tested
thresholds) plus per-sample stochastic outcomes so the Wilson-CI machinery is
exercised exactly as in the paper.

Per-sample scores are Beta-distributed with mean ``Acc(c)`` and fixed
concentration: the sample mean is an unbiased estimate of ``Acc(c)`` and the
Wilson interval (which assumes the *higher* Bernoulli variance) remains a
conservative confidence bound, matching how fractional F1 scores behave in
the real pipeline.

Every randomness source is a counter-hash of (config, sample index, seed) —
evaluation is fully deterministic and order-independent.
"""

from __future__ import annotations

import hashlib
import math
import random
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.space import Config, ConfigSpace, detection_paper_space, rag_paper_space

# --------------------------------------------------------------------------
# deterministic hashing helpers
# --------------------------------------------------------------------------


def _unit_hash(*key: object) -> float:
    """Deterministic uniform [0,1) from arbitrary keys."""
    h = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    (x,) = struct.unpack("<Q", h)
    return x / 2.0 ** 64


def _unit_hash_grid(key_prefix: Tuple,
                    sample_indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The two per-sample uniform streams ``_unit_hash(*key_prefix, i, 1)``
    and ``(*key_prefix, i, 2)``, batched.

    The expensive part of per-sample hashing is not blake2b — it is
    re-repr()ing the whole (name, tag, seed, config) prefix for every
    sample.  A Python tuple repr is the concatenation of its elements'
    reprs, so the prefix bytes are computed ONCE per config and only the
    ``, i, tag)`` suffix varies per sample; the digests are then
    bit-identical to calling :func:`_unit_hash` per sample (the property
    the surrogate's determinism tests pin down)."""
    base = repr(key_prefix)[:-1].encode()    # "(name, 'acc', seed, config"
    n = len(sample_indices)
    u1 = np.empty(n, dtype=float)
    u2 = np.empty(n, dtype=float)
    blake = hashlib.blake2b
    unpack = struct.unpack
    for j, i in enumerate(sample_indices):
        mid = base + (", %d, " % i).encode()
        (x1,) = unpack("<Q", blake(mid + b"1)", digest_size=8).digest())
        (x2,) = unpack("<Q", blake(mid + b"2)", digest_size=8).digest())
        u1[j] = x1
        u2[j] = x2
    # division by 2**64 is an exact exponent shift, so converting the
    # uint64 to float64 first rounds identically to Python's int / 2.0**64
    u1 /= 2.0 ** 64
    u2 /= 2.0 ** 64
    return u1, u2


def _box_muller(u1: np.ndarray, u2: np.ndarray) -> np.ndarray:
    """Vectorized Box-Muller, bit-identical to the scalar
    ``sqrt(-2 ln u1) cos(2 pi u2)``: sqrt/cos match libm exactly; np.log
    differs from math.log by 1 ulp on this platform, so the log stays
    scalar (it is a tiny fraction of the former per-sample cost)."""
    logs = np.array([math.log(x) for x in np.maximum(u1, 1e-12)], dtype=float)
    return np.sqrt(-2.0 * logs) * np.cos((2 * math.pi) * u2)


def _beta_sample(mean: float, concentration: float, u1: float, u2: float) -> float:
    """Beta(mean*k, (1-mean)*k) sample via two uniforms (Johnk/gamma-free
    approximation: use inverse-CDF of a normal moment-matched then clip —
    adequate because only mean/variance matter to the estimator)."""
    mean = min(max(mean, 1e-4), 1 - 1e-4)
    var = mean * (1 - mean) / (1.0 + concentration)
    # Box-Muller from the two uniforms
    z = math.sqrt(-2.0 * math.log(max(u1, 1e-12))) * math.cos(2 * math.pi * u2)
    return min(1.0, max(0.0, mean + math.sqrt(var) * z))


# --------------------------------------------------------------------------
# RAG surrogate (paper §VI-B, Fig. 1/3/4, Table I)
# --------------------------------------------------------------------------

# generator F1 ceiling (perfect retrieval); the effective F1 is
# ceiling x retrieval-quality factor — retrieval and generation multiply,
# they do not add (a weak generator cannot exploit perfect context and a
# strong generator is throttled by bad context), which is also why
# per-component independent selection fails for compound workflows.
_GEN_CEIL = {
    "llama3-1b": 0.38,
    "llama3-3b": 0.80,
    "llama3-8b": 0.86,
    "gemma3-1b": 0.47,
    "gemma3-4b": 0.825,
    "gemma3-12b": 0.88,
}
# retrieval recall as a function of k (saturating, then noise at k=50)
_RET_RECALL = {3: 0.78, 5: 0.86, 10: 0.91, 20: 0.94, 50: 0.92}
# reranker quality x rerank-depth modulation (adds precision on top of recall)
_RERANK_QUALITY = {"ms-marco": 0.015, "bge-base": 0.030, "bge-v2": 0.045}
_RERANK_DEPTH = {1: 0.5, 3: 1.0, 5: 1.1, 10: 1.05}

# generator latency anchors (seconds, RTX-4090-like; Table I calibration —
# chosen so the Fast config's P95 lands near 200 ms and stays stable under
# the paper's 4x spike of the 1.5 QPS base load, and Accurate's P95 near
# 650-700 ms)
_GEN_COST_S = {
    "llama3-1b": 0.050,
    "llama3-3b": 0.095,
    "llama3-8b": 0.210,
    "gemma3-1b": 0.055,
    "gemma3-4b": 0.130,
    "gemma3-12b": 0.330,
}
_RERANK_COST_PER_DOC_S = {"ms-marco": 0.0008, "bge-base": 0.0015, "bge-v2": 0.0025}


@dataclass
class SurrogateWorkflow:
    """A surrogate surface: accuracy + latency models over a ConfigSpace."""

    name: str
    space: ConfigSpace
    concentration: float = 8.0
    seed: int = 0

    def accuracy(self, config: Config) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def mean_latency_s(self, config: Config) -> float:  # pragma: no cover
        raise NotImplementedError

    def latency_cv(self, config: Config) -> float:
        """Coefficient of variation of service time (LLM-ish tails)."""
        return 0.25

    # ---- per-sample evaluation (SampleEvaluator protocol) -----------------

    def evaluate_samples(self, config: Config, sample_indices: Sequence[int]) -> List[float]:
        """Batched numpy scoring: one hash-prefix + one vectorized
        Box-Muller/Beta transform per call, bit-identical to the historical
        per-sample loop (``_beta_sample`` over ``_unit_hash`` pairs)."""
        acc = self.accuracy(config)
        indices = list(sample_indices)
        if not indices:
            return []
        u1, u2 = _unit_hash_grid((self.name, "acc", self.seed, config), indices)
        z = _box_muller(u1, u2)
        mean = min(max(acc, 1e-4), 1 - 1e-4)
        var = mean * (1 - mean) / (1.0 + self.concentration)
        vals = np.minimum(1.0, np.maximum(0.0, mean + math.sqrt(var) * z))
        return vals.tolist()

    __call__ = evaluate_samples

    # ---- latency profiling (LatencyProfiler protocol) ----------------------

    def profile_latency(self, config: Config, num_samples: int) -> List[float]:
        """Batched numpy profiling — same lognormal stream as the historical
        per-sample loop, bit-for-bit (the exp stays scalar for libm parity,
        see :func:`_box_muller`)."""
        mean = self.mean_latency_s(config)
        cv = self.latency_cv(config)
        sigma = math.sqrt(math.log(1.0 + cv * cv))
        mu = math.log(mean) - sigma * sigma / 2.0
        if num_samples <= 0:
            return []
        u1, u2 = _unit_hash_grid((self.name, "lat", self.seed, config),
                                 list(range(num_samples)))
        z = _box_muller(u1, u2)
        return [math.exp(v) for v in mu + sigma * z]


class RagSurrogate(SurrogateWorkflow):
    """Surrogate of the paper's RAG pipeline (6 generators x 5 k x 4
    rerank-k x 3 rerankers).  Anchors (Table I):

      Fast     (llama3-3b, ms-marco, k=20, rk=1) -> F1 ~0.761, ~200 ms p95
      Medium   (llama3-8b, ms-marco, k=10, rk=3) -> F1 ~0.825, ~450 ms p95
      Accurate (gemma3-12b, bge-v2,  k=20, rk=3) -> F1 ~0.853, ~700 ms p95
    """

    def __init__(self, *, seed: int = 0):
        super().__init__(name="rag-surrogate", space=rag_paper_space(), seed=seed)

    def accuracy(self, config: Config) -> float:
        d = self.space.as_dict(config)
        gen, k, rk, rr = d["generator"], d["retriever_k"], d["rerank_k"], d["reranker"]
        eff_rk = min(rk, k)  # reranking deeper than retrieval is a no-op
        ret_factor = min(
            0.995, _RET_RECALL[k] + _RERANK_QUALITY[rr] * _RERANK_DEPTH[eff_rk]
        )
        acc = _GEN_CEIL[gen] * ret_factor
        # deterministic config-level ruggedness (real surfaces are not
        # perfectly smooth); +-0.006
        acc += (_unit_hash(self.name, "rugged", config) - 0.5) * 0.012
        return min(max(acc, 0.0), 1.0)

    def stage_latencies_s(self, config: Config) -> Dict[str, float]:
        """Per-stage mean service decomposition of the RAG pipeline —
        the stage view :mod:`repro.serving.dag` builds tandem workflow
        scenarios from.  Keys follow the pipeline order: ``retrieve`` ->
        ``rerank`` -> ``generate``; their sum is :meth:`mean_latency_s`
        exactly."""
        d = self.space.as_dict(config)
        gen, k, rk, rr = d["generator"], d["retriever_k"], d["rerank_k"], d["reranker"]
        eff_rk = min(rk, k)
        return {
            "retrieve": 0.004 + 0.0002 * k,            # vector search
            "rerank": _RERANK_COST_PER_DOC_S[rr] * k,  # score k docs
            # longer grounded prompts slow generation roughly linearly in rk
            "generate": _GEN_COST_S[gen] * (1.0 + 0.06 * eff_rk),
        }

    def mean_latency_s(self, config: Config) -> float:
        return sum(self.stage_latencies_s(config).values())


# --------------------------------------------------------------------------
# Detection-cascade surrogate (paper §VI-B: YOLO detector + verifier)
# --------------------------------------------------------------------------

_DET_BASE = {"yolov8n": 0.46, "yolov8s": 0.61, "yolov8m": 0.72}
_VER_GAIN = {"none": 0.0, "yolov8m": 0.055, "yolov8l": 0.085, "yolov8x": 0.105}
_DET_COST_S = {"yolov8n": 0.006, "yolov8s": 0.011, "yolov8m": 0.022}
_VER_COST_S = {"none": 0.0, "yolov8m": 0.022, "yolov8l": 0.038, "yolov8x": 0.062}


class DetectionSurrogate(SurrogateWorkflow):
    """Surrogate of the detection cascade: lightweight detector on every
    image; predictions below the confidence threshold go to the verifier.

    Higher confidence threshold -> more images forwarded -> higher mAP (the
    verifier fixes borderline cases) and higher latency.  NMS threshold has a
    concave optimum around 0.5 (COCO-typical)."""

    def __init__(self, *, seed: int = 0):
        super().__init__(name="det-surrogate", space=detection_paper_space(), seed=seed)

    def _forward_fraction(self, conf: float) -> float:
        """Fraction of images whose detector confidence falls below the
        threshold (forwarded to verifier).  Monotone in conf."""
        return min(1.0, 0.15 + 1.3 * (conf - 0.1))

    def accuracy(self, config: Config) -> float:
        d = self.space.as_dict(config)
        det, ver, conf, nms = d["detector"], d["verifier"], d["confidence"], d["nms"]
        fwd = self._forward_fraction(conf) if ver != "none" else 0.0
        # verifier only helps on forwarded (hard) cases, saturating
        gain = _VER_GAIN[ver] * math.sqrt(fwd)
        # NMS: concave, peak at 0.5
        nms_pen = -0.35 * (nms - 0.5) ** 2
        acc = _DET_BASE[det] + gain + nms_pen
        # over-eager forwarding with a same-size verifier slightly hurts
        if ver == "yolov8m" and det == "yolov8m":
            acc -= 0.02
        acc += (_unit_hash(self.name, "rugged", config) - 0.5) * 0.010
        return min(max(acc, 0.0), 1.0)

    def mean_latency_s(self, config: Config) -> float:
        d = self.space.as_dict(config)
        det, ver, conf = d["detector"], d["verifier"], d["confidence"]
        fwd = self._forward_fraction(conf) if ver != "none" else 0.0
        return 0.002 + _DET_COST_S[det] + _VER_COST_S[ver] * fwd

    def latency_cv(self, config: Config) -> float:
        return 0.12  # traditional ML components: predictable service times


def paper_rag_thresholds() -> List[float]:
    """The 8 RAG accuracy SLOs of §VI-B (0.30 .. 0.90)."""
    return [0.30, 0.50, 0.60, 0.70, 0.75, 0.80, 0.85, 0.90]


def paper_detection_thresholds() -> List[float]:
    """The 8 detection accuracy SLOs of §VI-B (0.55 .. 0.80)."""
    return [0.55, 0.60, 0.64, 0.68, 0.70, 0.73, 0.76, 0.80]
