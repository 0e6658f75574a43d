"""Input shapes and config plumbing for the assigned architecture pool.

The four assigned input shapes (see the reproduction brief):

  train_4k     seq_len=4,096    global_batch=256   train_step
  prefill_32k  seq_len=32,768   global_batch=32    prefill_step (inference)
  decode_32k   seq_len=32,768   global_batch=128   serve_step: ONE new token
                                                   against a KV cache of 32k
  long_500k    seq_len=524,288  global_batch=1     serve_step with 500k state;
                                                   requires sub-quadratic
                                                   attention (window / SSM)

``long_context_window``: dense/attention archs run long_500k with a
sliding-window variant of this size (the sub-quadratic option required by the
brief); SSM/hybrid archs carry O(1)/O(window) state natively.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

LONG_CONTEXT_WINDOW = 8192


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
