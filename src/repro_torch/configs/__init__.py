"""Assigned-architecture configs.  Importing this package registers every
architecture with :mod:`repro.models.registry` (``--arch <id>`` lookup).

Pool (10 archs, 6 families):
  granite-moe-3b-a800m  deepseek-moe-16b  seamless-m4t-medium  paligemma-3b
  hymba-1.5b  stablelm-3b  internlm2-1.8b  llama3-405b  xlstm-1.3b
  minitron-4b
"""

from .base import INPUT_SHAPES, LONG_CONTEXT_WINDOW, InputShape

# importing registers each arch
from . import granite_moe_3b_a800m  # noqa: F401
from . import deepseek_moe_16b  # noqa: F401
from . import seamless_m4t_medium  # noqa: F401
from . import paligemma_3b  # noqa: F401
from . import hymba_1_5b  # noqa: F401
from . import stablelm_3b  # noqa: F401
from . import internlm2_1_8b  # noqa: F401
from . import llama3_405b  # noqa: F401
from . import xlstm_1_3b  # noqa: F401
from . import minitron_4b  # noqa: F401

__all__ = ["INPUT_SHAPES", "LONG_CONTEXT_WINDOW", "InputShape"]
