from .ops import MAX_D, rmsnorm
from .ref import rmsnorm_ref

__all__ = ["MAX_D", "rmsnorm", "rmsnorm_ref"]
