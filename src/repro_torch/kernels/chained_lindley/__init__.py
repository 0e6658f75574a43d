from .ops import MAX_STAGES, chained_lindley_scan
from .ref import chained_lindley_scan_ref

__all__ = ["MAX_STAGES", "chained_lindley_scan", "chained_lindley_scan_ref"]
