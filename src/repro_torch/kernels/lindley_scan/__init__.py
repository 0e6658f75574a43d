from .ops import MAX_SERVERS, lindley_scan
from .ref import LindleyOut, lindley_scan_ref

__all__ = ["MAX_SERVERS", "LindleyOut", "lindley_scan", "lindley_scan_ref"]
