from .ops import MAX_SERVERS, kw_chain, lindley_scan
from .ref import LindleyOut, kw_chain_ref, lindley_scan_ref

__all__ = ["MAX_SERVERS", "LindleyOut", "kw_chain", "kw_chain_ref",
           "lindley_scan", "lindley_scan_ref"]
