"""Replay records of kernel launches.

A wrapper with a ``record`` attribute (a dict, or None when off) notes each
launch under a key of its shapes and options: the inputs of the first
launch at that key and how many launches it took.  ``chip_smoke.py`` turns
recording on around the main path, then holds each kernel against its
plain version on exactly the inputs the path gave it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, Optional


def remember(record: Optional[Dict[Hashable, Dict[str, Any]]],
             key: Hashable, inputs: Callable[[], Any]) -> None:
    """Count a launch at ``key``; keep ``inputs()`` if it is the first."""
    if record is None:
        return
    entry = record.get(key)
    if entry is None:
        entry = record[key] = {"inputs": inputs(), "launches": 0}
    entry["launches"] += 1
