"""Capacity bucketing, copied from the reference's ``core/table.py``.

Only ``next_capacity`` is ported so far: the graph's pow2-padded CSR
capacities come from it.  The table front end follows in a later slice.
"""

from __future__ import annotations

__all__ = ["next_capacity"]


def next_capacity(n: int, minimum: int = 8) -> int:
    """Bucket a length to the next power of two."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap *= 2
    return cap
