"""Power-of-two shape bucketing shared by the encoder and the search paths.

Padding batch shapes to pow2 buckets keeps the set of distinct shapes a
kernel sees at O(log) sizes (cuBLAS heuristics, allocator blocks and the
score kernel's grid all key on them).
"""

from __future__ import annotations


def next_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor); ``floor`` must be a power of two."""
    p = floor
    while p < n:
        p *= 2
    return p
