"""Halton low-discrepancy sequence (host side, for sub-pixel jitter in
progressive accumulation)."""

from __future__ import annotations


def halton(i: int, b: int) -> float:
    """i-th element (1-based) of the base-b Halton sequence in [0, 1)."""
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r
