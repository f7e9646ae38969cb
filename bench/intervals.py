"""Interval arithmetic over spans, in seconds from the window's start."""

from __future__ import annotations


def union(spans) -> list[tuple[float, float]]:
    """Sorted, merged (start, end) intervals of `(…, start, end)` spans."""
    out: list[list[float]] = []
    for *_, t0, t1 in sorted(spans, key=lambda s: s[-2]):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def minus(a, b) -> float:
    """Length of merged intervals `a` outside merged intervals `b`."""
    total, j = 0.0, 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                total += b[k][0] - cur
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            total += e - cur
    return total
