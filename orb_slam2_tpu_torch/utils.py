"""Small shared utilities for the host-side pipeline.

Copied from orb_slam2_tpu/utils.py: the framework-free helpers.  The
JAX-specific ones (`setup_compile_cache`, `ensure_live_backend`,
`fetch_async`) have no counterpart here.  In this package the bucket
sizes bound the number of CUDA graphs a step captures (one per shape),
as they bound XLA recompiles there.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict

import numpy as np


def bucket_size(n: int, minimum: int = 128) -> int:
    """Round up to a power of two (>= minimum) to bound the shapes a step
    sees, so each bucket is captured once."""
    b = minimum
    while b < n:
        b *= 2
    return b


class StickyBuckets:
    """Monotone bucket sizes: once a dimension has used a bucket, smaller
    requests reuse it.  Each named dimension therefore meets at most
    log2(max/min) new shapes over the whole run."""

    def __init__(self, **minimums: int):
        self._min = dict(minimums)
        self._cur: Dict[str, int] = {}

    def __call__(self, name: str, n: int) -> int:
        b = bucket_size(n, self._min.get(name, 128))
        b = max(b, self._cur.get(name, 0))
        self._cur[name] = b
        return b


def pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad (or truncate) axis 0 of `a` to length n with `fill`."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        return a[:n]
    pad_shape = (n - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])


class StageTimers:
    """Per-stage wall-clock accumulation (SURVEY.md §5.1: the reference
    only times whole Track* calls in its drivers; we time every stage)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.samples: Dict[str, list] = defaultdict(list)

    class _Ctx:
        def __init__(self, parent, name):
            self.parent, self.name = parent, name

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            self.parent.totals[self.name] += dt
            self.parent.counts[self.name] += 1
            self.parent.samples[self.name].append(dt)
            return False

    def __call__(self, name: str) -> "StageTimers._Ctx":
        return self._Ctx(self, name)

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals):
            n = self.counts[k]
            s = sorted(self.samples[k])
            med = s[len(s) // 2] if s else 0.0
            lines.append(
                f"{k:32s} total {self.totals[k]:8.3f}s  n={n:5d}  "
                f"median {med * 1e3:8.2f}ms"
            )
        return "\n".join(lines)
