"""Small shared utilities for the host-side pipeline.

Port of orb_slam2_tpu/utils.py: the framework-free helpers, copied, and
`fetch_async` over `HostCopy`.  The JAX-specific ones
(`setup_compile_cache`, `ensure_live_backend`) have no counterpart here.
In this package the bucket sizes bound the number of CUDA graphs a step
captures (one per shape), as they bound XLA recompiles there.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


# A CUDA graph is captured in the global error mode: a cudaMalloc, a
# synchronisation or a launch on the default stream from ANOTHER thread
# fails the capture.  Every capture (slam/track_step.py) holds this lock,
# and so does each pass of the mapping thread (LocalMapper.process_one),
# the only other thread that uses the device: a capture waits for the pass
# in flight, and the mapper for the capture.  Re-entrant, because the sync
# scheduler runs the mapper on the tracking thread.
DEVICE_CAPTURE_LOCK = threading.RLock()


def torch_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" -> "cuda:0").
    Raises on a CUDA device when no card is present: nothing that asks
    for the card carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() "
                "is false")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class HostCopy:
    """A device tensor's copy into host memory, started without blocking.

    On a CUDA tensor the copy goes into pinned memory with
    `non_blocking=True` and an event is recorded behind it; `numpy()`
    waits for that event only, never for the whole device.  A CPU tensor
    is its own host copy."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t.detach()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def numpy(self) -> np.ndarray:
        self.wait()
        return self.host.numpy()


def fetch_async(tree) -> None:
    """Wait for every `HostCopy` in `tree` (nested lists, tuples and
    dicts; anything else is skipped).  The copies were started when the
    results were dispatched, so this waits for the device work behind
    them and nothing more."""
    if isinstance(tree, HostCopy):
        tree.wait()
    elif isinstance(tree, dict):
        for v in tree.values():
            fetch_async(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            fetch_async(v)


def upload(a, device) -> torch.Tensor:
    """A host array (or number) as a tensor on `device`: uint32
    descriptor words as their int32 bits, float64 as float32."""
    a = np.asarray(a)
    if a.ndim:
        a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def take_row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def to_numpy(x) -> np.ndarray:
    """numpy array of a HostCopy (waiting for it), a tensor or an array."""
    if isinstance(x, HostCopy):
        return x.numpy()
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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

    def add(self, name: str, dt: float) -> None:
        """One sample of a span that did not run inside a `with`."""
        self.totals[name] += dt
        self.counts[name] += 1
        self.samples[name].append(dt)

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
