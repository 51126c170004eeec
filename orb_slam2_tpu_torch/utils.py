"""Small shared utilities for the host-side pipeline.

Port of orb_slam2_tpu/utils.py: the framework-free helpers, copied, and
`fetch_async` over `HostCopy`.  The JAX-specific ones
(`setup_compile_cache`, `ensure_live_backend`) have no counterpart here.
In this package the bucket sizes bound the number of CUDA graphs a step
captures (one per shape), as they bound XLA recompiles there.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


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


# Span ids, unique across every StageTimers of the process, so a span of
# one component (a keyframe's pass on the mapping thread) can name a span
# of another (the frame that created it) as its parent.
_SPAN_IDS = itertools.count(1)


class _Open(threading.local):
    """Per thread: the spans open on it, innermost last, whatever
    StageTimers each belongs to."""

    def __init__(self):
        self.stack = []


_OPEN = _Open()
# A span's copy on a running profiler's trace: the profiler's own fast
# range (1.4 us a range under a CPU profiler, against record_function's
# 10.7).  It is recorded as a host op, not as a user annotation, so the
# trace holds no device-side copy of it that a reader would count as
# device time.
_mirror = _RecordFunctionFast
_get_ident = threading.get_ident


SPAN_FIELDS = ("span", "parent", "name", "id", "thread", "start_ns",
               "end_ns", "cpu_ns")


class StageTimers:
    """Per-stage wall-clock accumulation (SURVEY.md §5.1: the reference
    only times whole Track* calls in its drivers; we time every stage),
    and the spans behind it.

    `totals[name]` and `counts[name]` are the seconds and the number of
    the spans of each name since the timers were made.  Every span is
    also kept in a ring of the last `RING` (sized for 30 s of frames at
    about 25 spans a frame), as a tuple of SPAN_FIELDS: its own id,
    its parent's (the span open on the same thread when it began, or one
    named by the caller; 0 for none), its name, the id of the frame or
    keyframe it works for (inherited from the parent unless given; -1
    for none), the thread's ident, start and end in `perf_counter_ns`,
    and, for a span opened with `cpu=True` (pure host work), the
    thread's CPU ns over it (else -1): wall minus CPU is the time the
    thread was held off, mostly by the interpreter's lock.  Device spans
    (`record_stamps`) carry the thread "device" and the device's clock.
    `samples[name]` is the seconds of the spans of that name still in the
    ring.  `counters` holds plain counts and highs.

    While a torch profiler runs, and only then (one attribute read), each
    span is also a range `orb/<name>` of the profiler's trace (`_mirror`),
    which puts it on the device trace's clock."""

    RING = 8192

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, int] = defaultdict(int)
        self.ring: deque = deque(maxlen=self.RING)
        self.samples = _Samples(self.ring)

    class _Ctx:
        __slots__ = ("timers", "name", "id", "parent", "cpu", "sid", "t0",
                     "c0", "rf")

        def __init__(self, timers, name, id_, parent, cpu):
            self.timers, self.name, self.id = timers, name, id_
            self.parent, self.cpu = parent, cpu

        def __enter__(self):
            stack = _OPEN.stack
            if stack:
                up = stack[-1]
                if self.parent is None:
                    self.parent = up.sid
                if self.id is None:
                    self.id = up.id
            self.sid = next(_SPAN_IDS)
            stack.append(self)
            self.c0 = time.thread_time_ns() if self.cpu else 0
            self.rf = None
            if _profiler._is_profiler_enabled:
                self.rf = _mirror("orb/" + self.name)
                self.rf.__enter__()
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            t1 = time.perf_counter_ns()
            cpu = time.thread_time_ns() - self.c0 if self.cpu else -1
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            _OPEN.stack.pop()
            timers, name = self.timers, self.name
            timers.totals[name] += (t1 - self.t0) * 1e-9
            timers.counts[name] += 1
            timers.ring.append((self.sid, self.parent or 0, name,
                                -1 if self.id is None else self.id,
                                _get_ident(), self.t0, t1, cpu))
            return False

    def __call__(self, name: str, id: Optional[int] = None,
                 parent: Optional[int] = None,
                 cpu: bool = False) -> "StageTimers._Ctx":
        """A span around a `with` block.  `id` and `parent` default to the
        enclosing span's id and to that span."""
        return self._Ctx(self, name, id, parent, cpu)

    def record(self, name: str, start_ns: int, end_ns: int,
               id: Optional[int] = None, parent: Optional[int] = None,
               thread=None) -> None:
        """A span that did not run inside a `with` on this thread (a
        keyframe's wait in a queue, a device stage).  `id` and `parent`
        default to the innermost span open on this thread."""
        stack = _OPEN.stack
        if stack:
            if parent is None:
                parent = stack[-1].sid
            if id is None:
                id = stack[-1].id
        self.totals[name] += (end_ns - start_ns) * 1e-9
        self.counts[name] += 1
        self.ring.append((next(_SPAN_IDS), parent or 0, name,
                          -1 if id is None else id,
                          _get_ident() if thread is None else thread,
                          start_ns, end_ns, -1))

    def add(self, name: str, dt: float) -> None:
        """One sample of a span that did not run inside a `with`, ending
        now."""
        t1 = time.perf_counter_ns()
        self.record(name, t1 - int(dt * 1e9), t1)

    def record_stamps(self, stamps, names) -> None:
        """Device stages from a step's stamps (ns on the device's clock, or
        the host's on the CPU; a tensor or a list): span names[i] runs
        from stamps[i] to stamps[i + 1], under the innermost span open on
        this thread and its id.  One pass, as `record` would make them."""
        if stamps is None:
            return
        t = stamps.tolist() if isinstance(stamps, torch.Tensor) else stamps
        stack = _OPEN.stack
        parent, id_ = (stack[-1].sid, stack[-1].id) if stack else (0, None)
        id_ = -1 if id_ is None else id_
        totals, counts, ring = self.totals, self.counts, self.ring
        for i, name in enumerate(names):
            a, b = t[i], t[i + 1]
            totals[name] += (b - a) * 1e-9
            counts[name] += 1
            ring.append((next(_SPAN_IDS), parent, name, id_, "device", a, b,
                         -1))

    def locked(self, lock, name: str) -> "_Locked":
        """`with timers.locked(lock, name):` takes `lock` inside a span
        `name` (the wait) and holds it for the block."""
        return _Locked(self, lock, name)

    def current(self) -> int:
        """The id of the innermost span open on this thread (0: none)."""
        stack = _OPEN.stack
        return stack[-1].sid if stack else 0

    def spans(self) -> list:
        """The ring's spans, oldest first, as dicts of SPAN_FIELDS."""
        return [dict(zip(SPAN_FIELDS, s)) for s in list(self.ring)]

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


class _Locked:
    __slots__ = ("timers", "lock", "name")

    def __init__(self, timers, lock, name):
        self.timers, self.lock, self.name = timers, lock, name

    def __enter__(self):
        with self.timers(self.name):
            self.lock.acquire()
        return self

    def __exit__(self, *exc):
        self.lock.release()
        return False


class _Samples(Mapping):
    """`StageTimers.samples`: name -> the seconds of that name's spans
    still in the ring, oldest first ([] for a name it does not hold)."""

    def __init__(self, ring: deque):
        self._ring = ring

    def __getitem__(self, name: str) -> list:
        return [(s[6] - s[5]) * 1e-9 for s in list(self._ring)
                if s[2] == name]

    def __iter__(self):
        return iter(dict.fromkeys(s[2] for s in list(self._ring)))

    def __len__(self) -> int:
        return len(set(s[2] for s in list(self._ring)))
