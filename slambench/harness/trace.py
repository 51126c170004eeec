"""The profiled sub-window of a `--trace 1` run, read from the device trace.

`torch.profiler` (CUPTI) records every kernel of a named run of
consecutive frames; the whole window would be millions of graph-node
events, and CUPTI slows the host's launches, so only the sub-window is
traced and the end-to-end metrics come from `--trace 0` runs.  What is
read here: the device's busy seconds inside the sub-window (the union of
all device operations), the device time and launches of each kernel by
name, the device time of the kernels that CUDA-graph replays launched,
the top device operations, and the device's idle gaps labelled by what
the tracking thread was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW_EVENT = "slambench.window"
KERNELS = {"fast": "fast_levels_kernel",
           "orb": "orb_describe_levels_kernel",
           "stereo": "stereo_refine_kernel"}


class SubWindow:
    """start() / stop() around the profiled frames."""

    def __init__(self):
        self.prof = None
        self.rf = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW_EVENT)
        self.rf.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(sub: SubWindow) -> dict:
    """The sub-window's device figures (seconds unless named otherwise)."""
    events = sub.prof.profiler.kineto_results.events()
    cpu, dev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append(e)
        elif not (e.is_user_annotation() or e.name().startswith("slambench.")):
            dev.append(e)              # not a host range mirrored on the card
    win = [e for e in cpu if e.name() == WINDOW_EVENT]
    if not win or not dev:
        return {}
    ws, we = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    main_tid = win[0].start_thread_id()
    runtime = {}
    for e in cpu:
        if e.name().startswith("cuda"):
            runtime[e.correlation_id()] = e.name()
    spans, by_name, launches = [], defaultdict(int), defaultdict(int)
    graph_ns = 0
    for e in dev:
        s = e.start_ns()
        t = s + e.duration_ns()
        if t <= ws or s >= we:
            continue
        s, t = max(s, ws), min(t, we)
        spans.append((s, t))
        by_name[e.name()] += t - s
        launches[e.name()] += 1
        api = runtime.get(e.correlation_id()) or runtime.get(
            e.linked_correlation_id(), "")
        if "GraphLaunch" in api:
            graph_ns += t - s
    replays = sum(1 for e in cpu if "GraphLaunch" in e.name()
                  and ws <= e.start_ns() < we)
    busy = _union(spans)
    busy_ns = sum(t - s for s, t in busy)
    kernels = {}
    for key, kname in KERNELS.items():
        names = [n for n in by_name if kname in n]
        kernels[key] = {"device_s": sum(by_name[n] for n in names) * 1e-9,
                        "launches": sum(launches[n] for n in names)}
    return {
        "window_s": (we - ws) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "graph_replays": replays,
        "graph_device_s": graph_ns * 1e-9,
        "kernels": kernels,
        "device_ops": sorted(([n, v * 1e-9] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": _idle_gaps(busy, ws, we, cpu, main_tid),
        "device_events": len(spans),
    }


def _idle_gaps(busy, ws, we, cpu, tid, small_ns: int = 50_000) -> list:
    """The device's idle time in the sub-window, the ten largest sums by
    what the tracking thread was doing in the middle of each gap: the
    harness's step (`call`, `pace`) and its innermost host event there.
    Gaps under 50 us (between the kernels of one replay, mostly) are
    summed as one entry."""
    edges = [ws] + [x for seg in busy for x in seg] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mine = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in cpu if e.start_thread_id() == tid
                  and e.name() != WINDOW_EVENT)
    steps = [m for m in mine if m[2].startswith("slambench.")]
    starts = [m[0] for m in mine]
    step_starts = [m[0] for m in steps]

    def innermost(events, starts_, mid, reach):
        j = bisect.bisect_right(starts_, mid)
        found, width = None, None
        for a, b, n in events[max(j - reach, 0):j]:
            if b >= mid and (width is None or b - a < width):
                found, width = n, b - a
        return found

    total = defaultdict(int)
    for s, t in gaps:
        if t - s < small_ns:
            total["gaps under 50 us"] += t - s
            continue
        mid = (s + t) // 2
        step = innermost(steps, step_starts, mid, 4)
        inner = innermost(mine, starts, mid, 400)
        step = step[len("slambench."):] if step else "host"
        total[f"{step}: {inner}" if inner and not inner.startswith(
            "slambench.") else step] += t - s
    return sorted(([n, v * 1e-9] for n, v in total.items()),
                  key=lambda x: -x[1])[:10]
