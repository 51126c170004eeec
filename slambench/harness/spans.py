"""Each frame's decomposition from the port's own spans, read over the
frames the profiler does not slow.

The port records its spans in every run (`orb_slam2_tpu_torch/utils.py`
`StageTimers`); `System.trace_snapshot()` returns them, with its counters,
as plain data: {"spans": {"tracker": [...], "mapper": [...], "loop":
[...]}, "counters": {...}}, each span a dict of `utils.SPAN_FIELDS`.  A
call of `System.track_*` is a root span `frame`; on the replayed path its
tree holds the tracking thread's lock waits (`track/lock_wait`),
`fast/prep`, `fast/dispatch` (`fast/upload`, `fast/launch`,
`fast/device_wait`), `fast/pull`, `fast/bind`, `fast/apply` (`create_keyframe`,
`track/local_map`), and the replay's device stages (`step/*`, from the
stamps the step writes inside the graph, on the device's clock).

`frames(snapshot, window)` gives one row a frame, in ms, for the frames
of a harness window outside its profiled sub-window (a frame is the
window's frame i when its span starts inside that frame's call, both
read on `time.perf_counter`); the five `*_ms` functions below read the
rows and return None when the spans are absent (a program without them).
`idle_by_span` labels the device's idle gaps of a profiled sub-window by
the port's spans.  Imports neither torch nor the port.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

# the replay's device stages, in order (slam/track_step.py STAGES)
STAGES = ("step/frontend", "step/match_last", "step/pose_lm1",
          "step/match_local", "step/pose_lm2", "step/pack")
LOCK = "track/lock_wait"
# the frame's parts on the replayed path, in the order they run, and the
# hand-over to the mapper's thread: the frame less their sum is the
# call's remainder (its entry, the step's lookup, the spans' own cost)
PARTS = (LOCK, "fast/prep", "fast/dispatch", "fast/pull", "fast/bind",
         "fast/apply", "system/pump")
# the host work in Python, timed with the thread's CPU clock too: wall -
# CPU is the time the thread was held off.  (The copies, the launch and
# the waits run in CUDA's driver; a CPU clock read costs ~4 us on the H100's
# host, so the spans read it where the interpreter runs.)
HOST_ONLY = ("fast/prep", "fast/bind", "fast/apply")


def _tree(spans: list) -> dict:
    kids = defaultdict(list)
    for s in spans:
        kids[s["parent"]].append(s)
    return kids


def _under(root: dict, kids: dict) -> list:
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(kids.get(s["span"], ()))
    return out


def _ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def frame_row(root: dict, kids: dict) -> dict:
    """One `frame` span's decomposition, ms: the sum of each span name in
    its tree, `frame` itself, and `host` (frame - device wait - lock
    waits), `blocked` (lock waits + wall - CPU of the host-only spans),
    `device` (the replay's stages) and `rest` (frame - PARTS)."""
    sums = defaultdict(float)
    blocked = 0.0
    for s in _under(root, kids):
        ms = _ms(s)
        sums[s["name"]] += ms
        if s["name"] in HOST_ONLY and s["cpu_ns"] >= 0:
            blocked += max(ms - s["cpu_ns"] * 1e-6, 0.0)
    row = dict(sums)
    row["blocked"] = sums[LOCK] + blocked
    row["host"] = sums["frame"] - sums["fast/device_wait"] - sums[LOCK]
    row["device"] = sum(sums[n] for n in STAGES)
    row["rest"] = sums["frame"] - sum(sums[n] for n in PARTS)
    row["id"] = root["id"]
    row["start_s"] = root["start_ns"] * 1e-9
    return row


def frames(snapshot, window=None, profiled: bool = False) -> list:
    """The rows of the replayed frames (those with a `fast/dispatch`):
    with a window, only its frames outside the profiled sub-window (or,
    `profiled=True`, inside it), each with its window index `i`."""
    if not snapshot:
        return []
    spans = snapshot["spans"]["tracker"]
    kids = _tree(spans)
    rows = [frame_row(s, kids) for s in spans if s["name"] == "frame"]
    rows = [r for r in rows if "fast/dispatch" in r]
    if window is None:
        return rows
    calls = [(f.offered, f.returned) for f in window.frames]
    starts = [c[0] for c in calls]
    inside = set(window.profiled)
    out = []
    for r in rows:
        i = bisect.bisect_right(starts, r["start_s"]) - 1
        if i < 0 or r["start_s"] > calls[i][1]:
            continue
        if (i in inside) == profiled:
            out.append(dict(r, i=i))
    return out


def _median(rows: list, key) -> float | None:
    xs = [key(r) for r in rows]
    return statistics.median(xs) if xs else None


def launch_ms_p50(rows: list) -> float | None:
    """Median host ms of `fast/launch`: the cudaGraphLaunch."""
    return _median([r for r in rows if "fast/launch" in r],
                   lambda r: r["fast/launch"])


def frontend_device_ms(rows: list) -> float | None:
    """Median device ms of `step/frontend` a replay."""
    return _median([r for r in rows if STAGES[0] in r],
                   lambda r: r[STAGES[0]])


def pose_lm_device_ms(rows: list) -> float | None:
    """Median device ms of the two pose LMs a replay."""
    return _median([r for r in rows if "step/pose_lm1" in r],
                   lambda r: r["step/pose_lm1"] + r["step/pose_lm2"])


def host_ms_p50(rows: list) -> float | None:
    """Median a frame of frame - device wait - lock waits: the host work
    the pose waits on."""
    return _median(rows, lambda r: r["host"])


def blocked_ms_per_frame(rows: list) -> float | None:
    """Mean a frame of lock waits + (wall - CPU) of the host-only spans."""
    return statistics.fmean(r["blocked"] for r in rows) if rows else None


METRICS = {
    "track_step.launch_ms_p50": launch_ms_p50,
    "track_step.frontend_device_ms": frontend_device_ms,
    "track_step.pose_lm_device_ms": pose_lm_device_ms,
    "tracker.host_ms_p50": host_ms_p50,
    "tracker.blocked_ms_per_frame": blocked_ms_per_frame,
}


def summary(rows: list) -> dict:
    """The five metrics and the median of every part of the rows."""
    out = {name: fn(rows) for name, fn in METRICS.items()}
    keys = sorted({k for r in rows for k in r} - {"id", "start_s", "i"})
    out["frames"] = len(rows)
    out["median_ms"] = {k: statistics.median(r.get(k, 0.0) for r in rows)
                        for k in keys}
    return out


# ---- the profiled sub-window ----------------------------------------------

def clock_offset_ns(events: list, spans: list, coarse_ns: int) -> int | None:
    """trace clock - perf_counter_ns: the median, over the trace's
    `orb/<name>` events, of each event's start less that of the ring span
    of the same name that starts nearest it.  events: (start_ns, end_ns,
    name) on the trace's clock; coarse_ns: a first guess within a few ms
    (`time.time_ns() - time.perf_counter_ns()`: the profiler's clock is
    Unix time)."""
    ring = defaultdict(list)
    for s in spans:
        if s["thread"] != "device":
            ring["orb/" + s["name"]].append(s["start_ns"] + coarse_ns)
    for v in ring.values():
        v.sort()
    diffs = []
    for a, _, n in events:
        xs = ring.get(n)
        if not xs:
            continue
        j = bisect.bisect_left(xs, a)
        near = min(xs[max(j - 1, 0):j + 1], key=lambda x: abs(x - a))
        diffs.append(a - near)
    return coarse_ns + int(statistics.median(diffs)) if diffs else None


def gaps(busy: list, ws: int, we: int) -> list:
    """The device's idle gaps in the window [ws, we]: the complement of
    `busy`, the sorted union of its busy intervals (as harness/trace.py's
    `_idle_gaps` takes them)."""
    edges = [ws] + [x for seg in busy for x in seg] + [we]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(gaps: list, tracking: list, mapper: list,
                 offset_ns: int, small_ns: int = 50_000) -> list:
    """The device's idle gaps of a profiled sub-window, summed by the
    innermost `orb/` span open on the tracking thread at each gap's middle
    and by the mapper's span open there (its ring span moved onto the
    trace's clock by `offset_ns`): [[label, seconds], ...], largest
    first.  gaps: (start_ns, end_ns) on the trace's clock; tracking: the
    tracking thread's `orb/` events (start_ns, end_ns, name) there.  The
    search for the innermost event is harness/trace.py's `_idle_gaps`'s,
    on other events."""
    mine = sorted(tracking)
    starts = [m[0] for m in mine]
    lm = sorted((s["start_ns"] + offset_ns, s["end_ns"] + offset_ns,
                 s["name"]) for s in mapper if s["thread"] != "device")
    lm_starts = [m[0] for m in lm]

    def innermost(events, starts_, mid, reach=64):
        j = bisect.bisect_right(starts_, mid)
        found, width = None, None
        for a, b, n in events[max(j - reach, 0):j]:
            if b >= mid and (width is None or b - a < width):
                found, width = n, b - a
        return found

    total = defaultdict(int)
    for s, t in gaps:
        if t - s < small_ns:
            continue
        mid = (s + t) // 2
        track = innermost(mine, starts, mid) or "outside orb/"
        lmap = innermost(lm, lm_starts, mid)
        label = track if lmap is None else f"{track} | mapper {lmap}"
        total[label] += t - s
    return sorted(([n, v * 1e-9] for n, v in total.items()),
                  key=lambda x: -x[1])
