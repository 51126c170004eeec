"""One benchmark run with each frame decomposed by the port's own spans.

    python3 slambench/frame_spans.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--rows PATH]

Runs `run.py` on the same arguments (its result line comes first on
standard output), takes `System.trace_snapshot()` just before the System
is shut down, and prints one more JSON line, `{"frame_spans": ...}`:

  - `unprofiled` / `profiled`: `harness/spans.py`'s summary of the
    window's replayed frames outside / inside the profiled sub-window:
    the five span metrics and the median ms of every span name a frame,
    with `host`, `blocked`, `device` (the replay's stages) and `rest`
    (the frame less its children);
  - `counters`: the System's counters;
  - with `--trace 1`: `trace_device_ms`, the replay's device ms from the
    trace (track_step.device_ms's reading) beside the stamps' sum on the
    same frames, `stamp_kernel_us`, the stamp kernels' device us a replay
    by the trace, and `idle_by_span`, the sub-window's idle gaps labelled
    by the port's spans.

`--rows PATH` also writes every frame's row, and the spans of the
mapper, as JSON to PATH.

A measuring tool beside the benchmark: the benchmark's own line is
run.py's, unchanged.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import run  # noqa: E402
from harness import spans  # noqa: E402


def _profiled(sub, seen: tuple) -> tuple:
    """The sub-window's device idle gaps, the tracking thread's `orb/`
    events and every thread's, on the trace's clock, and the stamp
    kernels' device ns.  `seen`: the arguments with which
    harness/trace.py's `read` labelled its idle gaps (the busy union,
    the window, its host events and the tracking thread)."""
    import torch

    busy, ws, we, cpu, tid = seen
    orb, tracking = [], []
    for e in cpu:
        if e.name().startswith("orb/"):
            ev = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            orb.append(ev)
            if e.start_thread_id() == tid:
                tracking.append(ev)
    stamp_ns = sum(e.duration_ns()
                   for e in sub.prof.profiler.kineto_results.events()
                   if e.device_type() != torch.autograd.DeviceType.CPU
                   and "stamp_kernel" in e.name() and ws <= e.start_ns() < we)
    return spans.gaps(busy, ws, we), tracking, orb, stamp_ns


def main(argv=None, spec=None) -> dict:
    """`spec`: run.py's, for the harness's own CPU tests."""
    import argparse

    from harness import drive, trace
    from orb_slam2_tpu_torch.system import System

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows")
    opts, argv = ap.parse_known_args(argv)
    got = {}
    run_window, shutdown, read = drive.run_window, System.shutdown, trace.read
    idle_gaps = trace._idle_gaps

    def keep_window(*a, **k):
        got["window"] = run_window(*a, **k)
        return got["window"]

    def snapshot_then_shutdown(self):
        got["snapshot"] = self.trace_snapshot()
        got["coarse_ns"] = time.time_ns() - time.perf_counter_ns()
        return shutdown(self)

    def keep_gaps(*a, **k):
        got["seen"] = a
        return idle_gaps(*a, **k)

    def read_and_label(sub):
        out = read(sub)
        snap = got.get("snapshot")
        if snap is not None and "seen" in got:
            gaps, tracking, orb, got["stamp_ns"] = _profiled(sub, got["seen"])
            off = spans.clock_offset_ns(orb, snap["spans"]["tracker"],
                                        got["coarse_ns"])
            got["offset_ns"] = off
            if off is not None:
                got["idle_by_span"] = spans.idle_by_span(
                    gaps, tracking, snap["spans"]["mapper"], off)
        return out

    drive.run_window = keep_window
    System.shutdown = snapshot_then_shutdown
    trace.read, trace._idle_gaps = read_and_label, keep_gaps
    try:
        out = run.main(argv, spec=spec)
    finally:
        drive.run_window, System.shutdown = run_window, shutdown
        trace.read, trace._idle_gaps = read, idle_gaps

    snap, window = got.get("snapshot"), got.get("window")
    rows = spans.frames(snap, window)
    inside = spans.frames(snap, window, profiled=True)
    res = {
        "unprofiled": spans.summary(rows),
        "profiled": spans.summary(inside),
        "counters": snap["counters"] if snap else None,
    }
    if opts.rows:
        Path(opts.rows).write_text(json.dumps({
            "unprofiled": rows, "profiled": inside,
            "mapper": snap["spans"]["mapper"] if snap else []}))
    m = out.get("metrics", {}).get("track_step.device_ms")
    if m is not None:
        res["trace_device_ms"] = m["value"]
        res["stamps_device_ms_profiled"] = res["profiled"]["median_ms"].get(
            "device")
        res["stamp_kernel_us"] = (got.get("stamp_ns", 0) * 1e-3
                                  / max(len(inside), 1))
        res["offset_ns"] = got.get("offset_ns")
        res["idle_by_span"] = got.get("idle_by_span")
    print(json.dumps({"frame_spans": res}))
    sys.stdout.flush()
    return res


if __name__ == "__main__":
    main()
