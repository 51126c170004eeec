"""system.call_ms_p50: the median ms a `System.track_*` call holds the
tracking thread, by the harness's host clock around each call, over the
window's frames outside the profiled sub-window (the profiler slows the
host's launches there).  Layer: System (system.py).  Moves pose_latency_p50_ms
(the KITTI cells); as `system.call_ms_p50.offline`, tracked_fps (the
offline TUM cell)."""

import statistics


def read(run):
    skip = set(run.window.profiled)
    ms = [(f.returned - f.offered) * 1e3
          for i, f in enumerate(run.window.frames) if i not in skip]
    return statistics.median(ms) if ms else None
