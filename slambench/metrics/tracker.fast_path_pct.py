"""tracker.fast_path_pct: the share (%) of offered frames the Tracker
took on its graph-replayed path (its `fast_step` and `pipelined_step`
timers, counted over the window and the drain) rather than the modular,
eager path.  Layer: Tracker (slam/tracking.py).  Moves pose_latency_p50_ms
(the KITTI cells); as `tracker.fast_path_pct.offline`, tracked_fps (the
offline TUM cell)."""


def read(run):
    n = len(run.window.frames)
    t = run.timers["tracker"]
    fast = sum(t.get(k, (0, 0.0))[0] for k in ("fast_step", "pipelined_step"))
    return 100.0 * fast / n if n else None
