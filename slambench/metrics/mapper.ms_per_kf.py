"""mapper.ms_per_kf: LocalMapper host ms per processed keyframe, the
totals of its top-level `lm/*` stage timers (the nested ones, such as
`lm/ba_*` inside `lm/local_ba`, are left out so nothing counts twice)
over the window and the drain, divided by `lm/process_new_kf`'s count.
Layer: LocalMapper (slam/local_mapping.py).  Moves pose_latency_p50_ms
(the KITTI cells: a busy mapper holds the map's lock and the interpreter
from the tracking thread); as `mapper.ms_per_kf.offline`, tracked_fps
(the offline TUM cell)."""

TOP = ("lm/bow_dispatch", "lm/process_new_kf", "lm/cull_points",
       "lm/triangulate", "lm/triangulate_wait", "lm/bow_apply",
       "lm/triangulate_apply", "lm/fuse_neighbors", "lm/fuse_wait",
       "lm/fuse_apply", "lm/local_ba", "lm/cull_keyframes")


def read(run):
    t = run.timers["mapper"]
    n = t.get("lm/process_new_kf", (0, 0.0))[0]
    if n <= 0:
        return None
    return sum(t.get(k, (0, 0.0))[1] for k in TOP) / n * 1e3
