"""track_step.device_ms: device-busy ms per CUDA-graph replay in the
profiled sub-window: the summed device time of the kernels whose launch
was a cudaGraphLaunch, over the number of those launches.  Layer: track
step (slam/track_step.py GraphStep, ChainRunner).  Moves pose_latency_p50_ms
(the KITTI cells); as `track_step.device_ms.offline`, tracked_fps (the
offline TUM cell)."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("graph_replays") or not tr.get("graph_device_s"):
        return None
    return tr["graph_device_s"] / tr["graph_replays"] * 1e3
