"""kernels.roofline_pct: the three frontend kernels' share (%) of
their roofline in the profiled sub-window: the least time their work
could take (metrics/kernel_bounds.py, from the profiled frames' own
pixels and keypoints, per launch) times their launches, over their
summed device time, found by name in the trace.  Layer: kernels
(csrc/fast.cu, orb.cu, stereo.cu).  Moves pose_latency_p50_ms (the KITTI cells);
as `kernels.roofline_pct.offline`, tracked_fps (the offline TUM cell)."""

PER_IMAGE = {"fast": 1, "orb": 1}


def read(run):
    tr, b = run.trace, run.bounds
    if not tr or not b or not b.get("frames"):
        return None
    bound = device = 0.0
    for k, v in tr["kernels"].items():
        if not v["launches"] or not v["device_s"] or not b.get(k):
            continue
        per_frame = (PER_IMAGE[k] * b["images_per_frame"] if k in PER_IMAGE
                     else 1)
        bound += b[k] / (b["frames"] * per_frame) * v["launches"]
        device += v["device_s"]
    return 100.0 * bound / device if device else None
