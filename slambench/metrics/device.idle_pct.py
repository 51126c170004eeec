"""device.idle_pct: the share (%) of the profiled sub-window in
which no operation ran on the card (1 - the union of device operations'
time over the sub-window's length).  Layer: device (H100).  As
`device.idle_pct.offline`, moves tracked_fps (the offline TUM cell)."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
