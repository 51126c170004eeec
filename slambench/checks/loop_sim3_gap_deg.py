"""`loop_sim3_gap_deg`: the widest rotation angle, in degrees, over the
judged loops, between the current keyframe's Scw from the program's
refined S12 and from the frozen OptimizeSim3 (reference/sim3.py) on the
same matches from the same start.  The control is the reference in
bfloat16 in the program's place (harness/loops.py)."""

from harness import loops

catcher = loops.LoopCatcher


def read(j):
    return loops.readings(j)["loop_sim3_gap_deg"]


def control(j):
    return loops.readings(j)["control"]["loop_sim3_gap_deg"]
