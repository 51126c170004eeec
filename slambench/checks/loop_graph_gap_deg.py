"""`loop_graph_gap_deg`: the widest rotation angle, in degrees, over the
judged loops and every keyframe, between the program's essential-graph
poses and the frozen essential-graph solve (reference/pose_graph.py) on
the same problem.  The control is the reference in bfloat16 in the
program's place (harness/loops.py)."""

from harness import loops

catcher = loops.LoopCatcher


def read(j):
    return loops.readings(j)["loop_graph_gap_deg"]


def control(j):
    return loops.readings(j)["control"]["loop_graph_gap_deg"]
