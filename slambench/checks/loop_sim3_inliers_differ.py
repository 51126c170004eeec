"""`loop_sim3_inliers_differ`: the most matches, over the judged loops,
that the program's Sim3 refinement and the frozen OptimizeSim3
(reference/sim3.py) on the same matches from the same start classify
apart as inliers and outliers.  One match at the chi2 gate moves the
refined Sim3 by millimetres (PERF.md), so this count, and not the gap
alone, tells a sound refinement from its control: the reference in
bfloat16 in the program's place (harness/loops.py)."""

from harness import loops

catcher = loops.LoopCatcher


def read(j):
    return loops.readings(j)["loop_sim3_inliers_differ"]


def control(j):
    return loops.readings(j)["control"]["loop_sim3_inliers_differ"]
