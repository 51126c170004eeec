"""`loops_judged`: the loops whose Sim3 refinement and essential graph were
both caught and compared (harness/loops.py).  The other loop numbers
read +inf where the loop closer closed more.  The control reads the same
count."""

from harness import loops

catcher = loops.LoopCatcher


def read(j):
    return loops.readings(j)["loops_judged"]
