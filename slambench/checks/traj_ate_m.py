"""`traj_ate_m`: the RMS camera-centre error, in metres, of every tracked
frame's final pose against the generator's truth, in the map's frame
(harness/check.py `_ate`; +inf where a frame's pose cannot be composed).
The one reading that sees a fault outside the two loop solves: the
propagation to connected keyframes, the point remap, fusion and global
BA's write-back.  The control is the trajectory composed with the map's
poses and the relative poses rounded to bfloat16."""


def read(j):
    return j.info["traj_ate_m"]


def control(j):
    return j.controls["traj_ate_m"]
