"""The control of `correct`: the compared numbers read from the program
and, beside them, from the control, over several seeds in one process.

    python3 slambench/control.py --workload <cell> --seconds <s> SEED...

For each seed the cell runs as a benchmark run does (set-up, window,
drain, the reference's comparison) and prints one JSON line with the
program's readings, the control's, and `correct` as the cell's limits
judge each.  The control is the reference put in the program's place in
bfloat16, the precision below the float32 the configuration states:

  frontend_rows_differ  the frozen reference frontend with its pyramid
                        levels in bfloat16, against the same in float32;
  track_pose_gap_*      the frozen pose solve in bfloat16 on each caught
                        frame's matches, against the same in float64
                        (the widest gap and the frames' median);
  reproj_chi2_p50       the map's keyframe poses and points rounded to
                        bfloat16;
  traj_ate_m            (not compared) the trajectory composed with
                        those poses and its relative poses in bfloat16.

The benchmark's own runs never run this.  The lower reading of a limit
is the largest a dozen or more seeds give for the program, the upper
the smallest the control gives (PERF.md gives both for each limit).
"""

import json
import sys
from pathlib import Path

import run


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    i = argv.index("--seconds")
    head, seeds = argv[:i + 2], argv[i + 2:]
    for seed in seeds:
        out = run.main(head + ["--seed", seed, "--trace", "0"],
                       controls=True)
        print(json.dumps({"control_run": True, "seed": int(seed),
                          "correct": out["correct"],
                          "control_correct": out["control_correct"],
                          "program": {k: v["value"] for k, v in
                                      out["compared"].items()},
                          "control": out["controls"],
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "detail": out["detail"]}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    main()
