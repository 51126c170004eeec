"""The loop closer's readings without a cell: KITTI stereo under
traffic/loop-10hz.json, judged by every compared number the harness has,
beside the control's readings, over several seeds in one process.

    python3 slambench/loop_study.py [--deg-per-frame D] --seconds S SEED...

Builds in memory a cell `kitti-stereo.loop-study` of the configuration
kitti00-02-stereo under the mix loop-10hz (its degrees a frame replaced
where asked), whose limits name each number harness/check.py reads and
each file of checks/, none with a bound, and runs control.py over the
seeds: one JSON line a seed with the program's readings, the control's,
the run's metrics and its detail (the judged loops under "loops").
BENCHMARK.json and limits/ are left as they are; `correct` means nothing
here, since no number has a limit.
"""

import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = "kitti-stereo.loop-study"


def study_spec(deg_per_frame=None):
    from harness import check
    from harness.spec import Spec

    class Study(Spec):
        def traffic(self, name):
            mix = super().traffic(name)
            if deg_per_frame is not None:
                mix["deg_per_frame"] = float(deg_per_frame)
            return mix

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = bench["workloads"] + [{
        "name": NAME, "config": "kitti00-02-stereo", "traffic": "loop-10hz",
        "chips": 1, "why": "the loop closer's readings, measured"}]
    numbers = list(check.READINGS) + sorted(
        p.stem for p in (HERE / "checks").glob("*.py"))
    limits = {k: ({"at_least": 0} if k == "loops_judged"
                  else {"at_most": math.inf}) for k in numbers}
    return Study(bench, ROOT, limits={NAME: limits})


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    deg = None
    if "--deg-per-frame" in argv:
        i = argv.index("--deg-per-frame")
        deg = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    import control

    control.main(["--workload", NAME] + argv, spec=study_spec(deg))


if __name__ == "__main__":
    sys.path.insert(0, str(HERE))
    main()
