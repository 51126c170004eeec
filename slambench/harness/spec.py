"""Finds a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, one mix or one per-layer
metric is a file of its own, so a later change adds a cell by adding
files:

  BENCHMARK.json                      the cells and the metrics
  <bench dir>/configs/<config>.json   a deployment (named in its entry's `file`)
  <bench dir>/traffic/<mix>.json      a traffic mix
  <bench dir>/metrics/<metric>.py     a per-layer metric's reader: read(run)
  <bench dir>/limits/<cell>.json      the limit of each number `correct`
                                      compares
  <bench dir>/checks/<number>.py      a compared number that
                                      harness/check.py's `readings` does
                                      not give: read(j), and optionally
                                      control(j) and a `catcher`
                                      (run.py says what j holds)

A metric `<base>.<variant>` (such as `system.call_ms_p50.offline`, the
same quantity in the cells whose end-to-end metric is another) with no
file of its own reads with `<base>.py`, so one computation has one file;
a compared number does the same in checks/.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Spec:
    def __init__(self, bench: dict, root: Path, bench_dir: Path = BENCH_DIR,
                 metrics_dir: Path = BENCH_DIR / "metrics",
                 checks_dir: Path = BENCH_DIR / "checks",
                 limits: dict = None):
        """`limits` ({cell: {number: limit}}) stands in for the cells'
        limits files, for a cell built in memory."""
        self.bench, self.root, self.dir = bench, Path(root), Path(bench_dir)
        self.metrics_dir = Path(metrics_dir)
        self.checks_dir = Path(checks_dir)
        self._limits = limits or {}

    @classmethod
    def load(cls, root: Path) -> "Spec":
        root = Path(root)
        return cls(json.loads((root / "BENCHMARK.json").read_text()), root)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"slambench: no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise SystemExit(f"slambench: no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        mix = json.loads((self.dir / "traffic" / f"{name}.json").read_text())
        mix["name"] = name
        return mix

    def metrics(self, kind: str, workload: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics this cell
        reports: those without a `workloads` list, and those listing it."""
        return [m for m in self.bench[kind]
                if workload in m.get("workloads", [workload])]

    def limits(self, workload: str) -> dict:
        """{number: {"at_most" or "at_least": limit}} of a cell."""
        if workload in self._limits:
            return self._limits[workload]
        return json.loads((self.dir / "limits" / f"{workload}.json")
                          .read_text())["limits"]

    def reader(self, metric: str):
        """The `read(run)` function of a per-layer metric: its own file,
        or else its base's (the name up to its last dot)."""
        mod = _load(self.metrics_dir, metric, "slambench_metric_")
        if mod is None:
            raise SystemExit(f"slambench: no reader metrics/{metric}.py")
        return mod.read

    def check(self, number: str):
        """The module of a compared number's file in checks/ (its own,
        or else its base's), or None where there is neither."""
        return _load(self.checks_dir, number, "slambench_check_")


def _load(folder: Path, name: str, prefix: str):
    """`folder/<name>.py`, or else `folder/<base>.py` with the base the
    name up to its last dot, as a module; None where neither exists."""
    path = folder / f"{name}.py"
    if not path.exists() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
