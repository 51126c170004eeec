"""BENCHMARK.json against the benchmark's contract, and the discovery of
each cell's configuration, traffic mix, limits and metric readers by
name."""

import json
import math
import re
from pathlib import Path

import pytest

from harness.spec import Spec

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    return Spec.load(ROOT)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command(spec):
    b = spec.bench
    assert set(b) == KEYS
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert b["command"][1] == "slambench/run.py"
    assert b["paths"] == ["slambench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells(spec):
    s = spec.bench["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries(spec):
    b = spec.bench
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("slambench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert _line(c["why"]) and _line(c["source"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in b["workloads"]}


def test_every_cell_reports_what_the_contract_asks(spec):
    for w in spec.bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics("end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics("per_layer", w["name"])
        assert layer
        for m in layer:          # a metric moves one its cell reports
            assert m["moves"] in e2e


def test_discovery_by_name(spec):
    for w in spec.bench["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["sensor"] in ("stereo", "rgbd")
        mix = spec.traffic(w["traffic"])
        assert mix["arrival"] in ("open", "closed")
        lim = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        assert set(lim["limits"]) == {
            "frontend_rows_differ", "track_pose_gap_mm",
            "track_pose_gap_deg", "track_pose_gap_mm_median",
            "track_pose_gap_deg_median", "reproj_chi2_p50", "loops_closed",
            "frames_unresolved"}
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_variant_reads_with_its_base():
    """`<base>.offline` has no file of its own: it reads with `<base>.py`,
    so the cells of either end-to-end metric read one computation (the
    CPU tests' benchmark names such variants)."""
    data = HERE / "tests" / "data"
    spec = Spec(json.loads((data / "BENCHMARK.json").read_text()), data,
                data)
    variants = [m for m in spec.bench["per_layer"]
                if m["name"].endswith(".offline")]
    assert variants
    for m in variants:
        base = m["name"].rsplit(".", 1)[0]
        assert not (HERE / "metrics" / f"{m['name']}.py").exists()
        assert (spec.reader(m["name"]).__code__.co_filename
                == str(HERE / "metrics" / f"{base}.py"))


def test_configs_keep_the_yaml_settings(spec):
    """Each configuration's settings are its ORB-SLAM2 yaml's, but for
    the keys it lists as reduced."""
    yaml = {
        "kitti00-02-stereo": {
            "Camera.fx": 718.856, "Camera.fy": 718.856,
            "Camera.cx": 607.1928, "Camera.cy": 185.2157,
            "Camera.width": 1241, "Camera.height": 376, "Camera.fps": 10.0,
            "Camera.bf": 386.1448, "ThDepth": 35,
            "ORBextractor.nFeatures": 2000, "ORBextractor.scaleFactor": 1.2,
            "ORBextractor.nLevels": 8, "ORBextractor.iniThFAST": 20,
            "ORBextractor.minThFAST": 7},
        "tum1-rgbd": {
            "Camera.fx": 517.306408, "Camera.fy": 516.469215,
            "Camera.cx": 318.643040, "Camera.cy": 255.313989,
            "Camera.k1": 0.262383, "Camera.k2": -0.953104,
            "Camera.p1": -0.005358, "Camera.p2": 0.002628,
            "Camera.k3": 1.163314, "Camera.width": 640, "Camera.height": 480,
            "Camera.fps": 30.0, "Camera.bf": 40.0, "ThDepth": 40.0,
            "DepthMapFactor": 5000.0, "ORBextractor.nFeatures": 1000,
            "ORBextractor.scaleFactor": 1.2, "ORBextractor.nLevels": 8,
            "ORBextractor.iniThFAST": 20, "ORBextractor.minThFAST": 7},
    }
    for name in yaml:
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        for k, v in yaml[name].items():
            if k in cfg["reduced"]:
                assert not math.isclose(cfg["settings"][k], v)
            else:
                assert math.isclose(cfg["settings"][k], v), k
