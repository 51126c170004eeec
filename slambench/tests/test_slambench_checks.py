"""Compared numbers found by file: a limits key that harness/check.py's
`readings` does not give is read from `checks/<key>.py` (or its base's
file, as metric readers are), and a key with neither a reading nor a file
stops the run before anything is set up."""

import json
from pathlib import Path

import pytest

import run
from harness import check
from harness.spec import Spec

HERE = Path(__file__).resolve().parent.parent
DATA = HERE / "tests" / "data"


def _spec(limits=None, checks_dir=HERE / "checks"):
    return Spec(json.loads((DATA / "BENCHMARK.json").read_text()), DATA,
                DATA, checks_dir=checks_dir, limits=limits)


def test_a_key_is_served_from_its_file_or_its_base(tmp_path):
    (tmp_path / "probe_number.py").write_text(
        "def read(j):\n    return 7.0\n\n\ndef control(j):\n    return 9.0\n")
    (tmp_path / "probe_base.py").write_text(
        "def read(j):\n    return 3.0\n")
    spec = _spec(checks_dir=tmp_path)
    found = run.find_checks(spec, {
        "loops_closed": {"at_most": 0}, "probe_number": {"at_most": 8},
        "probe_base.variant": {"at_most": 4}})
    assert set(found) == {"probe_number", "probe_base.variant"}
    assert found["probe_number"].read(None) == 7.0
    assert found["probe_number"].control(None) == 9.0
    assert found["probe_base.variant"].read(None) == 3.0
    assert not hasattr(found["probe_base.variant"], "control")


def test_the_readings_keep_their_place():
    """The eight numbers check.readings gives are never looked up in
    checks/, and no file there shadows one."""
    found = run.find_checks(_spec(), {k: {"at_most": 0}
                                      for k in check.READINGS})
    assert found == {}
    files = {p.stem for p in (HERE / "checks").glob("*.py")}
    assert not files & set(check.READINGS)


def test_every_check_file_reads_and_names_a_known_catcher():
    from harness import loops

    spec = _spec()
    for p in sorted((HERE / "checks").glob("*.py")):
        mod = spec.check(p.stem)
        assert callable(mod.read), p
        assert getattr(mod, "catcher", loops.LoopCatcher) is loops.LoopCatcher


def test_the_limits_come_from_memory_or_from_the_file():
    spec = _spec(limits={"tiny-stereo.open": {"x": {"at_most": 1}}})
    assert spec.limits("tiny-stereo.open") == {"x": {"at_most": 1}}
    assert "track_pose_gap_mm" in spec.limits("tiny-rgbd.closed")


@pytest.mark.parametrize("key", ["no_such_number", "no_such.variant"])
def test_a_key_with_no_reading_and_no_file_stops_the_run(key, capsys):
    limits = {"tiny-stereo.open": dict(
        json.loads((DATA / "limits" / "tiny-stereo.open.json")
                   .read_text())["limits"], **{key: {"at_most": 1.0}})}
    with pytest.raises(SystemExit) as stop:
        run.main(["--workload", "tiny-stereo.open", "--seed", "1",
                  "--seconds", "1", "--device", "cpu"],
                 spec=_spec(limits=limits))
    assert key in str(stop.value) and "no result" in str(stop.value)
    assert capsys.readouterr().out == ""
