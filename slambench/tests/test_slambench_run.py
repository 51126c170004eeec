"""Whole runs of a half-size cell on the CPU (`--device cpu`, the plain
kernels): the result line, the per-layer line, the controls, and the
faults that `correct` has to catch.  Each run takes about a minute."""

import json
from pathlib import Path

import pytest
import torch

import run
from harness.spec import Spec

DATA = Path(__file__).resolve().parent / "data"
ARGS = ["--seed", "2147483653", "--seconds", "3", "--device", "cpu"]


def _spec():
    return Spec(json.loads((DATA / "BENCHMARK.json").read_text()), DATA, DATA)


def _run(workload="tiny-stereo.open", trace=0, controls=False, capsys=None):
    torch.set_num_threads(2)
    out = run.main(["--workload", workload, "--trace", str(trace)] + ARGS,
                   spec=_spec(), controls=controls)
    return out


@pytest.fixture(scope="module")
def plain_run():
    return _run(controls=True)


def test_result_line_keys(plain_run, capsys):
    out = plain_run
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert out["correct"] is True
    assert out["attempted"] == 30 and out["failed"] == 0
    assert set(out["metrics"]) == {"pose_latency_p50_ms", "setup_s"}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    # the compared numbers come last, each beside its limit
    assert list(out)[list(out).index("compared")] == "compared"
    assert set(out["compared"]) == {
        "frontend_rows_differ", "track_pose_gap_mm", "track_pose_gap_deg",
        "track_pose_gap_mm_median", "track_pose_gap_deg_median",
        "reproj_chi2_p50", "loops_closed", "frames_unresolved"}
    assert len(out["detail"]["frames_caught"]) == 4


def test_the_controls_fail_their_limits(plain_run):
    lim = json.loads((DATA / "limits" / "tiny-stereo.open.json")
                     .read_text())["limits"]
    c = plain_run["controls"]
    assert plain_run["compared"]["frontend_rows_differ"]["value"] == 0
    assert plain_run["control_correct"] is False
    for name in ("frontend_rows_differ", "track_pose_gap_mm",
                 "track_pose_gap_deg", "track_pose_gap_mm_median",
                 "track_pose_gap_deg_median"):
        assert c[name] > lim[name]["at_most"], name
    assert c["reproj_chi2_p50"] > plain_run["compared"]["reproj_chi2_p50"][
        "value"]


def test_traced_line_has_the_per_layer_metrics(capsys):
    out = _run(trace=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert out["correct"] is True
    assert {"system.call_ms_p50", "tracker.fast_path_pct",
            "mapper.ms_per_kf"} <= set(out["metrics"])
    assert "pose_latency_p50_ms" not in out["metrics"]


def _fault_run(monkeypatch, patch):
    patch(monkeypatch)
    return _run()


def _frozen_pose(monkeypatch):
    """The step returns its state unchanged: every solve hands back the
    pose it started from."""
    from orb_slam2_tpu_torch.solvers import pose_lm

    real = pose_lm.optimize_pose

    def frozen(T, *a, **k):
        out = real(T, *a, **k)
        return (T,) + tuple(out[1:])

    monkeypatch.setattr(pose_lm, "optimize_pose", frozen)


def _half_the_keypoints(monkeypatch):
    """Half of the batch left out: every other keypoint dropped."""
    from orb_slam2_tpu_torch.ops import frontend

    real = frontend.extract

    def half(*a, **k):
        f = real(*a, **k)
        valid = f.valid.clone()
        valid[1::2] = False
        return f._replace(valid=valid)

    monkeypatch.setattr(frontend, "extract", half)


def _altered_descriptors(monkeypatch):
    """An answer altered where it is produced: one bit of every
    descriptor flipped by the describe step."""
    from orb_slam2_tpu_torch.ops import orb_cuda

    real = orb_cuda.describe_levels

    def flipped(*a, **k):
        ang, desc = real(*a, **k)
        desc = desc.clone()
        desc[:, 0] ^= 1
        return ang, desc

    monkeypatch.setattr(orb_cuda, "describe_levels", flipped)


@pytest.mark.parametrize("fault", [_frozen_pose, _half_the_keypoints,
                                   _altered_descriptors],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_a_fault_makes_correct_false(monkeypatch, fault):
    out = _fault_run(monkeypatch, fault)
    assert out["correct"] is False
    failing = [k for k, v in out["compared"].items()
               if v["value"] is None or (v["value"] > v["limit"]
                                         if v["sense"] == "<="
                                         else v["value"] < v["limit"])]
    assert failing
