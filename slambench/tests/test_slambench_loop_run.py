"""The judge of a closed loop on the CPU (`--device cpu`, the plain
kernels).

- A System of the half-size stereo rig with the synchronous scheduler
  (mapping and loop closing inline, so the loop closes on every run)
  taken 1.4 orbits around the cylinder, 140 frames at 3.6 degrees, with
  harness/loops.py's catcher attached: the loop closes, the catcher keeps
  both of its solves, what it kept is what the program applied, and the
  judge reads each gap and its control.  About two minutes.
- A whole run (run.py) of the cell that never revisits, with limits that
  name every number of checks/: the files are found, their one catcher
  is attached and let go, and no loop reads as nothing to judge."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import run
from harness import check, loops
from harness import scene as scene_mod
from harness.spec import Spec

HERE = Path(__file__).resolve().parent.parent
DATA = HERE / "tests" / "data"
NUMBERS = list(check.READINGS) + sorted(
    p.stem for p in (HERE / "checks").glob("*.py"))


@pytest.fixture(scope="module")
def closed_loop():
    from orb_slam2_tpu_torch.config import Sensor, Settings
    from orb_slam2_tpu_torch.system import System

    torch.set_num_threads(2)
    cfg = json.loads((DATA / "configs" / "tiny-stereo.json").read_text())
    cfg["name"] = "tiny-stereo"
    dev = torch.device("cpu")
    scene = scene_mod.Cylinder(cfg, dev)
    poses = scene.poses(140, 3.6, 2147483999)
    left, _ = scene.render(poses)
    right, _ = scene.render(poses, right=True)
    voc = run.train_or_load_vocabulary(cfg, scene, dev)
    system = System(Settings.from_dict(cfg["settings"]), Sensor.STEREO,
                    vocabulary=voc, scheduler="sync", device=dev)
    catch = loops.LoopCatcher(system)
    for i, (lf, rf) in enumerate(zip(left, right)):
        system.track_stereo(lf, rf, i / 10.0)
    closed = system.loop_closer.loops_closed
    system.shutdown()
    catch.detach()
    j = SimpleNamespace(cfg=cfg, device=dev, truth_poses=poses,
                        values={"loops_closed": closed}, info={},
                        controls={}, catch=catch, cache={})
    return closed, catch, loops.readings(j), j


def test_the_loop_closes_and_both_solves_are_caught(closed_loop):
    closed, catch, got, j = closed_loop
    assert closed >= 1 and catch.closed == closed
    assert got["loops_judged"] == len(catch.loops) == closed
    for lp in catch.loops:
        assert lp["sim3"] is not None and lp["graph"] is not None
    assert len(j.info["loops"]) == closed
    for k in loops.PER_LOOP:
        assert math.isfinite(got[k]) and math.isfinite(got["control"][k]), k


def test_the_caught_sim3_is_the_one_the_correction_used(closed_loop):
    _, catch, _, _ = closed_loop
    for lp in catch.loops:
        R12, t12, s12 = lp["sim3"]["out"][:3]
        S = loops._scw(R12, t12, float(s12), lp["scw"]["T_cand"])
        np.testing.assert_allclose(S[0], lp["scw"]["R"], atol=1e-5)
        np.testing.assert_allclose(S[1], lp["scw"]["t"], atol=1e-5)
        assert abs(S[2] - lp["scw"]["s"]) < 1e-6
        assert lp["sim3"]["fix_scale"] is True        # stereo
        assert np.asarray(lp["sim3"]["mask"]).sum() >= 20


def test_the_caught_graph_is_what_the_store_got(closed_loop):
    _, catch, _, _ = closed_loop
    for lp in catch.loops:
        v = lp["vertices"]
        np.testing.assert_allclose(
            v["written"], loops._se3_4x4(lp["graph"]["out"], len(v["kf"])),
            atol=1e-5)
        assert len(v["kf"]) == int(lp["graph"]["prob"]["vmask"].sum())


def test_the_sim3_control_reads_far_off_the_program(closed_loop):
    """The Sim3 refinement sits near the reference (a match at the chi2
    gate that the two classify apart moves it by millimetres, as the pose
    LM's does); its bfloat16 control is off by ten times that or more,
    and classifies more matches apart."""
    _, _, got, _ = closed_loop
    assert got["control"]["loop_sim3_gap_mm"] > 10 * got["loop_sim3_gap_mm"]
    assert got["control"]["loop_sim3_gap_mm"] > 10.0
    assert got["loop_sim3_inliers_differ"] <= 1
    assert got["control"]["loop_sim3_inliers_differ"] > 5


def test_the_catcher_let_go_of_the_program(closed_loop):
    from orb_slam2_tpu_torch.solvers import pose_graph, sim3_solver

    _, catch, _, _ = closed_loop
    assert catch.lc is None and catch._undo == []
    assert sim3_solver.refine_sim3.__name__ == "refine_sim3"
    assert pose_graph.optimize.__name__ == "optimize"


def test_more_loops_closed_than_judged_read_infinite(closed_loop):
    closed, catch, _, j = closed_loop
    short = SimpleNamespace(**dict(vars(j), cache={}, info={},
                                   values={"loops_closed": closed + 1}))
    got = loops.readings(short)
    assert all(got[k] == math.inf for k in loops.PER_LOOP)


def test_a_run_finds_the_files_and_judges_no_loop():
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    limits = dict(json.loads((DATA / "limits" / "tiny-stereo.open.json")
                             .read_text())["limits"])
    limits.update({k: {"at_most": math.inf} for k in NUMBERS
                   if k not in limits})
    limits["loops_judged"] = {"at_least": 0}
    spec = Spec(bench, DATA, DATA, limits={"tiny-stereo.open": limits})
    made = []
    real = loops.LoopCatcher.__init__

    def keep(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loops.LoopCatcher, "__init__", keep)
        out = run.main(["--workload", "tiny-stereo.open", "--seed",
                        "2147483653", "--seconds", "3", "--device", "cpu"],
                       spec=spec, controls=True)
    assert len(made) == 1 and made[0].lc is None
    v = {k: c["value"] for k, c in out["compared"].items()}
    assert set(v) == set(NUMBERS)
    assert v["loops_closed"] == v["loops_judged"] == 0
    assert all(v[k] == 0 for k in loops.PER_LOOP)
    assert v["traj_ate_m"] == out["detail"]["traj_ate_m"]
    assert out["controls"]["traj_ate_m"] > 0
    assert out["correct"] is True
