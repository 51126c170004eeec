"""The port's copies of tests/test_golden.py, against the same recorded
golden, plus whole-slice parity with the JAX System on the golden
sequence.

- The golden: the port's stereo System (CPU) on the 16-frame
  240x320 sequence gives the golden's frame count and timestamps, and
  every camera centre within 5 mm of tests/data/golden_stereo_traj.npz,
  which the JAX package recorded.
- The driver: `apps.run_slam stereo_kitti` of the port on an on-disk
  KITTI-format miniature writes a TUM trajectory; `mono_tum` on its left
  images as a TUM sequence initializes, tracks and writes the grid map.
- Parity: the JAX System and the port's System on the golden sequence
  insert keyframes on the same frames and their camera centres agree
  within 5 mm on every frame.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor
from orb_slam2_tpu_torch.system import System
from synthetic import stereo_sequence, straight_trajectory
from test_golden import BASELINE, FX, GOLDEN, H, W, _settings

torch.set_num_threads(2)

MAX_DEV_M = 5e-3


def golden_pairs(n=16, yaw_step=0.004):
    s = _settings()
    poses = straight_trajectory(n, step=0.05, yaw_step=yaw_step)
    _, pairs = stereo_sequence(s.K, H, W, BASELINE, poses)
    return pairs


def run(system, pairs):
    """Track every pair; returns (keyframe insertion frames, per-frame
    camera centres (None where untracked))."""
    kfs, centres = [], []
    for i, (l, r) in enumerate(pairs):
        n_kf = system.store.n_kf
        T = system.track_stereo(l, r, i * 0.1)
        if system.store.n_kf > n_kf:
            kfs.append(i)
        centres.append(None if T is None else -T[:3, :3].T @ T[:3, 3])
    return kfs, centres


def trajectory(system):
    """The golden's reading of a run: (timestamps, camera centres) of
    the trajectory entries whose reference keyframe survives."""
    store = system.store
    ts, centers = [], []
    for e in system.tracker.trajectory:
        if e.lost or not store.kf_valid[e.ref_kf]:
            continue
        T = e.Tcr @ store.kf_pose[e.ref_kf]
        ts.append(e.timestamp)
        centers.append(-T[:3, :3].T @ T[:3, 3])
    return np.array(ts), np.array(centers, np.float32)


@pytest.fixture(scope="module")
def port_run():
    system = System(convert.settings_from_jax(_settings()), Sensor.STEREO,
                    device="cpu")
    kfs, centres = run(system, golden_pairs())
    return system, kfs, centres


class TestGoldenTrajectory:
    def test_trajectory_matches_recorded_golden(self, port_run):
        assert os.path.exists(GOLDEN)
        g = np.load(GOLDEN)
        ts, centers = trajectory(port_run[0])
        assert len(ts) == len(g["ts"]), (len(ts), len(g["ts"]))
        np.testing.assert_allclose(ts, g["ts"], atol=1e-9)
        dev = np.linalg.norm(centers - g["centers"], axis=1)
        assert dev.max() < MAX_DEV_M, (
            f"max deviation {dev.max():.4f} m from golden at frame "
            f"{int(dev.argmax())}")


class TestDriverSmoke:
    def test_run_slam_stereo_kitti_end_to_end(self, tmp_path):
        """The port's run_slam on a miniature on-disk KITTI-format
        dataset: loader -> System -> trajectory outputs."""
        import cv2

        from orb_slam2_tpu_torch.apps import run_slam

        pairs = golden_pairs(8, yaw_step=0.002)
        seq = tmp_path / "00"
        (seq / "image_0").mkdir(parents=True)
        (seq / "image_1").mkdir()
        for i, (l, r) in enumerate(pairs):
            cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), l)
            cv2.imwrite(str(seq / "image_1" / f"{i:06d}.png"), r)
        (seq / "times.txt").write_text(
            "".join(f"{i * 0.1:.6e}\n" for i in range(len(pairs))))
        yaml = tmp_path / "settings.yaml"
        yaml.write_text(f"""%YAML:1.0
Camera.fx: {FX}
Camera.fy: {FX}
Camera.cx: {W / 2}
Camera.cy: {H / 2}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {W}
Camera.height: {H}
Camera.fps: 10.0
Camera.bf: {FX * BASELINE}
ThDepth: 40.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
        out = tmp_path / "result"
        run_slam.main([
            "stereo_kitti", str(yaml), str(seq), "--out", str(out),
            "--device", "cpu",
        ])
        traj = (str(out) + "_CameraTrajectory_TUM.txt")
        assert os.path.exists(traj)
        rows = [ln.split() for ln in open(traj) if ln.strip()]
        assert len(rows) >= len(pairs) - 2
        assert all(len(r) == 8 for r in rows)   # TUM: ts tx ty tz qxyzw
        # mono_tum on the left images as a TUM rgb.txt sequence, with the
        # fork's grid map: initializes from two views, then tracks
        tum = tmp_path / "tum"
        (tum / "rgb").mkdir(parents=True)
        with open(tum / "rgb.txt", "w") as f:
            f.write("# timestamp filename\n")
            for i, (l, _) in enumerate(pairs):
                cv2.imwrite(str(tum / "rgb" / f"{i:06d}.png"), l)
                f.write(f"{i * 0.1:.6f} rgb/{i:06d}.png\n")
        out_m = tmp_path / "mono"
        grid = tmp_path / "grid.pgm"
        run_slam.main([
            "mono_tum", str(yaml), str(tum), "--out", str(out_m),
            "--device", "cpu", "--max-frames", "5", "--grid-map", str(grid),
        ])
        rows_m = [ln.split() for ln in
                  open(str(out_m) + "_CameraTrajectory_TUM.txt")
                  if ln.strip()]
        assert 1 <= len(rows_m) <= 5 and all(len(r) == 8 for r in rows_m)
        kf_rows = [ln for ln in
                   open(str(out_m) + "_KeyFrameTrajectory_TUM.txt")
                   if ln.strip()]
        assert len(kf_rows) >= 2
        assert grid.read_text().splitlines()[:2] == ["P2", "450 300"]
        for opt in (["--viewer"], ["--ar", str(tmp_path / "ar")]):
            with pytest.raises(NotImplementedError, match="item 8"):
                run_slam.main(["mono_tum", str(yaml), str(tum),
                               "--device", "cpu", *opt])
        # pipelined with the async scheduler: run_slam drains the frames
        # in flight before it saves, so every frame is in the trajectory
        out2 = tmp_path / "pipelined"
        run_slam.main([
            "stereo_kitti", str(yaml), str(seq), "--out", str(out2),
            "--device", "cpu", "--pipelined", "--scheduler", "async",
        ])
        rows2 = [ln.split() for ln in
                 open(str(out2) + "_CameraTrajectory_TUM.txt") if ln.strip()]
        assert len(rows2) == len(rows)
        assert float(rows2[-1][0]) == pytest.approx(0.1 * (len(pairs) - 1))


def test_golden_sequence_matches_jax_system(port_run):
    """Whole-slice parity: the JAX System on the same sequence inserts
    keyframes on the same frames, and every camera centre agrees within
    5 mm."""
    from orb_slam2_tpu.config import Sensor as JSensor
    from orb_slam2_tpu.system import System as JSystem

    system, kfs, centres = port_run
    jkfs, jcentres = run(JSystem(_settings(), JSensor.STEREO),
                         golden_pairs())
    assert kfs == jkfs
    assert all((a is None) == (b is None) for a, b in zip(centres, jcentres))
    dev = [np.linalg.norm(a - b) for a, b in zip(centres, jcentres)
           if a is not None]
    assert len(dev) == len(centres) and max(dev) < MAX_DEV_M, max(dev)
