"""The port's monocular System on the CPU against the JAX package:
tests/test_pipeline.py::TestMonoSystemSettings and
tests/test_system_e2e.py::TestMonocular on the port, and both Systems on
the same PlaneScene frames.

- Settings: a per-System copy with the local block doubled and
  `pipelined` demoted, the caller's object untouched, and a keyframe store
  `padded_total(2 * n_features)` rows wide (the init frames' budget).
- Parity: the two Systems initialize on the same frame; keyframe 1's pose
  after the median-depth normalisation within 1e-3 of JAX's; map-point
  counts within 2%.  Over 12 frames (marked slow: ~2 min for the two
  Systems) keyframe counts equal, point counts within 2% and camera
  centres within 0.02 of the unit median depth.
- End to end: TestMonocular's gates on the port's run of its 25 frames,
  with the fork's grid mapper attached.
"""

import threading

import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.system import System as JSystem
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.mapping2d.gridmap import GridParams
from orb_slam2_tpu_torch.mapping2d.stream import attach_grid_mapper
from orb_slam2_tpu_torch.ops.frontend import padded_total
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
from orb_slam2_tpu_torch.system import System
from orb_slam2_tpu_torch.utils import DEVICE_CAPTURE_LOCK
from synthetic import PlaneScene, straight_trajectory
from test_system_e2e import H, W, center_of, make_settings

torch.set_num_threads(2)

N_FRAMES = 25
N_PARITY = 12
POSE_ATOL = 1e-3
COUNT_RTOL = 0.02
CENTRE_ATOL = 0.02


def mono_settings():
    """TestMonocular's configuration (JAX Settings)."""
    return make_settings(n_features=800, fps=10.0, th_depth=40.0)


def mono_frames(n):
    scene = PlaneScene(mono_settings().K, H, W)
    poses = straight_trajectory(N_FRAMES, step=0.06, yaw_step=0.002)[:n]
    return poses, [scene.render(T) for T in poses]


def run(system, imgs):
    """Track every image; per frame (Tcw or None, keyframes, points), the
    init frame's index and the first two keyframes' poses at init."""
    out, init = [], None
    for i, img in enumerate(imgs):
        T = system.track_monocular(img, i * 0.1)
        n_kf = int(system.map.kf_valid.sum())
        out.append((None if T is None else T.copy(), n_kf,
                    int(system.map.pt_valid.sum())))
        if init is None and T is not None:
            init = dict(frame=i, kf_pose=system.map.kf_pose[:2].copy(),
                        points=out[-1][2])
    return out, init


@pytest.fixture(scope="module")
def port_run():
    system = System(convert.settings_from_jax(mono_settings()),
                    Sensor.MONOCULAR, device="cpu")
    grid, _ = attach_grid_mapper(system, GridParams(
        scale_factor=20.0, cloud_min_x=-3, cloud_max_x=3, cloud_min_z=-3,
        cloud_max_z=6))
    poses, imgs = mono_frames(N_FRAMES)
    per_frame, init = run(system, imgs)
    return system, grid, poses, per_frame, init


class TestMonoSystemSettings:
    def test_mono_copy_doubles_bucket_and_demotes_pipelined(self):
        settings = convert.settings_from_jax(make_settings())
        settings.pipelined = True
        base_bucket = settings.bucket_local
        sys_ = System(settings, Sensor.MONOCULAR, device="cpu")
        assert sys_.settings is not settings
        assert sys_.settings.bucket_local == 2 * base_bucket
        assert sys_.settings.pipelined is False
        assert sys_.tracker.pipelined is False
        # the caller's object, with its run-time attribute, is untouched
        assert settings.bucket_local == base_bucket
        assert settings.pipelined is True
        sys_st = System(settings, Sensor.STEREO, device="cpu")
        assert sys_st.settings is settings
        assert sys_st.settings.pipelined is True

    def test_store_holds_the_init_frames_budget(self):
        settings = convert.settings_from_jax(mono_settings())
        mono = System(settings, Sensor.MONOCULAR, device="cpu")
        stereo = System(settings, Sensor.STEREO, device="cpu")
        lv = (settings.n_levels, settings.scale_factor)
        assert mono.store.n_feat == padded_total(2 * settings.n_features, *lv)
        assert stereo.store.n_feat == padded_total(settings.n_features, *lv)
        # the JAX package sizes its stores the same way
        j = JSystem(mono_settings(), JSensor.MONOCULAR)
        assert j.store.n_feat == mono.store.n_feat


def test_precompile_warms_the_init_programs():
    """A mono System's precompile runs the init matcher and initializer at
    the init frames' shapes and the keyframe BoW descent at store width,
    and skips the chained step (mono never dispatches it)."""
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200)
    voc = Vocabulary.train(
        np.random.default_rng(0).integers(
            0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32),
        k=4, L=2)
    system = System(s, Sensor.MONOCULAR, vocabulary=voc, device="cpu")
    done = system.precompile(stages=["track", "modular", "mapping"])
    assert {"track/fast_step", "modular/mono_init",
            "mapping/kf_bow_descend"} <= set(done)
    assert "track/chain_step" not in done


def test_modular_frames_hold_the_map_against_other_threads():
    """A frame on the modular path (here a mono init attempt) holds the
    device capture lock and store.lock, as the reference holds
    mMutexMapUpdate across Track(): another thread (the mapper, the loop
    closer, a global BA) can take neither until the frame is done."""
    settings = convert.settings_from_jax(mono_settings())
    system = System(settings, Sensor.MONOCULAR, device="cpu")
    tracker = system.tracker
    init = tracker._monocular_initialization
    seen = []

    def probe():
        got = []

        def other():
            for lock in (DEVICE_CAPTURE_LOCK, system.store.lock):
                ok = lock.acquire(blocking=False)
                got.append(ok)
                if ok:
                    lock.release()

        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        assert not t.is_alive()
        seen.append(got)
        init()

    tracker._monocular_initialization = probe
    _, imgs = mono_frames(1)
    system.track_monocular(imgs[0], 0.0)
    assert seen == [[False, False]]
    assert tracker._init_frame is not None
    for lock in (DEVICE_CAPTURE_LOCK, system.store.lock):
        assert lock.acquire(blocking=False)
        lock.release()


def test_initialization_matches_jax(port_run):
    """Both Systems initialize on the same frame, with keyframe 1's
    normalised pose within 1e-3 and the map's size within 2%."""
    _, _, _, per_frame, init = port_run
    assert init is not None
    _, imgs = mono_frames(init["frame"] + 1)
    jsys = JSystem(mono_settings(), JSensor.MONOCULAR)
    want, jinit = run(jsys, imgs)
    assert jinit is not None and jinit["frame"] == init["frame"]
    np.testing.assert_allclose(init["kf_pose"], jinit["kf_pose"],
                               atol=POSE_ATOL, rtol=0)
    assert abs(init["points"] - jinit["points"]) <= \
        COUNT_RTOL * jinit["points"]
    assert per_frame[init["frame"]][1] == want[-1][1] == 2


@pytest.mark.slow
def test_tracked_frames_match_jax(port_run):
    """12 frames through both Systems: the same keyframe count on every
    frame, point counts within 2%, camera centres within 0.02 (the map's
    median depth is 1)."""
    _, _, _, per_frame, _ = port_run
    _, imgs = mono_frames(N_PARITY)
    want, _ = run(JSystem(mono_settings(), JSensor.MONOCULAR), imgs)
    n_tracked = 0
    for (T, n_kf, n_pt), (Tj, n_kfj, n_ptj) in zip(per_frame, want):
        assert n_kf == n_kfj
        assert abs(n_pt - n_ptj) <= COUNT_RTOL * n_ptj
        assert (T is None) == (Tj is None)
        if T is not None:
            n_tracked += 1
            assert np.linalg.norm(center_of(T) - center_of(Tj)) < CENTRE_ATOL
    assert n_tracked >= 10


def test_mono_end_to_end(port_run):
    """tests/test_system_e2e.py::TestMonocular's gates on the port."""
    system, _, poses, per_frame, _ = port_run
    est = [T for T, _, _ in per_frame]
    assert system.tracker.state.name == "OK"
    assert int(system.map.kf_valid.sum()) >= 2
    assert int(system.map.pt_valid.sum()) > 50
    assert sum(T is not None for T in est) >= len(poses) // 2
    assert system.stats()["resets"] == 0

    # scale-aligned trajectory accuracy (mono scale is arbitrary: align
    # with the ratio of median displacements)
    T0 = next(i for i, T in enumerate(est) if T is not None)
    gt = np.array([center_of(poses[i] @ np.linalg.inv(poses[T0]))
                   for i, T in enumerate(est) if T is not None])
    ee = np.array([center_of(T) for T in est if T is not None])
    num = np.linalg.norm(gt, axis=1)
    den = np.linalg.norm(ee, axis=1)
    s = np.median(num[den > 1e-6] / den[den > 1e-6])
    errs = np.linalg.norm(gt - s * ee, axis=1)
    assert errs.max() < 0.3, f"scaled ATE max {errs.max():.3f} m"
    assert np.median(errs) < 0.1, f"scaled ATE median {np.median(errs):.3f} m"


def test_grid_mapper_follows_the_mono_run(port_run, tmp_path):
    """The live grid attached before the first frame holds free and
    occupied cells; System.save_grid_map_tum writes the 450x300 file."""
    system, grid, _, _, _ = port_run
    occ = grid.occupancy()
    assert (occ == 255).sum() > 0 and (occ == 0).sum() > 0
    path = tmp_path / "grid.pgm"
    system.save_grid_map_tum(str(path))
    lines = path.read_text().splitlines()
    assert lines[:3] == ["P2", "450 300", "255"] and len(lines) == 303
