"""The port's stereo pipeline: tests/test_pipeline.py's TestStereoPipeline
on the port's System (CPU), and the drift gate's pinned cases
(TestDriftGate, TestGateParamsDerivation) on the port's copy of it, each
case also equal to the JAX package's answer."""

import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.slam import tracking as jtracking
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.slam import tracking
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.system import System
from synthetic import stereo_sequence, straight_trajectory
from test_pipeline import BASELINE, H, W, center_of, make_settings

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def stereo_run():
    settings = convert.settings_from_jax(make_settings())
    poses = straight_trajectory(10, step=0.03, yaw_step=0.002)
    scene, pairs = stereo_sequence(settings.K, H, W, BASELINE, poses)
    sys_ = System(settings, Sensor.STEREO, device="cpu")
    est = []
    for i, (l, r) in enumerate(pairs):
        T = sys_.track_stereo(l, r, i * 0.1)
        est.append(None if T is None else T.copy())
    return sys_, poses, est


class TestStereoPipeline:
    def test_initializes_first_frame(self, stereo_run):
        sys_, poses, est = stereo_run
        assert est[0] is not None
        assert int(sys_.map.kf_valid.sum()) >= 1
        assert int(sys_.map.pt_valid.sum()) > 300

    def test_tracks_all_frames(self, stereo_run):
        sys_, poses, est = stereo_run
        assert all(T is not None for T in est)
        assert sys_.tracking_state().name == "OK"

    def test_trajectory_accuracy(self, stereo_run):
        sys_, poses, est = stereo_run
        errs = [
            np.linalg.norm(center_of(T) - center_of(G))
            for T, G in zip(est, poses) if T is not None
        ]
        assert max(errs) < 0.06, f"max position error {max(errs):.3f} m"

    def test_trajectory_writers(self, stereo_run, tmp_path):
        sys_, _, _ = stereo_run
        tum = tmp_path / "traj_tum.txt"
        kitti = tmp_path / "traj_kitti.txt"
        kf = tmp_path / "kf_tum.txt"
        sys_.save_trajectory_tum(str(tum))
        sys_.save_trajectory_kitti(str(kitti))
        sys_.save_keyframe_trajectory_tum(str(kf))
        rows = np.loadtxt(tum)
        assert rows.shape[1] == 8
        rows_k = np.loadtxt(kitti)
        assert rows_k.shape[1] == 12
        # first pose ~ identity (world = first camera)
        np.testing.assert_allclose(
            rows_k[0].reshape(3, 4)[:, :3], np.eye(3), atol=1e-3
        )

    def test_map_save_load_roundtrip(self, stereo_run, tmp_path):
        sys_, _, _ = stereo_run
        path = tmp_path / "map.bin"
        sys_.map.save(str(path))
        m2 = MapStore.load(str(path), device="cpu")
        assert m2.n_kf == sys_.map.n_kf
        assert m2.n_pt == sys_.map.n_pt
        np.testing.assert_array_equal(
            m2.pt_pos[: m2.n_pt], sys_.map.pt_pos[: sys_.map.n_pt]
        )
        np.testing.assert_array_equal(m2.kf_obs, sys_.map.kf_obs)

    def test_map_point_export(self, stereo_run, tmp_path):
        sys_, _, _ = stereo_run
        p = tmp_path / "pts.obj"
        sys_.save_map_points_obj(str(p))
        lines = open(p).read().strip().splitlines()
        assert len(lines) == int(sys_.map.pt_valid.sum())
        assert all(ln.startswith("v ") for ln in lines)


def test_cuda_device_raises_without_a_card():
    """Nothing that asks for the card carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200)
    with pytest.raises(RuntimeError, match="cuda"):
        System(s, Sensor.STEREO, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        MapStore(8, device="cuda")


def test_unported_modes_raise_naming_their_item():
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200)
    with pytest.raises(NotImplementedError, match="item 7"):
        System(s, Sensor.MONOCULAR, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        System(s, Sensor.STEREO, scheduler="async", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        System(s, Sensor.STEREO, vocabulary=object(), device="cpu")
    sys_ = System(s, Sensor.STEREO, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        sys_.local_mapper.global_bundle_adjustment()


# ---------------------------------------------------------------------------
# the drift gate: TestDriftGate's pinned cases, (args, kwargs, soft, reject)
# with None where the JAX test does not pin the value
# ---------------------------------------------------------------------------
TH = 7.0
GATE_CASES = {
    "healthy_post_anchor_jitter": ((12.7, TH, 400.0, 498.0), {}, True, False),
    "small_innovation": ((2.5, TH, 800.0, 900.0), {}, False, False),
    "true_divergence": ((46.9, TH, 40.0, 240.0), {}, True, True),
    "huge_innovation": ((155.7, TH, 96.0, 133.0), {}, True, True),
    "strong_drift_correction": ((90.1, TH, 145.0, 203.0),
                                {"drot_deg": 5.2}, True, False),
    "implausible_both_caps": ((631.5, TH, 112.0, 175.0),
                              {"drot_deg": 24.2}, None, True),
    "implausible_innovation_cap": ((631.5, TH, 112.0, 175.0),
                                   {"drot_deg": 0.0}, None, True),
    "implausible_rotation_cap": ((60.0, TH, 150.0, 500.0),
                                 {"drot_deg": 24.2}, None, True),
    "map_moved_keeps_plausible": ((96.3, TH, 132.0, 737.0),
                                  {"drot_deg": 2.89, "map_moved": True},
                                  True, False),
    "map_unmoved_rejects": ((96.3, TH, 132.0, 737.0),
                            {"drot_deg": 2.89, "map_moved": False},
                            None, True),
    "map_moved_implausible": ((631.5, TH, 112.0, 175.0),
                              {"drot_deg": 24.2, "map_moved": True},
                              None, True),
    "map_moved_low_support": ((96.3, TH, 40.0, 737.0),
                              {"drot_deg": 2.89, "map_moved": True},
                              None, True),
    "map_moved_never_tightens": ((2.0, TH, 40.0, 100.0),
                                 {"map_moved": True}, None, False),
    "moderate_with_support": ((35.0, TH, 300.0, 500.0), {}, True, False),
    "loop_jump_decisive_moved": ((305.5, TH, 636.0, 700.0),
                                 {"map_moved": True}, True, False),
    "decisive_unmoved": ((154.7, TH, 574.0, 900.0),
                         {"map_moved": False}, True, False),
    "sub_decisive_rejects": ((305.5, TH, 150.0, 700.0),
                             {"map_moved": False}, None, True),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_drift_gate_pinned_cases(case):
    args, kw, soft, reject = GATE_CASES[case]
    got = tracking.drift_gate(*args, **kw)
    assert got == jtracking.drift_gate(*args, **kw)
    if soft is not None:
        assert got[0] == soft
    assert got[1] == reject


def test_innovation_px_formula():
    v = tracking.innovation_px(718.0, 0.043, 0.5, 6.0)
    assert abs(v - (718.0 * (0.043 / 6.0 + np.radians(0.5)))) < 1e-6
    v0 = tracking.innovation_px(718.0, 1.0, 1.0, 0.0)
    assert abs(v0 - 718.0 * np.radians(1.0)) < 1e-6
    assert v == jtracking.innovation_px(718.0, 0.043, 0.5, 6.0)


class TestGateParamsDerivation:
    def test_bench_regime_reproduces_round4_constants(self):
        kw = dict(fx=718.856, fy=718.856, cx=607.19, cy=185.22,
                  bf=386.1448, width=1240, height=376, n_features=2000,
                  fps=10.0)
        p = tracking.GateParams.from_settings(Settings(**kw),
                                              chain_max_age=4)
        assert p.nonstrong_w == 8.0
        assert p.implausible_w == 20.0
        assert abs(p.rot_cap_deg - 14.9) < 0.1
        assert p.weak_floor == 30.0
        assert p.strong_floor == 100.0
        assert p.moved_floor == 50.0
        jp = jtracking.GateParams.from_settings(JSettings(**kw),
                                                chain_max_age=4)
        assert vars(p) == vars(jp)

    def test_randomized_regimes_no_misclassification(self):
        """20 seeded regimes, as the JAX test: honest corrections never
        reject, divergences always reject, and every answer equals the
        JAX package's."""
        class S:       # minimal settings stand-in
            def __init__(self, nf, fps):
                self.n_features = nf
                self.fps = fps

        rng = np.random.default_rng(7)
        for trial in range(20):
            nf = int(rng.integers(600, 4000))
            fps = float(rng.choice([5.0, 10.0, 20.0, 30.0]))
            age = int(rng.choice([2, 4, 6]))
            th = float(rng.choice([7.0, 15.0]))
            p = tracking.GateParams.from_settings(S(nf, fps),
                                                  chain_max_age=age)
            jp = jtracking.GateParams.from_settings(S(nf, fps),
                                                    chain_max_age=age)

            def gate(innov, inl, n_vis, drot=0.0):
                r = tracking.drift_gate(innov, th, inl, n_vis,
                                        drot_deg=drot, params=p)
                assert r == jtracking.drift_gate(innov, th, inl, n_vis,
                                                 drot_deg=drot, params=jp)
                return r[1]

            for _ in range(50):
                n_vis = float(rng.integers(max(60, nf // 10), nf))
                innov = float(rng.uniform(0, p.nonstrong_w * th))
                inl = float(max(p.strong_floor, p.strong_frac * n_vis) + 1)
                drot = float(np.degrees(rng.uniform(0, 0.6) * age / fps))
                assert not gate(innov, inl, n_vis, drot)

                innov = float(rng.uniform(0, p.weak_w * th))
                inl = float(max(p.weak_floor, p.weak_frac * n_vis) + 1)
                assert not gate(innov, inl, n_vis)

                innov = float(rng.uniform(p.implausible_w * th * 1.01,
                                          p.implausible_w * th * 30))
                inl = float(min(2.0 * p.strong_floor - 1,
                                p.weak_frac * n_vis))
                assert gate(innov, inl, n_vis)

                innov = float(rng.uniform(p.weak_w * th * 1.01,
                                          p.nonstrong_w * th))
                inl = float(rng.uniform(0, p.weak_floor - 1))
                assert gate(innov, inl, n_vis)

                drot = float(p.rot_cap_deg * rng.uniform(1.05, 3.0))
                inl = float(min(2.0 * p.strong_floor - 1,
                                p.weak_frac * n_vis))
                assert gate(1.0, inl, n_vis, drot)
