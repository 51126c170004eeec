"""The port's pipelines on the CPU: tests/test_pipeline.py's
TestStereoPipeline, TestRGBDPipeline, TestLocalizationMode and
TestPipelinedMode on the port's System; the drift gate's pinned cases
(TestDriftGate, TestGateParamsDerivation) on the port's copy of it, each
case also equal to the JAX package's answer; and what the pipelined /
async slice adds: the device map mirror against the JAX package's, the
pipelined System against the JAX pipelined System, the innovation gate's
salvage and keyframe veto, the async scheduler, `poll` and `precompile`.

Tolerances: `DeviceMap.flush` exactly equal to JAX's; with
`pipeline_depth = 0` (every frame drained right after its dispatch, in
both packages) keyframes on the same frames and every trajectory entry
within 1e-3 m (measured 2.4e-5 m); at the default depth the JAX test's
own bound against the sequential run."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from orb_slam2_tpu.config import Sensor as JSensor
from orb_slam2_tpu.config import Settings as JSettings
from orb_slam2_tpu.slam import device_map as jdevice_map
from orb_slam2_tpu.slam import tracking as jtracking
from orb_slam2_tpu.slam.map_store import MapStore as JMapStore
from orb_slam2_tpu.system import System as JSystem
from orb_slam2_tpu_torch import convert
from orb_slam2_tpu_torch.config import Sensor, Settings
from orb_slam2_tpu_torch.places.vocabulary import Vocabulary
from orb_slam2_tpu_torch.slam import device_map, tracking
from orb_slam2_tpu_torch.slam.map_store import MapStore
from orb_slam2_tpu_torch.system import System
from synthetic import PlaneScene, stereo_sequence, straight_trajectory
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
    # monocular no longer waits for an item: it builds, at the 2x store
    # width of its init frames; the viewer still waits for item 8
    from orb_slam2_tpu_torch.ops.frontend import padded_total

    mono = System(s, Sensor.MONOCULAR, device="cpu")
    assert mono.store.n_feat == padded_total(400, 8, 1.2) == 512
    assert mono.tracker._init_frame is None
    with pytest.raises(NotImplementedError, match="item 8"):
        System(s, Sensor.MONOCULAR, use_viewer=True, device="cpu")
    # place recognition no longer waits for an item: a vocabulary brings
    # the database, the relocalizer and the loop closer, global BA
    # launches (and finds nothing to do on an empty map), and the loop
    # stage has no program to warm without a vocabulary
    voc = Vocabulary.train(
        np.random.default_rng(0).integers(
            0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32),
        k=4, L=2)
    sys_ = System(s, Sensor.STEREO, vocabulary=voc, device="cpu")
    assert sys_.loop_closer is not None and sys_.kf_database is not None
    assert sys_.tracker.relocalizer is not None
    assert sys_.local_mapper.loop_closer is sys_.loop_closer
    assert sys_.loop_closer.local_mapper is sys_.local_mapper
    assert sys_.kf_database.erase in sys_.store.erase_hooks
    assert sys_.loop_closer.idle()
    sys_ = System(s, Sensor.STEREO, device="cpu")
    assert sys_.loop_closer is None and sys_.tracker.relocalizer is None
    assert sys_.local_mapper.global_bundle_adjustment() is False
    assert sys_.precompile(stages=["loop"]) == {}
    with pytest.raises(ValueError, match="stage"):
        sys_.precompile(stages=["loops"])
    with pytest.raises(ValueError, match="scheduler"):
        System(s, Sensor.STEREO, scheduler="threads", device="cpu")
    # the pipelined path and the async scheduler no longer wait for an item
    s.pipelined = True
    for sensor in (Sensor.STEREO, Sensor.RGBD):
        sys_ = System(s, sensor, scheduler="async", device="cpu")
        assert sys_.tracker.pipelined and len(sys_._workers) == 1
        assert sys_.poll() == 0
        sys_.shutdown()
        assert not sys_._workers[0].is_alive()
    # with a vocabulary the loop closer gets the second worker thread
    sys_ = System(s, Sensor.STEREO, vocabulary=voc, scheduler="async",
                  device="cpu")
    assert len(sys_._workers) == 2 and sys_.loop_closer.background_gba
    sys_.shutdown()
    assert not any(w.is_alive() for w in sys_._workers)


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


# ---------------------------------------------------------------------------
# tests/test_pipeline.py's RGB-D, localization and pipelined cases
# ---------------------------------------------------------------------------

def port_settings(**kw):
    return convert.settings_from_jax(make_settings(**kw))


def applied_poses(sys_, period=0.1) -> dict:
    """{frame: Tcw} of the trajectory entries, recomposed as
    SaveTrajectoryTUM does (with pipelining several frames may be applied
    inside one call, so sampling last_frame per call would miss frames)."""
    store = sys_.store
    out = {}
    for e in sys_.tracker.trajectory:
        if e.lost or not store.kf_valid[e.ref_kf]:
            continue
        out[round(e.timestamp / period)] = e.Tcr @ store.kf_pose[e.ref_kf]
    return out


class TestRGBDPipeline:
    def test_rgbd_tracks(self):
        settings = port_settings()
        poses = straight_trajectory(6, step=0.03, yaw_step=0.002)
        scene = PlaneScene(settings.K, H, W)
        sys_ = System(settings, Sensor.RGBD, device="cpu")
        est = [sys_.track_rgbd(scene.render(T), scene.depth_at(T), i * 0.1)
               for i, T in enumerate(poses)]
        assert est[-1] is not None
        err = np.linalg.norm(center_of(est[-1]) - center_of(poses[-1]))
        assert err < 0.06
        # RGB-D steady frames ride the fused fast step
        assert sys_.tracker.timers.counts.get("fast_step", 0) >= 2

    def test_rgbd_pipelined_tracks(self):
        """RGB-D rides the pipelined chain step too: the depth image flows
        through the chained step's img_r slot."""
        settings = port_settings()
        settings.pipelined = True
        poses = straight_trajectory(10, step=0.03, yaw_step=0.002)
        scene = PlaneScene(settings.K, H, W)
        sys_ = System(settings, Sensor.RGBD, device="cpu")
        for i, T in enumerate(poses):
            sys_.track_rgbd(scene.render(T), scene.depth_at(T), i * 0.1)
        # drain in-flight chain results for the authoritative poses
        t0 = time.time()
        while sys_.tracker._pending and time.time() - t0 < 30:
            sys_.poll()
            time.sleep(0.01)
        assert not sys_.tracker._pending
        assert sys_.tracker.state.name == "OK"
        assert sys_.tracker.timers.counts.get("pipelined_step", 0) >= 2
        Te = sys_.tracker.last_frame.Tcw
        err = np.linalg.norm(center_of(Te) - center_of(poses[-1]))
        assert err < 0.08, err

    def test_rgbd_fast_path_matches_modular(self):
        """The fused RGB-D step (depth sampled in the step) must land on
        the same trajectory as the modular path within tracking noise."""
        settings = port_settings()
        poses = straight_trajectory(8, step=0.03, yaw_step=0.002)
        scene = PlaneScene(settings.K, H, W)

        def run(fast):
            sys_ = System(settings, Sensor.RGBD, device="cpu")
            sys_.tracker.use_fast_path = fast
            return [sys_.track_rgbd(scene.render(T), scene.depth_at(T),
                                    i * 0.1) for i, T in enumerate(poses)]

        for Tf, Ts in zip(run(True)[2:], run(False)[2:]):
            assert Tf is not None and Ts is not None
            d = np.linalg.norm(center_of(Tf) - center_of(Ts))
            assert d < 0.02, d


class TestLocalizationMode:
    def test_localization_tracks_without_new_keyframes(self):
        """ref: System::ActivateLocalizationMode (src/System.cc:126-135) +
        Tracking's mbOnlyTracking branch: map frozen, tracking continues,
        no keyframes added."""
        settings = port_settings()
        poses = straight_trajectory(14, step=0.03, yaw_step=0.002)
        scene, pairs = stereo_sequence(settings.K, H, W, BASELINE, poses)
        sys_ = System(settings, Sensor.STEREO, device="cpu")
        for i, (l, r) in enumerate(pairs[:9]):
            sys_.track_stereo(l, r, i * 0.1)
        n_kf = int(sys_.map.kf_valid.sum())
        sys_.activate_localization_mode()
        est = []
        for i, (l, r) in enumerate(pairs[9:], start=9):
            est.append((i, sys_.track_stereo(l, r, i * 0.1)))
        assert int(sys_.map.kf_valid.sum()) == n_kf       # map frozen
        assert sys_.tracking_state().name == "OK"
        # localization mode rides the fused fast step too
        assert sys_.tracker.timers.counts.get("fast_step", 0) >= 2
        T0 = poses[0]
        for i, T in est:
            assert T is not None
            Tg = poses[i] @ np.linalg.inv(T0)
            assert np.linalg.norm(center_of(T) - center_of(Tg)) < 0.1
        sys_.deactivate_localization_mode()
        for i, (l, r) in enumerate(pairs[9:], start=9):
            sys_.track_stereo(l, r, (5 + i) * 0.1)
        assert not sys_.tracker.only_tracking


@pytest.fixture(scope="module")
def moderate_pairs():
    poses = straight_trajectory(14, step=0.03, yaw_step=0.002)
    _, pairs = stereo_sequence(make_settings().K, H, W, BASELINE, poses)
    return poses, pairs


class TestPipelinedMode:
    def test_pipelined_tracks_close_to_sequential(self, moderate_pairs):
        """Frame-pipelined (chained device state) tracking at the default
        depth must stay within a small factor of sequential accuracy on a
        moderate trajectory: the JAX test's own bound."""
        poses, pairs = moderate_pairs

        def run(pipelined):
            s = port_settings()
            s.pipelined = pipelined
            sys_ = System(s, Sensor.STEREO, device="cpu")
            for i, (l, r) in enumerate(pairs):
                sys_.track_stereo(l, r, i * 0.1)
            sys_.tracker._flush_pipeline()
            return sys_, applied_poses(sys_)

        _, seq = run(False)
        sys_p, pipe = run(True)
        T0 = poses[0]

        def err(T, i):
            Tg = poses[i] @ np.linalg.inv(T0)
            return np.linalg.norm(center_of(T) - center_of(Tg))

        e_seq = [err(T, i) for i, T in seq.items()]
        e_pipe = [err(T, i) for i, T in pipe.items()]
        assert len(e_pipe) >= len(pairs) - 2
        # pipelined max error bounded: no metre-scale divergence, and
        # within 3x + 1cm of the sequential worst case
        assert max(e_pipe) < max(max(e_seq) * 3.0 + 0.01, 0.05), (
            max(e_seq), max(e_pipe))
        st = sys_p.tracker.pipe_stats
        assert st["anchors"] >= 3 and st["blind"] >= 6
        assert sys_p.tracker._chain is None and not sys_p.tracker._pending
        assert sys_p.tracker._get_chain_step().ring.held() == 0


# ---------------------------------------------------------------------------
# the device map mirror against the JAX package's
# ---------------------------------------------------------------------------

def _filled_jax_store(n_pt, seed=5):
    rng = np.random.default_rng(seed)
    store = JMapStore(8, kf_cap=4, pt_cap=64)
    for _ in range(n_pt):
        store.add_point(rng.normal(0, 3, 3).astype(np.float32), 0,
                        rng.integers(0, 2 ** 32, 8).astype(np.uint32))
    n = store.n_pt
    store.pt_normal[:n] = rng.normal(0, 1, (n, 3))
    store.pt_min_dist[:n] = rng.uniform(0.1, 1, n)
    store.pt_max_dist[:n] = rng.uniform(5, 9, n)
    return store, rng


def _mirrors_equal(jdm, tdm):
    assert jdm.cap == tdm.cap
    np.testing.assert_array_equal(np.asarray(jdm.f32), tdm.f32.numpy())
    np.testing.assert_array_equal(np.asarray(jdm.desc),
                                  tdm.desc.numpy().view(np.uint32))


def test_device_map_flush_equals_jax_and_grows_past_cap():
    """The same dirty sets through both mirrors, exactly equal after
    every flush: the seed flush, a mutation, dead points, and growth past
    the capacity (which moves the port's buffers, counted)."""
    jstore, rng = _filled_jax_store(300)
    tstore = convert.map_store_from_jax(jstore)
    jdm = jdevice_map.DeviceMap(jstore, cap=256)
    tdm = device_map.DeviceMap(tstore, cap=256, device="cpu")
    addr = tdm.f32.data_ptr()
    for st in (jstore, tstore):
        st.mark_dirty(np.arange(200))
    jdm.flush(), tdm.flush()
    _mirrors_equal(jdm, tdm)
    assert tdm.f32.data_ptr() != addr and tdm.moves == 1   # 300 > 256
    assert tdm.cap == 512 and tdm.flushes == 1 and tdm.rows_flushed == 200
    assert float(tdm.f32[:200, 8].sum()) == 200 and not tdm.dirty

    # a BA-like move, two dead points, one new point
    addr = tdm.f32.data_ptr()
    moved = rng.choice(300, 40, replace=False)
    delta = rng.normal(0, 0.1, (40, 3)).astype(np.float32)
    new_desc = rng.integers(0, 2 ** 32, 8).astype(np.uint32)
    for st in (jstore, tstore):
        st.pt_pos[moved] += delta
        st.mark_dirty(moved)
        st.set_point_bad(7)
        st.set_point_bad(150)
        st.add_point(np.ones(3, np.float32), 0, new_desc)
    assert tdm.dirty == jdm.dirty and {7, 150, 300} <= tdm.dirty
    jdm.flush(), tdm.flush()
    _mirrors_equal(jdm, tdm)
    assert tdm.f32.data_ptr() == addr           # in place: the address holds
    assert float(tdm.f32[7, 8]) == 0.0 and float(tdm.f32[300, 8]) == 1.0
    # the dump row takes the padding and is not part of the mirror
    assert tdm.f32.shape == (512, 9) and tdm._f32.shape == (513, 9)

    # nothing dirty: a flush does nothing
    n = tdm.flushes
    tdm.flush()
    assert tdm.flushes == n


def test_device_map_pads_deltas_to_powers_of_two():
    assert [device_map.delta_rows(n) for n in (1, 2, 256, 257, 1000, 4097)] \
        == [256, 256, 256, 512, 1024, 8192]
    f32 = torch.zeros(9, 9)
    desc = torch.zeros(9, 8, dtype=torch.int32)
    device_map._apply_delta(
        f32, desc, torch.tensor([3, -1, 5, -1], dtype=torch.int32),
        torch.arange(36.0).reshape(4, 9),
        torch.arange(32, dtype=torch.int32).reshape(4, 8))
    assert torch.equal(f32[3], torch.arange(9.0))
    assert torch.equal(f32[5], torch.arange(18.0, 27.0))
    assert torch.equal(desc[5], torch.arange(16, 24, dtype=torch.int32))
    untouched = [0, 1, 2, 4, 6, 7]               # row 8 is the dump row
    assert float(f32[untouched].abs().sum()) == 0


# ---------------------------------------------------------------------------
# the pipelined System against the JAX pipelined System
# ---------------------------------------------------------------------------

def test_pipelined_system_matches_jax_at_depth_zero():
    """30 frames with five keyframes (tests/test_torch_system_parity.py's
    sequence), pipelined, every frame drained right after its dispatch in
    both packages: keyframes on the same frames, the same anchors, every
    trajectory entry within 1e-3 m."""
    from test_golden import BASELINE as GB, _settings
    from test_torch_golden import run

    js = _settings()
    js.pipelined, js.pipeline_depth = True, 0
    s = convert.settings_from_jax(js)
    s.pipelined, s.pipeline_depth = True, 0
    poses = straight_trajectory(30, step=0.05, yaw_step=0.02)
    _, pairs = stereo_sequence(js.K, H, W, GB, poses)
    port = System(s, Sensor.STEREO, device="cpu")
    kfs, _ = run(port, pairs)
    jsys = JSystem(js, JSensor.STEREO)
    jkfs, _ = run(jsys, pairs)
    port.tracker._flush_pipeline(), jsys.tracker._flush_pipeline()
    assert len(kfs) >= 4 and kfs == jkfs, (kfs, jkfs)
    a, b = applied_poses(port), applied_poses(jsys)
    assert sorted(a) == sorted(b) and len(a) >= 29
    dev = max(np.linalg.norm(center_of(a[i]) - center_of(b[i])) for i in a)
    assert dev < 1e-3, dev
    t = port.tracker
    assert t.timers.counts["pipelined_step"] == \
        jsys.tracker.timers.counts["pipelined_step"] >= 25
    assert t.pipe_stats["max_in_flight"] == 1
    assert t.pipe_stats["anchors"] >= 2 * len(kfs) - 2
    dm = t._device_map
    assert dm.flushes >= len(kfs) - 1 and dm.moves == 0
    # the mirror holds what the host map holds, for every point flushed
    pids = port.store.valid_pt_ids()
    dm.flush()
    np.testing.assert_array_equal(dm.f32[pids, :3].numpy(),
                                  port.store.pt_pos[pids])


# ---------------------------------------------------------------------------
# the innovation gate in _apply_fast_result: reject, salvage, keyframe veto
# ---------------------------------------------------------------------------

@pytest.fixture()
def pipelined_system(moderate_pairs):
    _, pairs = moderate_pairs
    s = port_settings()
    s.pipelined, s.pipeline_depth = True, 0
    sys_ = System(s, Sensor.STEREO, device="cpu")
    for i, (l, r) in enumerate(pairs[:6]):
        sys_.track_stereo(l, r, i * 0.1)
    return sys_, pairs


def _force_gate(tracker, monkeypatch, soft, reject):
    monkeypatch.setattr(tracking, "drift_gate",
                        lambda *a, **k: (soft, reject))


def test_drift_reject_retracks_through_the_modular_path(pipelined_system,
                                                         monkeypatch):
    """A rejected device pose is discarded: the frame is re-tracked
    against the reference keyframe, the chain is re-anchored next frame,
    and tracking stays OK."""
    sys_, pairs = pipelined_system
    t = sys_.tracker
    _force_gate(t, monkeypatch, True, True)
    n_ref = t.timers.counts["pipe/anchor"]
    sys_.track_stereo(*pairs[6], 0.6)
    assert t.state.name == "OK" and t._fallback_used
    assert t.pipe_stats["drift_reject"] == 1 and not t._drift_salvaged
    assert t._chain_dirty > 0
    monkeypatch.undo()
    sys_.track_stereo(*pairs[7], 0.7)
    assert t.timers.counts["pipe/anchor"] > n_ref       # it re-anchored
    assert t.state.name == "OK" and not t._fallback_used
    assert not t._drift_reject


def test_salvage_keeps_the_device_pose_and_vetoes_the_keyframe(
        pipelined_system, monkeypatch):
    """The gate fired and the modular re-track failed too: within four
    matching windows the device pose is kept (no LOST, no reset), counted
    in the statistics, and the frame may not become a keyframe; beyond
    four windows the frame is LOST."""
    sys_, pairs = pipelined_system
    t = sys_.tracker
    _force_gate(t, monkeypatch, True, True)
    monkeypatch.setattr(t, "_track_reference_keyframe", lambda: False)
    monkeypatch.setattr(t, "_need_new_keyframe", lambda: True)
    n_kf = sys_.store.n_kf
    found = sys_.store.pt_found.copy()
    sys_.track_stereo(*pairs[6], 0.6)
    assert t._innov_px < 4.0 * t._th_mm_gate
    assert t.state.name == "OK" and t.resets == 0
    assert t._drift_salvaged and t.pipe_stats["salvaged"] == 1
    assert sys_.store.n_kf == n_kf                       # the veto
    assert (sys_.store.pt_found - found).sum() >= 30     # counted as found
    assert t.n_inliers >= 30

    # an unsalvaged frame that wants a keyframe gets one
    _force_gate(t, monkeypatch, False, False)
    sys_.track_stereo(*pairs[7], 0.7)
    assert not t._drift_salvaged and sys_.store.n_kf == n_kf + 1

    # beyond four windows the device pose is not trusted either
    _force_gate(t, monkeypatch, True, True)
    monkeypatch.setattr(tracking, "innovation_px", lambda *a: 1e3)
    sys_.track_stereo(*pairs[8], 0.8)
    # LOST with five keyframes or fewer is a reset (ref: Tracking.cc:431)
    assert t.resets == 1 and t.state.name == "NO_IMAGES_YET"
    assert not t._pending and t._chain is None
    assert t.pipe_stats["salvaged"] == 0             # a fresh tracker


def test_fast_path_clears_the_gate_flags(pipelined_system):
    """The synchronous fast path re-anchors every frame: stale pipelined
    verdicts must not leak into it."""
    sys_, pairs = pipelined_system
    t = sys_.tracker
    t._flush_pipeline()
    t.pipelined = False
    t._drift_soft = t._drift_reject = t._drift_salvaged = True
    sys_.track_stereo(*pairs[6], 0.6)
    assert t.state.name == "OK"
    assert not (t._drift_soft or t._drift_reject or t._drift_salvaged)
    assert not t._fallback_used


# ---------------------------------------------------------------------------
# poll, a modular frame behind a pipeline, precompile
# ---------------------------------------------------------------------------

def test_poll_and_flush_before_a_modular_frame(moderate_pairs):
    """`poll` drains what is ready without a new frame and reports how
    many; a frame that leaves the fast path flushes the pipeline first."""
    _, pairs = moderate_pairs
    s = port_settings()
    s.pipelined, s.pipeline_depth = True, 8

    class Late:
        """A result the device has not delivered yet."""
        def __init__(self, pending):
            self.pending, self.ready = pending, False
            self.desc = pending.desc

        def is_ready(self):
            return self.ready

        def wait(self):
            return self.pending.wait()

        def release(self):
            self.pending.release()

    sys_ = System(s, Sensor.STEREO, device="cpu")
    t = sys_.tracker
    for i, (l, r) in enumerate(pairs[:4]):
        sys_.track_stereo(l, r, i * 0.1)
    assert not t._pending
    runner = t._get_chain_step()
    dispatch = runner.dispatch
    late = []

    def late_dispatch(*a):
        late.append(Late(dispatch(*a)))
        return late[-1]

    runner.dispatch = late_dispatch
    n = len(t.trajectory)
    T4 = sys_.track_stereo(*pairs[4], 0.4)
    T5 = sys_.track_stereo(*pairs[5], 0.5)
    assert len(t._pending) == 2 and len(t.trajectory) == n
    assert t.pipe_stats["max_in_flight"] == 2
    # the caller gets the motion-model prediction over the lag meanwhile
    assert T4 is not None and T5 is not None
    np.testing.assert_allclose(
        T5, np.linalg.matrix_power(t.velocity, 2) @ t.last_frame.Tcw,
        atol=1e-6)
    assert sys_.poll() == 0
    late[0].ready = True
    assert sys_.poll() == 1 and len(t._pending) == 1
    assert len(t.trajectory) == n + 1
    # a modular frame (here: the fast path switched off) flushes first
    t.use_fast_path = False
    sys_.track_stereo(*pairs[6], 0.6)
    assert not t._pending and t._chain is None
    assert len(t.trajectory) == n + 3
    assert [round(e.timestamp, 1) for e in t.trajectory[-3:]] == \
        [0.4, 0.5, 0.6]
    assert t.timers.counts["pipe/dispatch_to_pose"] >= 2


@pytest.mark.parametrize("sensor", ["STEREO", "RGBD"])
def test_precompile_runs_every_program_and_leaves_the_system_fresh(sensor):
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200, n_levels=4)
    sys_ = System(s, Sensor[sensor], device="cpu")
    out = sys_.precompile()
    assert set(out) == {
        "frontend/frames", "track/fast_step", "track/chain_step",
        "track/mirror_deltas", "modular/optimize_pose",
        "modular/project+search_local", "modular/search_last_frame",
        "mapping/triangulate_gather", "mapping/fuse_points_gather",
        "mapping/fuse_points", "mapping/local_ba_chain",
        "gba/global_ba"}
    assert all(isinstance(v, float) and v >= 0 for v in out.values())
    assert sys_.builder._next_id == 0 and sys_.store.n_pt == 0
    t = sys_.tracker
    assert t._chain is None and not t._pending and t.state.name == \
        "NO_IMAGES_YET"
    assert float(t._device_map.f32.abs().sum()) == 0    # dump row only
    assert set(sys_.precompile(stages=["modular"])) == {
        "modular/optimize_pose", "modular/project+search_local",
        "modular/search_last_frame"}
    s2 = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                  height=96, n_features=200, n_levels=4, mirror_kf_cap=0)
    out2 = System(s2, Sensor[sensor], device="cpu").precompile(
        stages=["mapping"])
    assert {"mapping/triangulate_batch", "mapping/fuse_points_batch"} \
        <= set(out2)


# ---------------------------------------------------------------------------
# the async scheduler
# ---------------------------------------------------------------------------

def _check_store_invariants(store):
    with store.lock:
        kfs = store.valid_kf_ids()
        assert np.isfinite(store.kf_pose[kfs]).all()
        rows = store.kf_obs[kfs]
        assert (rows[rows >= 0] < store.n_pt).all()
        pids = store.valid_pt_ids()
        assert np.isfinite(store.pt_pos[pids]).all()
        idx, okfs, ofeats = store.obs.dump(pids)
        assert (store.kf_obs[okfs, ofeats] == pids[idx]).all()


def _truth_errors(sys_, poses) -> list:
    T0 = poses[0]
    return [float(np.linalg.norm(
        center_of(T) - center_of(poses[i] @ np.linalg.inv(T0))))
        for i, T in sorted(applied_poses(sys_).items())]


@pytest.fixture(scope="module")
def mapping_sequence():
    """The 30-frame sequence of the parity test (five keyframes under the
    sync scheduler) and the sync run's errors against the truth."""
    from test_golden import BASELINE as GB, _settings

    s = convert.settings_from_jax(_settings())
    poses = straight_trajectory(30, step=0.05, yaw_step=0.02)
    _, pairs = stereo_sequence(s.K, H, W, GB, poses)
    sys_ = System(s, Sensor.STEREO, device="cpu")
    for i, (l, r) in enumerate(pairs):
        sys_.track_stereo(l, r, i * 0.1)
    return poses, pairs, _truth_errors(sys_, poses)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["fast", "pipelined"])
def test_async_scheduler_maps_beside_tracking(pipelined, mapping_sequence):
    """One mapping worker and no vocabulary: the mapper runs while frames
    are tracked, quiesces, keeps the store's invariants, and is joined by
    shutdown; no frame is lost and the trajectory stays within the
    pipelined test's bound (3x + 1 cm) of the sync scheduler's."""
    from test_golden import _settings

    poses, pairs, e_sync = mapping_sequence
    s = convert.settings_from_jax(_settings())
    s.pipelined = pipelined
    sys_ = System(s, Sensor.STEREO, scheduler="async", device="cpu")
    assert len(sys_._workers) == 1 and sys_._workers[0].is_alive()
    assert sys_.local_mapper.async_worker
    overlap = 0
    for i, (l, r) in enumerate(pairs):
        sys_.track_stereo(l, r, i * 0.1)
        if not sys_.local_mapper.idle():
            overlap += 1
        sys_.poll()
    sys_.tracker._flush_pipeline()
    sys_._pump()
    t0 = time.time()
    while not sys_.local_mapper.idle():
        assert time.time() - t0 < 60, "the mapper never quiesced"
        time.sleep(0.02)
    assert overlap > 0, "the mapper only ran while tracking slept"
    # the tracking thread did no mapping work
    assert sys_.tracker.timers.counts["pipe/mapper_spin"] == 0
    assert sys_.local_mapper.timers.counts["lm/process_new_kf"] >= 3
    assert sys_.tracker.state.name == "OK" and sys_.tracker.resets == 0
    _check_store_invariants(sys_.map)
    assert int(sys_.map.kf_valid.sum()) >= 3
    errs = _truth_errors(sys_, poses)
    assert len(errs) >= 28
    assert max(errs) < max(max(e_sync) * 3.0 + 0.01, 0.05), (
        max(e_sync), max(errs))
    sys_.shutdown()
    for w in sys_._workers:
        assert not w.is_alive()


def test_a_failed_mapping_thread_is_reported_to_the_caller():
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200, n_levels=4)
    sys_ = System(s, Sensor.STEREO, scheduler="async", device="cpu")

    def boom():
        raise ValueError("mapper broke")

    sys_.local_mapper.process_one = boom
    hook, threading.excepthook = threading.excepthook, lambda args: None
    try:
        sys_.local_mapper.queue.append(0)
        sys_._pump()
        sys_._workers[0].join(timeout=10)
    finally:
        threading.excepthook = hook
    assert not sys_._workers[0].is_alive()
    with pytest.raises(RuntimeError, match="mapping thread failed"):
        sys_._pump()
    with pytest.raises(RuntimeError, match="mapping thread failed"):
        sys_.shutdown()


def test_a_failed_loop_closing_thread_is_reported_to_the_caller():
    s = Settings(fx=100.0, fy=100.0, cx=64, cy=48, bf=50.0, width=128,
                 height=96, n_features=200, n_levels=4)
    voc = Vocabulary.train(
        np.random.default_rng(0).integers(
            0, 2 ** 32, (300, 8), dtype=np.uint64).astype(np.uint32),
        k=4, L=2)
    sys_ = System(s, Sensor.STEREO, vocabulary=voc, scheduler="async",
                  device="cpu")

    def boom():
        raise ValueError("closer broke")

    sys_.loop_closer.process_one = boom
    hook, threading.excepthook = threading.excepthook, lambda args: None
    try:
        sys_.loop_closer.queue.append(0)
        sys_._pump()          # wakes the mapper, which wakes the closer
        sys_._workers[1].join(timeout=10)
    finally:
        threading.excepthook = hook
    assert not sys_._workers[1].is_alive()
    with pytest.raises(RuntimeError, match="loop-closing thread failed"):
        sys_._pump()
    with pytest.raises(RuntimeError, match="loop-closing thread failed"):
        sys_.shutdown()
    assert not sys_._workers[0].is_alive()
